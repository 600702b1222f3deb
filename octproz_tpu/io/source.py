"""Acquisition sources: the producer side of the streaming runtime.

Capability-equivalent of the reference DevKit's ``AcquisitionSystem`` +
``AcquisitionBuffer`` (octproz_devkit/src/acquisitionsystem.h:58-73,
acquisitionbuffer.h:53-58) and of the Virtual OCT System plugin -- the
file-replay acquisition system that is the reference's de-facto test harness
(octproz_plugins/octproz-virtual-oct-system/src/virtualoctsystem.cpp:163-353).

Design differences:
* The reference hands out raw pointers into a spin-wait double buffer; here a
  source is an iterator of numpy buffers shaped (bscans, ascans, samples),
  and the runtime overlaps host IO with device compute via a prefetch queue
  + JAX async dispatch (the analog of the 8-stream pipelining,
  cuda_code.cu:42,1396).
* The reference supports three replay modes (cycle <=2 buffers from RAM, copy
  all to RAM, stream from disk for huge files, virtualoctsystem.cpp:163-353);
  VirtualOctSource supports the same three via ``copy_to_ram``.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional, Protocol, runtime_checkable

import numpy as np

from ..params import AcqParams


@runtime_checkable
class AcquisitionSource(Protocol):
    """Anything that yields raw buffers of shape acq.buffer_shape.

    The protocol analog of AcquisitionSystem::startAcquisition/stopAcquisition
    (acquisitionsystem.h:58-63).
    """

    acq: AcqParams

    def buffers(self) -> Iterator[np.ndarray]: ...


def _np_dtype(bit_depth: int):
    if bit_depth <= 8:
        return np.uint8
    if bit_depth <= 16:
        return np.uint16
    return np.uint32


class VirtualOctSource:
    """File-replay acquisition source (.raw volumes, unpacked little-endian
    8..32-bit samples -- same input constraint as the reference,
    docs/docs/faq.md:3-5).

    Parameters mirror the Virtual OCT System plugin's settings
    (virtualoctsystem.cpp:40-51): file path, geometry, bit depth,
    ``buffers_per_volume``, ``wait_time_us`` (artificial per-buffer delay to
    emulate a given A-scan rate), ``bscan_offset`` (skip initial B-scans),
    ``copy_to_ram`` (preload whole file vs stream from disk), and
    ``total_buffers_to_acquire`` (None = loop forever).
    """

    def __init__(
        self,
        path: str,
        acq: AcqParams,
        wait_time_us: int = 0,
        bscan_offset: int = 0,
        copy_to_ram: bool = True,
        total_buffers_to_acquire: Optional[int] = None,
        packed_12bit: bool = False,
        keep_packed: bool = False,
        big_endian: bool = False,
    ):
        #: keep_packed: yield the packed-12 WIRE bytes untouched (uint8,
        #: 1.5 bytes/sample) for an engine running wire_format="packed12" —
        #: the unpack then happens ON DEVICE after a 25 %-smaller upload
        #: (ops.convert.unpack_uint12_device)
        if keep_packed and not packed_12bit:
            raise ValueError("keep_packed requires packed_12bit=True")
        self.keep_packed = keep_packed
        self.path = path
        self.acq = acq
        self.wait_time_us = wait_time_us
        self.bscan_offset = bscan_offset
        self.copy_to_ram = copy_to_ram
        self.total = total_buffers_to_acquire
        self.packed_12bit = packed_12bit
        # byte-order swap for big-endian recordings (the reference ships
        # endian-swap device helpers, cuda_code.cu:150-163; here the swap is
        # host-side, before upload)
        self.big_endian = big_endian
        if big_endian and packed_12bit:
            raise ValueError("big_endian does not apply to 12-bit packed input")
        self._dtype = np.uint16 if packed_12bit else _np_dtype(acq.bit_depth)
        if packed_12bit:
            if acq.samples_per_buffer % 2:
                raise ValueError("packed 12-bit input needs an even sample count")
            self._buffer_bytes = acq.samples_per_buffer * 3 // 2
            line_samples = acq.ascans_per_bscan * acq.samples_per_line
            if (bscan_offset * line_samples) % 2:
                # an odd sample offset would land mid 3-byte pair and every
                # later sample would decode nibble-shifted
                raise ValueError(
                    "packed 12-bit bscan_offset must skip an even number of "
                    f"samples (offset {bscan_offset} x {line_samples} "
                    "samples/B-scan is odd)")
            self._offset_bytes = bscan_offset * line_samples * 3 // 2
        else:
            self._buffer_bytes = acq.bytes_per_buffer
            self._offset_bytes = (bscan_offset * acq.ascans_per_bscan
                                  * acq.samples_per_line * acq.bytes_per_sample)

        file_size = os.path.getsize(path)
        usable = file_size - self._offset_bytes
        if usable < self._buffer_bytes:
            raise ValueError(
                f"{path}: {file_size} bytes is smaller than one buffer "
                f"({self._buffer_bytes} bytes) after bscan_offset")
        self.buffers_in_file = usable // self._buffer_bytes

        self._ram: Optional[np.ndarray] = None
        if copy_to_ram:
            self._ram = np.stack([self._read_from_disk(i)
                                  for i in range(self.buffers_in_file)])
        else:
            # streaming mode: reusable aligned read buffer + native pread
            # (virtualoctsystem.cpp:226-291; native/octnative.cpp file_read_at)
            self._scratch = np.empty(self._buffer_bytes, np.uint8)

    def _read_from_disk(self, index: int) -> np.ndarray:
        from .. import native

        offset = self._offset_bytes + index * self._buffer_bytes
        raw = native.read_file_at(self.path, offset, self._buffer_bytes,
                                  getattr(self, "_scratch", None))
        if self.packed_12bit:
            if self.keep_packed:
                # wire bytes untouched; copy streaming-mode scratch reads
                return (raw.copy()
                        if raw is getattr(self, "_scratch", None) else raw)
            return native.unpack_uint12(
                raw, self.acq.samples_per_buffer).reshape(self.acq.buffer_shape)
        out = raw.view(self._dtype).reshape(self.acq.buffer_shape)
        if self.big_endian and self.acq.bit_depth > 8:
            return out.byteswap()  # always a fresh array
        # streaming mode reuses the scratch buffer; hand out a copy so the
        # next read cannot overwrite data still in flight downstream
        return out.copy() if raw is getattr(self, "_scratch", None) else out

    def read_buffer(self, index: int) -> np.ndarray:
        """Read buffer ``index % buffers_in_file`` (zero-copy view in RAM mode)."""
        index = index % self.buffers_in_file
        if self._ram is not None:
            return self._ram[index]
        return self._read_from_disk(index)

    def buffers(self) -> Iterator[np.ndarray]:
        i = 0
        while self.total is None or i < self.total:
            if self.wait_time_us:
                time.sleep(self.wait_time_us / 1e6)
            yield self.read_buffer(i)
            i += 1


class SyntheticSource:
    """Procedural interferogram generator -- test/benchmark fixture when no
    recorded volume is at hand.  Generates DC + fringe components + noise,
    quantized to the configured bit depth."""

    def __init__(self, acq: AcqParams, n_buffers: Optional[int] = None,
                 seed: int = 0, n_reflectors: int = 3):
        self.acq = acq
        self.total = n_buffers
        self._dtype = _np_dtype(acq.bit_depth)
        rng = np.random.default_rng(seed)
        n = acq.samples_per_line
        k = np.arange(n)
        max_code = min(2 ** acq.bit_depth - 1, np.iinfo(self._dtype).max)
        base = np.full(n, 0.45 * max_code)
        for _ in range(n_reflectors):
            depth = rng.uniform(5, n / 2 - 5)
            amp = rng.uniform(0.05, 0.15) * max_code
            base = base + amp * np.sin(2 * np.pi * depth * k / n + rng.uniform(0, 2 * np.pi))
        self._template = base
        self._noise_scale = 0.01 * max_code
        self._max_code = max_code
        self._seed = seed

    def read_buffer(self, index: int) -> np.ndarray:
        # noise keyed by (seed, buffer index): any buffer can be regenerated
        # exactly, so a replayed stream is bit-identical run to run (the
        # replay property PhytoDeviceModel has; a shared-RNG stream was not
        # reproducible per-buffer)
        rng = np.random.default_rng((self._seed, 2, index))
        noise = rng.normal(0.0, self._noise_scale, self.acq.buffer_shape)
        raw = np.clip(self._template[None, None, :] + noise, 0, self._max_code)
        return raw.astype(self._dtype)

    def buffers(self) -> Iterator[np.ndarray]:
        i = 0
        while self.total is None or i < self.total:
            yield self.read_buffer(i)
            i += 1
