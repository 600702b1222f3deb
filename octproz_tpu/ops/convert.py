"""Raw-sample decode: integer acquisition samples -> float32.

Numerics match the reference's input conversion kernels
(octproz_project/octproz/src/cuda_code.cu:109-147):

* ``inputToCufftComplex``: plain unsigned-int -> float cast for 8/16/32-bit
  containers (bit depth ranges <=8, 9..16, >16).
* ``inputToCufftComplex_and_bitshift``: additionally right-shifts 16-bit
  containers by 4 (12-bit samples in 16-bit words, e.g. ATS9373 digitizers,
  docs/docs/processing.md:18); the 32-bit path divides by 2^32 instead.

As a capability superset we also support unpacking 12-bit *packed* input
(two samples per 3 bytes), which the reference enumerates but does not
implement (octalgorithmparameters.h:69, docs/docs/faq.md:3-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def decode(raw: jnp.ndarray, bit_depth: int, bitshift: bool = False) -> jnp.ndarray:
    """Decode an unsigned-integer sample array to float32 (same shape).

    ``raw`` must already have the container dtype implied by ``bit_depth``
    (uint8 / uint16 / uint32, see AcqParams.raw_dtype).
    """
    if bit_depth <= 8:
        x = raw.astype(jnp.uint8)
        if bitshift:
            x = x >> 4
        return x.astype(jnp.float32)
    if bit_depth <= 16:
        x = raw.astype(jnp.uint16)
        if bitshift:
            x = x >> 4
        return x.astype(jnp.float32)
    x = raw.astype(jnp.uint32)
    if bitshift:
        # cuda_code.cu:144 -- 32-bit bitshift path scales to [0, 1)
        return x.astype(jnp.float32) / jnp.float32(4294967296.0)
    return x.astype(jnp.float32)


def unpack_uint12_device(packed: jnp.ndarray, n_samples: int) -> jnp.ndarray:
    """Device-side 12-bit unpack: uint8[(n_samples//2)*3] -> uint16[n_samples].

    The packed-12 WIRE FORMAT for host->device streaming: 12-bit digitizer
    samples cross the link at 1.5 bytes/sample instead of 2 (the 12-in-16
    container), raising a link-bound feed's ceiling by 33 %.  The unpack is
    one cheap elementwise XLA pass on device.  This is the capability the
    reference enumerates as ``UINT12_PACKED`` but never implements
    (octalgorithmparameters.h:69, docs/docs/faq.md:3-5).

    Layout matches the host/native unpack (two samples per 3-byte group,
    native/octnative.cpp:154-165).  n_samples must be even (every real
    buffer geometry is).  Shifts run in int32.

    When ``n_samples`` is a multiple of 256 the unpack works on rows of
    384 bytes (= 256 samples, :func:`unpack_uint12_rows`, which a mesh can
    shard line by line); other even counts take the ``(N, 3)`` form.
    """
    if n_samples % 2:
        raise ValueError("device unpack needs an even sample count")
    if n_samples % 256 == 0:
        return unpack_uint12_rows(packed).reshape(n_samples)
    b = packed.reshape(-1, 3).astype(jnp.int32)
    s0 = jnp.bitwise_or(b[:, 0], jnp.left_shift(
        jnp.bitwise_and(b[:, 1], 0x0F), 8))
    s1 = jnp.bitwise_or(jnp.right_shift(b[:, 1], 4),
                        jnp.left_shift(b[:, 2], 4))
    return jnp.stack([s0, s1], axis=1).reshape(n_samples).astype(jnp.uint16)


def unpack_uint12_rows(packed: jnp.ndarray) -> jnp.ndarray:
    """Leading-axes-preserving 12-bit unpack: uint8 (..., nbytes) ->
    uint16 (..., nbytes * 2 // 3), nbytes a multiple of 384 (256 samples).

    Every operation touches ONLY the trailing byte axis, so a wire buffer
    shaped (bscans, ascans, bytes_per_line) and GSPMD-sharded on its
    leading axes unpacks with zero cross-device communication — packing is
    line-local, which is what makes the packed-12 wire shardable on B-scan
    boundaries (the mesh streaming path, models/fdoct.put_packed_buffer).
    :func:`unpack_uint12_device`'s %256 branch delegates here."""
    *lead, nbytes = packed.shape
    if nbytes % 384:
        raise ValueError(
            f"row unpack needs the byte count to be a multiple of 384 "
            f"(256 samples), got {nbytes}")
    rows = nbytes // 384
    b = packed.reshape(*lead, rows, 384).astype(jnp.int32)
    b0, b1, b2 = b[..., 0::3], b[..., 1::3], b[..., 2::3]  # (..., rows, 128)
    s0 = jnp.bitwise_or(b0, jnp.left_shift(jnp.bitwise_and(b1, 0x0F), 8))
    s1 = jnp.bitwise_or(jnp.right_shift(b1, 4), jnp.left_shift(b2, 4))
    cat = jnp.concatenate([s0, s1], axis=-1)               # (..., rows, 256)
    k = jnp.arange(256)
    interleave = jnp.where(k % 2 == 0, k // 2, 128 + k // 2)
    out = jnp.take(cat, interleave, axis=-1)
    return out.reshape(*lead, rows * 256).astype(jnp.uint16)


def unpack_uint12_packed(raw_bytes: np.ndarray, n_samples: int) -> np.ndarray:
    """Unpack little-endian 12-bit packed samples (two per 3 bytes) -> uint16.

    Host-side helper (numpy): packed layout is
    ``[s0 low 8 | s1 low 4 + s0 high 4 | s1 high 8]`` per 3-byte group.
    An odd trailing sample occupies only 2 bytes (same layout as the
    native unpack, native/octnative.cpp:161-164).
    """
    b = np.asarray(raw_bytes, dtype=np.uint8).reshape(-1)
    needed = 3 * (n_samples // 2) + (2 if n_samples & 1 else 0)
    if b.size < needed:
        raise ValueError(
            f"packed 12-bit buffer too small: {n_samples} samples need "
            f"{needed} bytes, have {b.size}")
    n_groups = (n_samples + 1) // 2
    if b.size < n_groups * 3:  # odd tail: pad the missing third byte
        b = np.concatenate([b, np.zeros(n_groups * 3 - b.size, np.uint8)])
    b = b[: n_groups * 3].reshape(n_groups, 3).astype(np.uint16)
    s0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
    s1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    out = np.empty(n_groups * 2, dtype=np.uint16)
    out[0::2] = s0
    out[1::2] = s1
    return out[:n_samples]
