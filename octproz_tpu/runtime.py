"""Streaming runtime: the host loop that drives acquisition -> device ->
subscribers at line rate.

Capability-equivalent of the reference's ``Processing`` controller
(octproz_project/octproz/src/processing.cpp:136-229 hot loop), its
GPU->host streaming ring (cuda_code.cu:1357-1386, processing.cpp:316-365)
and the ``Gpu2HostNotifier`` callback bridge (src/gpu2hostnotifier.cpp:75-96)
-- re-expressed in JAX:

* The reference overlaps copy/compute with 8 rotating CUDA streams plus a
  blocking event that stops acquisition outpacing processing
  (cuda_code.cu:42,1396,1416-1420).  Here, JAX's async dispatch pipelines
  H2D copy, compute and D2H fetch automatically; the runtime keeps at most
  ``max_in_flight`` un-fetched steps outstanding (the back-pressure analog of
  that blocking event) and a background prefetch thread keeps the host-side
  feed ahead of the device (the analog of the acquisition double buffer,
  acquisitionbuffer.h:53-58).
* GPU->host streaming decimation: every ``streaming_skip + 1``-th processed
  buffer is quantized on device (ops.quantize ~ floatToOutput,
  cuda_code.cu:943-967) and fetched, mirroring
  ``streamingBuffersToSkip`` (octalgorithmparameters.h:189-192).
* Throughput metrics over 5 s windows: volumes/s, buffers/s, B-scans/s,
  A-scans/s, MB/s -- same numbers as the reference's info box
  (processing.cpp:193-207).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .io.recorder import Recorder, RecordingParams, write_meta
from .io.source import AcquisitionSource
from .models.fdoct import FdOctModel
from .ops import quantize as quantize_mod
from .plugins import ExtensionManager


@dataclasses.dataclass
class ThroughputStats:
    """One 5-second metrics window (processing.cpp:198-204).

    ``mb_per_s``/``buffer_mb`` are CONTAINER bytes (uint16 samples — the
    reference's numbers); ``wire_mb_per_s``/``wire_mb`` are the bytes that
    actually crossed the host->device link, which differ under the
    packed-12 wire (1.5 B/sample, 25 % less)."""

    buffers_per_s: float = 0.0
    bscans_per_s: float = 0.0
    ascans_per_s: float = 0.0
    volumes_per_s: float = 0.0
    mb_per_s: float = 0.0
    buffer_mb: float = 0.0
    wire_mb_per_s: float = 0.0
    wire_mb: float = 0.0
    buffers_processed: int = 0

    def info_line(self) -> str:
        wire = (f" ({self.wire_mb_per_s:.0f} MB/s wire)"
                if self.wire_mb != self.buffer_mb else "")
        return (f"{self.volumes_per_s:.1f} volumes/s, "
                f"{self.buffers_per_s:.0f} buffers/s ({self.buffer_mb:.1f} MB), "
                f"{self.bscans_per_s:.0f} B-scans/s, "
                f"{self.ascans_per_s / 1e3:.0f} kHz A-scans, "
                f"{self.mb_per_s:.0f} MB/s{wire}")


class ThroughputMeter:
    """Windowed throughput counter (reference: 5 s info-box updates).

    ``wire_bytes_per_buffer``: bytes per buffer on the host->device link
    (defaults to the container size; the packed-12 wire passes its smaller
    actual byte count so link metrics are honest)."""

    def __init__(self, acq, window_s: float = 5.0,
                 wire_bytes_per_buffer: Optional[int] = None):
        self._acq = acq
        self._window_s = window_s
        self._wire_bytes = (acq.bytes_per_buffer if wire_bytes_per_buffer
                            is None else wire_bytes_per_buffer)
        self._count = 0
        self._t0: Optional[float] = None
        self.total_buffers = 0
        self.last: Optional[ThroughputStats] = None

    def tick(self, now: Optional[float] = None) -> Optional[ThroughputStats]:
        """Count one processed buffer; returns stats when a window closes."""
        now = time.perf_counter() if now is None else now
        if self._t0 is None:
            self._t0 = now
        self._count += 1
        self.total_buffers += 1
        dt = now - self._t0
        if dt < self._window_s:
            return None
        acq = self._acq
        bps = self._count / dt
        buffer_mb = acq.bytes_per_buffer / 1e6
        wire_mb = self._wire_bytes / 1e6
        stats = ThroughputStats(
            buffers_per_s=bps,
            bscans_per_s=bps * acq.bscans_per_buffer,
            ascans_per_s=bps * acq.ascans_per_buffer,
            volumes_per_s=bps / max(acq.buffers_per_volume, 1),
            mb_per_s=bps * buffer_mb,
            buffer_mb=buffer_mb,
            wire_mb_per_s=bps * wire_mb,
            wire_mb=wire_mb,
            buffers_processed=self.total_buffers,
        )
        self._count = 0
        self._t0 = now
        self.last = stats
        return stats


class _Prefetcher:
    """Background thread that keeps a bounded queue of raw host buffers ahead
    of the device step -- the acquisition-thread / double-buffer analog
    (virtualoctsystem.cpp:196-223, acquisitionbuffer.h:53-58).  The bounded
    queue IS the back-pressure handshake: when processing falls behind, the
    producer blocks exactly like the reference's spin-wait on
    ``bufferReadyArray``."""

    _SENTINEL = object()

    def __init__(self, source: AcquisitionSource, depth: int = 2):
        self._source = source
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="octproz-acquisition")
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        try:
            for buf in self._source.buffers():
                if self._stop.is_set():
                    break
                while not self._stop.is_set():
                    try:
                        self._queue.put(buf, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate into the consumer
            self.error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, poll: float = 0.5,
            stop: Optional[threading.Event] = None) -> Optional[np.ndarray]:
        """Next raw buffer, or None when the source is exhausted/stopped.

        End-of-stream is signalled ONLY by the sentinel (or the acquisition
        thread dying); a transiently empty queue -- e.g. the first device
        compile stalling the host for tens of seconds -- must never be
        mistaken for it, or the stream is silently truncated.  Source-side
        staleness is the source's job (HardwareRingSource.timeout_s).

        ``stop``: an external stop request (the engine's) — honored between
        polls so a caller blocked here can still be stopped while the
        producer side is stuck (e.g. an upload that never returns)."""
        while True:
            if stop is not None and stop.is_set():
                return None
            try:
                item = self._queue.get(timeout=poll)
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    if self.error is not None:
                        raise self.error
                    return None
                continue
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return None
            return item

    def stop(self) -> None:
        self._stop.set()
        # drain so the producer unblocks
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class _DeviceFeeder:
    """Second pipeline stage: uploads raw buffers to the device AHEAD of
    the step, so H2D of buffer i+1 overlaps the compute of buffer i — the
    analog of the reference's per-stream ``cudaMemcpyAsync`` feeding the
    next kernel batch while the previous one runs (cuda_code.cu:1396-1406).
    ``jax.device_put`` of a large pageable host array blocks the calling
    thread while it stages the copy, so the upload runs on its own thread
    with a bounded queue of (host_raw, device_raw) pairs; the queue depth
    bounds device-side raw backlog (depth x buffer bytes of device
    memory).

    End-of-stream follows the count contract style: the wrapped
    prefetcher's None is forwarded as a sentinel AFTER every uploaded
    buffer."""

    _SENTINEL = object()

    def __init__(self, prefetcher: "_Prefetcher", model: FdOctModel,
                 depth: int = 2, wire_format: str = "uint16"):
        self._prefetcher = prefetcher
        self._model = model
        self._put = (model.put_packed_buffer if wire_format == "packed12"
                     else model.put_buffer)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="octproz-upload")
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                raw = self._prefetcher.get()
                if raw is None:
                    break
                dev = self._put(raw)
                while not self._stop.is_set():
                    try:
                        self._queue.put((raw, dev), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:
            self.error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, poll: float = 0.5,
            stop: Optional[threading.Event] = None):
        """Next (host_raw, device_raw), or None at end of stream (or when
        ``stop`` is set — the upload thread may be stuck inside a
        device_put, and a stop request must still be able to end the run
        loop)."""
        while True:
            if stop is not None and stop.is_set():
                return None
            try:
                item = self._queue.get(timeout=poll)
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    if self.error is not None:
                        raise self.error
                    return None
                continue
            if item is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return None
            return item

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class StreamingEngine:
    """The acquisition->processing->subscribers loop.

    Composition (mirrors octprozapp.cpp:25-59 object graph):
      source     -> raw feed   -> raw recorder + extensions (raw)
                 -> device step (FdOctModel)
                 -> decimated quantized host fetch -> processed recorder,
                    extensions (processed), on_processed callbacks
    """

    def __init__(
        self,
        model: FdOctModel,
        source: AcquisitionSource,
        extensions: Optional[ExtensionManager] = None,
        stream_to_host: bool = False,
        streaming_skip: int = 0,
        streaming_bit_depth: Optional[int] = None,
        max_in_flight: int = 2,
        prefetch_depth: int = 2,
        upload_prefetch: bool = True,
        wire_format: str = "uint16",
        dispatch_chunk: int = 1,
        chunk_strategy: str = "auto",
        metrics_window_s: float = 5.0,
        on_metrics: Optional[Callable[[ThroughputStats], None]] = None,
        on_processed: Optional[Callable[[np.ndarray, int], None]] = None,
        on_volume: Optional[Callable[[np.ndarray, int], None]] = None,
        on_info: Optional[Callable[[str], None]] = None,
    ):
        self.model = model
        self.source = source
        self.extensions = extensions or ExtensionManager()
        self.stream_to_host = stream_to_host
        self.streaming_skip = streaming_skip
        self.streaming_bit_depth = streaming_bit_depth or model.acq.bit_depth
        self.max_in_flight = max(1, max_in_flight)
        self.prefetch_depth = prefetch_depth
        # pipelined H2D: a dedicated upload thread keeps the next raw
        # buffer(s) already ON the device while the current one computes
        # (_DeviceFeeder).  Multi-host feeds stay on the loop thread: the
        # per-process shard commit coordinates across processes.
        self.upload_prefetch = upload_prefetch and not model.is_multihost
        # "packed12": the source yields packed-12-bit wire buffers
        # (uint8, 1.5 bytes/sample); they cross the link packed and are
        # unpacked on device (model.put_packed_buffer).  The raw RECORDER
        # keeps the packed wire bytes verbatim (the honest record of what
        # the digitizer delivered); raw-data EXTENSIONS receive unpacked
        # sample values (see the run-loop fan-out).
        if wire_format not in ("uint16", "packed12"):
            raise ValueError("wire_format must be 'uint16' or 'packed12'")
        self.wire_format = wire_format
        # >1: batch this many buffers into ONE device dispatch --
        # throughput mode that amortizes per-dispatch cost; costs
        # dispatch_chunk buffers of latency (bench.py chunk analog).
        # chunk_strategy "auto" upgrades the lax.scan chunk to one fold
        # step over the whole stack whenever the config allows it.
        self.dispatch_chunk = max(1, dispatch_chunk)
        self.chunk_strategy = chunk_strategy
        self.on_metrics = on_metrics
        self.on_processed = on_processed
        self.on_info = on_info or (lambda msg: None)

        self.raw_recorder = Recorder("raw")
        self.processed_recorder = Recorder("processed")
        self._record_as_float = False
        self._stop_after_record = False
        self.scheduler = None  # optional RecordingScheduler (see schedule_recordings)
        self.assembler = None  # d_processedBuffer analog (cuda_code.cu:1530-1535)
        if on_volume is not None:
            from .io.volume import VolumeAssembler

            self.assembler = VolumeAssembler(model.acq, on_volume=on_volume)
        wire_bytes = (model.acq.samples_per_buffer * 3 // 2
                      if wire_format == "packed12"
                      else model.acq.bytes_per_buffer)
        self.meter = ThroughputMeter(model.acq, metrics_window_s,
                                     wire_bytes_per_buffer=wire_bytes)
        self.running = False
        self._stop_requested = threading.Event()
        self._quantize = jax.jit(
            lambda x: quantize_mod.quantize(x, self.streaming_bit_depth))
        # post-process background capture (cuda_code.cu:743-755, 1556-1562)
        self._post_bg_remaining = 0
        self._post_bg_total = 0
        self._post_bg_accum = None
        from .ops import postprocess as _pp

        self._get_background = jax.jit(_pp.get_background)
        # cheap replicated scalar probe used to bound host run-ahead when
        # nothing is fetched (the blocking-event analog, cuda_code.cu:1416-1420)
        self._probe = jax.jit(lambda x: x[0, 0, 0])

    # -- recording (octprozapp.cpp:215-299 / processing.cpp:231-267) --------
    def start_recording(self, params: RecordingParams) -> None:
        ts = time.strftime("%Y%m%d_%H%M%S")
        if params.save_raw:
            self.raw_recorder.start(params, ts)
        if params.save_processed:
            self.processed_recorder.start(params, ts)
            self._record_as_float = params.save_as_32bit_float
        self._stop_after_record = params.stop_after_record
        if params.save_meta:
            import os
            prefix = os.path.join(params.save_dir, f"{ts}_{params.name}")
            write_meta(prefix, self.model.acq, self.model.cfg, params)
            if params.settings_file:
                # the reference's metadata is a COPY of settings.ini
                # (octprozapp.cpp:295-298); keep that too when a settings
                # file drives the session
                import shutil
                try:
                    shutil.copyfile(params.settings_file,
                                    prefix + "_settings.ini")
                except OSError as e:
                    self.on_info(f"settings-file copy failed: {e}")
        self.on_info(f"recording started: {params.name}")

    def schedule_recordings(self, params: RecordingParams, delay_s: float = 0.0,
                            interval_s: float = 60.0, total: int = 1,
                            retry_s: float = 10.0) -> None:
        """Timer-driven recording series (RecordingScheduler analog,
        recordingscheduler.cpp:131-155); polled from the run loop."""
        from .io.recorder import RecordingScheduler

        def start() -> bool:
            if self.recording:
                return False  # overlap protection
            # stop_after_record must not kill the series after recording 1:
            # honor it only on the final recording (REC_STOP + scheduler,
            # octprozapp.cpp:424-446, recordingscheduler.cpp:131-155)
            last = (self.scheduler is None
                    or self.scheduler.done >= self.scheduler.total - 1)
            self.start_recording(
                params if last else
                dataclasses.replace(params, stop_after_record=False))
            return True

        self.scheduler = RecordingScheduler(start, delay_s, interval_s, total,
                                            retry_s)
        self.scheduler.start()

    @property
    def recording(self) -> bool:
        return self.raw_recorder.recording or self.processed_recorder.recording

    # -- post-process background capture (cuda_code.cu:743-767, 1556-1568) --
    def record_post_background(self, n_buffers: int = 1) -> None:
        """Capture the mean A-scan of the next ``n_buffers`` processed
        buffers from the live stream and install it as the post-process
        background curve (reference: record-on-request ->
        getPostProcessBackground -> postProcessBackgroundRemoval,
        cuda_code.cu:1556-1568).

        The curve is a traced array: installing it does NOT recompile.  Like
        the reference GUI flow, record with removal weight 0 / removal off;
        if removal is already active the captured curve includes it (warned).
        """
        if n_buffers < 1:
            raise ValueError("n_buffers must be >= 1")
        if self.model.cfg.post_background_removal:
            self.on_info("warning: post-background capture while removal is "
                         "active records the already-corrected stream")
        self._post_bg_total = n_buffers
        self._post_bg_remaining = n_buffers
        self._post_bg_accum = None

    def _capture_post_background(self, processed) -> None:
        bg = self._get_background(processed)  # device-side mean A-scan
        self._post_bg_accum = (bg if self._post_bg_accum is None
                               else self._post_bg_accum + bg)
        self._post_bg_remaining -= 1
        if self._post_bg_remaining == 0:
            avg = np.asarray(self.model.fetch(self._post_bg_accum),
                             np.float32) / self._post_bg_total
            self.model.set_post_background(avg)
            self._post_bg_accum = None
            self.on_info(f"post-process background recorded "
                         f"({self._post_bg_total} buffers averaged)")

    def stop(self) -> None:
        """Request the run loop to exit (octprozapp.cpp slot_stop analog)."""
        self._stop_requested.set()

    # -- the hot loop (processing.cpp:176-218) ------------------------------
    def run(self, max_buffers: Optional[int] = None) -> int:
        """Drive the stream until the source ends, ``max_buffers`` is hit, or
        :meth:`stop` is called.  Returns the number of buffers processed."""
        acq = self.model.acq
        bufs_per_vol = max(acq.buffers_per_volume, 1)

        def want_raw_fanout() -> bool:
            # evaluated per buffer: an extension activated mid-stream (live
            # control) must start receiving raw data immediately, like the
            # per-call check on the processed side
            return any(e.active and e.wants_raw_data
                       for e in self.extensions.extensions.values())

        prefetcher = _Prefetcher(self.source, self.prefetch_depth)
        prefetcher.start()
        feeder = None
        if self.upload_prefetch:
            feeder = _DeviceFeeder(prefetcher, self.model,
                                   depth=self.prefetch_depth,
                                   wire_format=self.wire_format)
            feeder.start()
        self._stop_requested.clear()
        self.running = True

        # In-flight device results awaiting decimated host fetch:
        # list of (buffer_nr, device_array or None).  Length <= max_in_flight
        # -- the back-pressure analog of the blocking CUDA event
        # (cuda_code.cu:1416-1420).
        in_flight: List[tuple] = []
        processed_count = 0
        chunk_raws: List[np.ndarray] = []

        def dispatch_one(processed, buffer_nr: int,
                         probe: bool = True) -> None:
            nonlocal processed_count
            if self._post_bg_remaining > 0:
                self._capture_post_background(processed)

            # Two independent D2H streams, like the reference's separate
            # streamProcessedFloatData / streamProcessedData kernels
            # (cuda_code.cu:1595-1604): the float32 recorder stream
            # (un-quantized, every buffer) and the quantized consumer
            # stream (extensions/viewer/assembler, skip-N decimated).
            # Recording the quantized stream fetches EVERY buffer
            # regardless of stream_to_host — the reference forces
            # streaming on with skip 0 while recording
            # (octprozapp.cpp:408-416).
            recording = self.processed_recorder.recording
            record_float = recording and self._record_as_float
            record_quant = recording and not self._record_as_float
            stream_due = (self.stream_to_host
                          and processed_count % (self.streaming_skip + 1) == 0)
            dev_float = processed if record_float else None
            dev_quant = (self._quantize(processed)
                         if (record_quant or stream_due) else None)
            if dev_float is None and dev_quant is None:
                # nothing is fetched for this buffer: retain a cheap
                # device scalar so draining can still block on step
                # completion -- the explicit analog of the reference's
                # blocking CUDA event (cuda_code.cu:1416-1420).  Without
                # it nothing bounds how far the host runs ahead of the
                # device.  In chunked mode only the LAST buffer of a chunk
                # carries the probe (probe=False otherwise): one dispatch +
                # one sync per chunk instead of per buffer.
                in_flight.append((buffer_nr, None, None, False,
                                  self._probe(processed) if probe else None))
            else:
                # record_quant is the ENQUEUE-time decision: a recording
                # started while these buffers are in flight must not
                # swallow pre-start data (or mix quantized frames into a
                # float32 recording)
                in_flight.append((buffer_nr, dev_float, dev_quant,
                                  record_quant, None))

            if len(in_flight) > self.max_in_flight:
                self._drain_one(in_flight)

            processed_count += 1
            if self._stop_after_record and not self.recording:
                # auto-stop once the recording finished (REC_STOP,
                # octprozapp.cpp:424-446); a scheduled series only sets it
                # on its final recording (see schedule_recordings)
                self._stop_after_record = False
                self.on_info("recording complete: stopping stream")
                self._stop_requested.set()
            if self.scheduler is not None and self.scheduler.active:
                self.scheduler.poll()
            stats = self.meter.tick()
            if stats is not None:
                self.on_info(stats.info_line())
                if self.on_metrics:
                    self.on_metrics(stats)

        def flush_chunk() -> None:
            """Dispatch the accumulated raw buffers as ONE scan step.

            A partial tail (the stream length is rarely a chunk multiple)
            falls back to the per-buffer step: a chunk of a NEW stack shape
            would force a fresh compile just to finish the last few
            buffers, while the per-buffer executable is one compile
            reusable for any tail."""
            if not chunk_raws:
                return
            if len(chunk_raws) < self.dispatch_chunk:
                for raw in chunk_raws:
                    if self._stop_requested.is_set():
                        break
                    dispatch_one(self.model.process_buffer(raw),
                                 processed_count % bufs_per_vol)
            else:
                first_nr = processed_count % bufs_per_vol
                # with the upload feeder the chunk entries are already
                # device arrays: stack ON DEVICE (one cheap HBM pass)
                # instead of a host memcpy + one giant synchronous upload
                stack = (jnp.stack(chunk_raws)
                         if isinstance(chunk_raws[0], jax.Array)
                         else np.stack(chunk_raws))
                outs = self.model.process_chunk(stack,
                                                strategy=self.chunk_strategy)
                for i in range(outs.shape[0]):
                    if self._stop_requested.is_set():
                        break  # stop() / stop_after_record honored mid-chunk
                    dispatch_one(outs[i], (first_nr + i) % bufs_per_vol,
                                 probe=(i == outs.shape[0] - 1))
            chunk_raws.clear()

        try:
            while not self._stop_requested.is_set():
                if max_buffers is not None and \
                        processed_count + len(chunk_raws) >= max_buffers:
                    break
                if feeder is not None:
                    item = feeder.get(stop=self._stop_requested)
                    if item is None:
                        break
                    raw, dev = item
                else:
                    raw = prefetcher.get(stop=self._stop_requested)
                    if raw is None:
                        break
                    # inline upload on the loop thread (no feeder)
                    dev = (self.model.put_packed_buffer(raw)
                           if self.wire_format == "packed12" else raw)
                buffer_nr = (processed_count + len(chunk_raws)) % bufs_per_vol

                # raw-side subscribers get the host buffer before upload
                # (processing.cpp:182 emit rawData).  The raw RECORDER keeps
                # the wire bytes verbatim (the honest record of what the
                # digitizer delivered), but raw-data EXTENSIONS expect
                # sample-valued arrays — under the packed-12 wire they must
                # see unpacked samples or their statistics are silently
                # computed on pack bytes.
                if self.raw_recorder.recording:
                    self.raw_recorder.record_buffer(raw, buffer_nr)
                if want_raw_fanout():
                    host_raw = np.asarray(raw)
                    if self.wire_format == "packed12":
                        from . import native as _native
                        host_raw = _native.unpack_uint12(
                            host_raw.reshape(-1),
                            acq.samples_per_buffer).reshape(acq.buffer_shape)
                    self.extensions.feed_raw(host_raw, acq, buffer_nr)

                if self.dispatch_chunk > 1:
                    chunk_raws.append(dev if isinstance(dev, jax.Array)
                                      else np.asarray(raw))
                    if len(chunk_raws) >= self.dispatch_chunk:
                        flush_chunk()
                    continue

                dispatch_one(self.model.process_buffer(dev), buffer_nr)

            if not self._stop_requested.is_set():
                flush_chunk()  # partial tail (single-buffer mode: no-op)
            while in_flight:
                self._drain_one(in_flight)
            # wait for the final dispatched step: everything dispatched has
            # executed when run() returns
            jax.block_until_ready(self.model.fpn_state.mean_line)
            # end-of-stream flush: a source that ends before
            # buffers_to_record must not silently discard the capture
            for rec in (self.raw_recorder, self.processed_recorder):
                if rec.recording:
                    path = rec.flush()
                    self.on_info(
                        f"stream ended mid-recording: "
                        + (f"partial {rec.name} recording saved to {path}"
                           if path else f"no {rec.name} buffers captured"))
        finally:
            self.running = False
            if feeder is not None:
                feeder.stop()
            prefetcher.stop()
        return processed_count

    def _drain_one(self, in_flight: List[tuple]) -> None:
        buffer_nr, dev_float, dev_quant, record_quant, throttle = \
            in_flight.pop(0)
        if dev_float is None and dev_quant is None:
            if throttle is not None:
                # back-pressure sync: wait for this buffer's step, so the
                # host never runs ahead of the device unbounded
                jax.block_until_ready(throttle)
            return
        # D2H fetch (the gpu2hostnotifier moment); on a multi-host mesh each
        # process fetches only its own B-scan block (model.fetch)
        was_recording = self.processed_recorder.recording
        if dev_float is not None:
            # recorder-only stream (the reference's float path feeds the
            # Recorder, not the extensions, processing.cpp:251-264)
            host_f = self.model.fetch(dev_float)
            if host_f.dtype.name == "bfloat16":
                # cfg.output_dtype="bfloat16" halves the transfer; the
                # float32 recorder contract is restored after the wire
                host_f = host_f.astype(np.float32)
            self.processed_recorder.record_buffer(host_f, buffer_nr)
        if dev_quant is not None:
            host = self.model.fetch(dev_quant)
            if record_quant and self.processed_recorder.recording:
                self.processed_recorder.record_buffer(host, buffer_nr)
            self.extensions.feed_processed(host, self.model.acq,
                                           self.streaming_bit_depth,
                                           buffer_nr)
            if self.assembler is not None:
                self.assembler.add(
                    quantize_mod.dequantize(host, self.streaming_bit_depth),
                    buffer_nr)
            if self.on_processed:
                self.on_processed(host, buffer_nr)
        if (was_recording and not self.processed_recorder.recording
                and self._params_want_screenshots()):
            # this drain's buffer completed the recording
            self._save_screenshots(host_f if dev_float is not None else host)

    def _params_want_screenshots(self) -> bool:
        p = self.processed_recorder._params
        return bool(p and p.save_screenshots and
                    self.processed_recorder.last_file)

    def _save_screenshots(self, host_buffer: np.ndarray) -> None:
        """B-scan + en-face + MIP render PNGs next to the recording
        (screenshot fan-out analog, octprozapp.cpp:266-292)."""
        from .viz import (RenderMode, RenderParams, render_volume,
                          save_bscan_png, save_enface_png, save_png)
        from .viz.render import cpu_device, cpu_pinned

        base = self.processed_recorder.last_file[:-4]
        # normalize by the quantized CODE max (2**bits - 1), not the
        # container dtype max — 12-bit codes ride in uint16
        vol = quantize_mod.dequantize(host_buffer, self.streaming_bit_depth)
        try:
            # EVERYTHING here is pinned to the CPU backend — the projection
            # ops are jnp too, and the display path must not contend with
            # the processing stream on the card
            with cpu_pinned():
                save_bscan_png(base + "_bscan.png", vol,
                               frame_nr=vol.shape[0] // 2)
                save_enface_png(base + "_enface.png", vol,
                                depth_nr=vol.shape[2] // 2)
                img = render_volume(vol, RenderParams(mode=RenderMode.MIP,
                                                      step_length=0.02),
                                    yaw=0.5, pitch=0.4, out_shape=(256, 256),
                                    device=cpu_device())
            save_png(base + "_volume.png", img)
            self.on_info(f"screenshots saved: {base}_*.png")
        except Exception as e:  # screenshots must never kill the stream
            self.on_info(f"screenshot saving failed: {e}")
