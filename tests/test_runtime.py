"""Streaming runtime tests: prefetch/back-pressure loop, decimated host
streaming, recorder wiring, extension fan-out, metrics.

Reference behaviors mirrored: Processing hot loop (processing.cpp:176-218),
streamingBuffersToSkip decimation (octalgorithmparameters.h:189-192),
raw/processed recorders (processing.cpp:231-267)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from octproz_tpu import AcqParams, FpnMode, ProcConfig, Interpolation
from octproz_tpu.io.recorder import RecordingParams
from octproz_tpu.io.source import SyntheticSource
from octproz_tpu.models.fdoct import FdOctModel
from octproz_tpu.plugins import Extension, ExtensionManager
from octproz_tpu.runtime import StreamingEngine, ThroughputMeter


ACQ = AcqParams(samples_per_line=64, ascans_per_bscan=16, bscans_per_buffer=4,
                buffers_per_volume=2, bit_depth=12)
CFG = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                 windowing=True, dispersion=False, fpn_mode=FpnMode.OFF,
                 log_scaling=True)


def make_engine(tmp_path=None, n_buffers=6, **kw):
    model = FdOctModel(ACQ, CFG, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    source = SyntheticSource(ACQ, n_buffers=n_buffers)
    return StreamingEngine(model, source, **kw)


class CollectingExtension(Extension):
    name = "collector"
    wants_raw_data = True
    wants_processed_data = True

    def __init__(self):
        super().__init__()
        self.raw_calls = []
        self.processed_calls = []

    def raw_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self.raw_calls.append((buffer.shape, bit_depth, nr))

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self.processed_calls.append((buffer.copy(), bit_depth, nr))


def test_run_processes_all_buffers():
    eng = make_engine(n_buffers=6)
    assert eng.run() == 6
    assert not eng.running


def test_max_buffers_limit_and_stop():
    eng = make_engine(n_buffers=None)  # endless source
    assert eng.run(max_buffers=5) == 5


def test_streaming_decimation_and_quantization():
    got = []
    eng = make_engine(n_buffers=8, stream_to_host=True, streaming_skip=1,
                      on_processed=lambda buf, nr: got.append((buf, nr)))
    eng.run()
    # skip=1 -> every 2nd buffer fetched (octalgorithmparameters.h:189-192)
    assert len(got) == 4
    buf, _ = got[0]
    assert buf.dtype == np.uint16  # 12-bit -> uint16 container
    assert buf.shape == ACQ.processed_buffer_shape
    assert buf.max() <= 4095


def test_extension_fanout_and_buffer_nr_wraps():
    ext = CollectingExtension()
    mgr = ExtensionManager()
    mgr.add(ext)
    mgr.activate("collector")
    eng = make_engine(n_buffers=4, extensions=mgr, stream_to_host=True)
    eng.run()
    assert len(ext.raw_calls) == 4
    assert [nr for _, _, nr in ext.raw_calls] == [0, 1, 0, 1]  # buffers_per_volume=2
    assert len(ext.processed_calls) == 4


def test_inactive_extension_not_fed():
    ext = CollectingExtension()
    mgr = ExtensionManager()
    mgr.add(ext)  # never activated
    eng = make_engine(n_buffers=3, extensions=mgr, stream_to_host=True)
    eng.run()
    assert ext.raw_calls == [] and ext.processed_calls == []


def test_recording_raw_and_processed(tmp_path):
    eng = make_engine(n_buffers=6, stream_to_host=True)
    params = RecordingParams(save_dir=str(tmp_path), name="t",
                             buffers_to_record=2, save_raw=True,
                             save_processed=True, save_meta=True)
    eng.start_recording(params)
    eng.run()
    raws = glob.glob(str(tmp_path / "*_raw_*.raw"))
    procs = glob.glob(str(tmp_path / "*_processed_*.raw"))
    metas = glob.glob(str(tmp_path / "*_meta.json"))
    assert len(raws) == 1 and len(procs) == 1 and len(metas) == 1
    raw_data = np.fromfile(raws[0], dtype=np.uint16)
    assert raw_data.size == 2 * ACQ.samples_per_buffer
    proc_data = np.fromfile(procs[0], dtype=np.uint16)
    assert proc_data.size == 2 * ACQ.ascans_per_buffer * ACQ.output_ascan_length


def test_recording_float32(tmp_path):
    eng = make_engine(n_buffers=4)
    params = RecordingParams(save_dir=str(tmp_path), name="f",
                             buffers_to_record=2, save_raw=False,
                             save_processed=True, save_as_32bit_float=True,
                             save_meta=False)
    eng.start_recording(params)
    eng.run()
    procs = glob.glob(str(tmp_path / "*_processed_float32_*.raw"))
    assert len(procs) == 1
    data = np.fromfile(procs[0], dtype=np.float32)
    assert data.size == 2 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    assert np.isfinite(data).all()


def test_scheduled_recording_series(tmp_path):
    eng = make_engine(n_buffers=60)
    params = RecordingParams(save_dir=str(tmp_path), name="s",
                             buffers_to_record=1, save_raw=True,
                             save_meta=False)
    # interval 0 -> a new recording becomes due immediately after each ends
    eng.schedule_recordings(params, interval_s=0.0, total=3)
    eng.run()
    raws = glob.glob(str(tmp_path / "*_raw_*.raw"))
    assert len(raws) == 3
    assert eng.scheduler.done == 3 and not eng.scheduler.active


def test_source_error_propagates():
    class BadSource:
        acq = ACQ

        def buffers(self):
            yield np.zeros(ACQ.buffer_shape, np.uint16)
            raise IOError("acquisition hardware vanished")

    model = FdOctModel(ACQ, CFG, resample_coeffs=(0.0, 63.0, 0.0, 0.0))
    eng = StreamingEngine(model, BadSource())
    with pytest.raises(IOError, match="vanished"):
        eng.run()


def test_on_volume_assembly():
    vols = []
    eng = make_engine(n_buffers=6, stream_to_host=True,
                      on_volume=lambda v, i: vols.append((v.copy(), i)))
    eng.run()
    # 6 buffers / 2 per volume -> 3 complete volumes
    assert [i for _, i in vols] == [0, 1, 2]
    v0 = vols[0][0]
    assert v0.shape == (2 * ACQ.bscans_per_buffer, ACQ.ascans_per_bscan,
                        ACQ.output_ascan_length)
    assert v0.dtype == np.float32 and 0.0 <= v0.min() and v0.max() <= 1.0


def test_throughput_meter_window():
    meter = ThroughputMeter(ACQ, window_s=5.0)
    t = 100.0
    closed = []
    for i in range(10):
        out = meter.tick(now=t)
        if out is not None:
            closed.append(out)
        t += 1.0
    assert len(closed) == 1  # one 5 s window closed within 10 ticks
    out = closed[0]
    assert out.buffers_per_s == pytest.approx(6 / 5.0, rel=0.2)
    assert out.ascans_per_s == pytest.approx(out.buffers_per_s * ACQ.ascans_per_buffer)
    assert out.volumes_per_s == pytest.approx(out.buffers_per_s / 2)
    assert meter.total_buffers == 10


def test_record_post_background_flow():
    """record-on-request background capture -> installed as the curve used
    by postProcessBackgroundRemoval (cuda_code.cu:743-767, 1556-1568)."""
    cfg = dataclasses.replace(CFG, post_background_removal=True,
                              post_background_weight=1.0,
                              post_background_offset=0.0)
    model = FdOctModel(ACQ, cfg,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    # background starts as zeros -> removal is a no-op clip
    before = np.asarray(model.curves.post_background).copy()
    assert np.all(before == 0.0)

    outs = {}
    src = SyntheticSource(ACQ, n_buffers=6)
    eng = StreamingEngine(model, src, stream_to_host=True,
                          on_processed=lambda b, nr: outs.setdefault(len(outs), b))
    eng.record_post_background(2)
    assert eng.run() == 6

    bg = np.asarray(model.curves.post_background)
    assert bg.shape == (ACQ.output_ascan_length,)
    assert np.any(bg != 0.0)
    # buffers after installation are background-subtracted: the
    # SyntheticSource template repeats, so with weight 1 the corrected
    # image must collapse far below the uncorrected one (a no-op
    # installation would leave the medians equal)
    late = np.asarray(outs[max(outs)], np.float64)
    first = np.asarray(outs[0], np.float64)
    assert float(np.median(late)) < 0.5 * float(np.median(first))


def test_record_post_background_validates():
    eng = make_engine()
    with pytest.raises(ValueError):
        eng.record_post_background(0)


def test_unfetched_buffers_still_throttle():
    """With stream_to_host=False every in-flight entry must carry a device
    probe so the host cannot run unboundedly ahead (the blocking-event
    analog, cuda_code.cu:1416-1420)."""
    eng = make_engine(n_buffers=8, stream_to_host=False, max_in_flight=2)
    drained = []
    orig = eng._drain_one

    def spy(in_flight):
        drained.append(tuple(in_flight[0]))
        orig(in_flight)

    eng._drain_one = spy
    assert eng.run() == 8
    assert drained, "nothing was drained"
    for nr, dev_float, dev_quant, record_quant, throttle in drained:
        assert dev_float is None and dev_quant is None
        assert throttle is not None  # the retained device scalar


def test_bf16_output_upcast_for_host_consumers(tmp_path):
    """cfg.output_dtype="bfloat16" halves D2H bytes; the drain path upcasts
    so the float32 recorder and extensions keep their float32 contract."""
    cfg = dataclasses.replace(CFG, output_dtype="bfloat16")
    model = FdOctModel(ACQ, cfg,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    source = SyntheticSource(ACQ, n_buffers=4)
    eng = StreamingEngine(model, source)
    params = RecordingParams(save_dir=str(tmp_path), name="b",
                             buffers_to_record=2, save_raw=False,
                             save_processed=True, save_as_32bit_float=True,
                             save_meta=False)
    eng.start_recording(params)
    eng.run()
    procs = glob.glob(str(tmp_path / "*_processed_float32_*.raw"))
    assert len(procs) == 1, glob.glob(str(tmp_path / "*"))
    data = np.fromfile(procs[0], dtype=np.float32)
    assert data.size == 2 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    assert np.isfinite(data).all()


def test_dispatch_chunk_matches_per_buffer():
    """Throughput mode (dispatch_chunk>1, make_scan_step) produces the same
    stream as per-buffer dispatch -- including FPN state threading and a
    partial tail chunk -- and the same decimated fetch cadence."""
    cfg = dataclasses.replace(CFG, fpn_mode=FpnMode.ONCE)

    def run(chunk):
        got = []
        model = FdOctModel(ACQ, cfg,
                           resample_coeffs=(0.0, ACQ.samples_per_line - 1.0,
                                            0.0, 0.0))
        source = SyntheticSource(ACQ, n_buffers=7)  # 7 % 3 != 0: tail chunk
        eng = StreamingEngine(model, source, stream_to_host=True,
                              dispatch_chunk=chunk,
                              on_processed=lambda buf, nr: got.append(
                                  (buf.copy(), nr)))
        n = eng.run()
        return n, got

    n1, per_buffer = run(1)
    n3, chunked = run(3)
    assert n1 == n3 == 7
    assert len(per_buffer) == len(chunked) == 7
    for (a, na), (b, nb) in zip(per_buffer, chunked):
        assert na == nb
        np.testing.assert_array_equal(a, b)


def test_stop_after_record_stops_stream(tmp_path):
    """REC_STOP semantics (octprozapp.cpp:424-446): the stream auto-stops
    once the recording completes."""
    eng = make_engine(n_buffers=None)  # endless source
    eng.start_recording(RecordingParams(
        save_dir=str(tmp_path), name="stop", buffers_to_record=3,
        save_raw=True, save_meta=False, stop_after_record=True))
    n = eng.run(max_buffers=100)
    assert 3 <= n < 100
    assert glob.glob(os.path.join(str(tmp_path), "*stop_raw*.raw"))


def test_recording_copies_settings_file(tmp_path):
    """The reference's recording metadata is a copy of settings.ini
    (octprozapp.cpp:295-298)."""
    ini = tmp_path / "session.ini"
    ini.write_text("[processing]\nbitshift = 1\n")
    eng = make_engine(n_buffers=3)
    eng.start_recording(RecordingParams(
        save_dir=str(tmp_path), name="meta", buffers_to_record=2,
        save_raw=True, save_meta=True, settings_file=str(ini)))
    eng.run()
    copies = glob.glob(os.path.join(str(tmp_path), "*meta_settings.ini"))
    assert copies and "bitshift" in open(copies[0]).read()


def test_dispatch_chunk_batch_strategy_matches_scan(kernel_interpret):
    """chunk_strategy='auto' upgrades the scan chunk to one fold step over
    the stack (bench 'mega') once FPN is determined; the streamed output
    must match the scan strategy exactly."""
    cfg = dataclasses.replace(CFG, fpn_mode=FpnMode.ONCE, resampling=True,
                              interpolation=Interpolation.CUBIC,
                              dispersion=True, fft_via_matmul=True,
                              compute_dtype="bfloat16")

    def run(strategy):
        got = []
        model = FdOctModel(ACQ, cfg,
                           resample_coeffs=(0.0, ACQ.samples_per_line - 1.0,
                                            0.0, 0.0),
                           dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
        source = SyntheticSource(ACQ, n_buffers=8)
        eng = StreamingEngine(model, source, stream_to_host=True,
                              dispatch_chunk=3, chunk_strategy=strategy,
                              on_processed=lambda buf, nr: got.append(
                                  (buf.copy(), nr)))
        n = eng.run()
        return n, got

    n_s, scan = run("scan")
    n_b, auto = run("auto")
    assert n_s == n_b == 8
    assert len(scan) == len(auto) == 8
    for (a, na), (b, nb) in zip(scan, auto):
        assert na == nb
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), atol=1, rtol=0)


def test_process_chunk_batch_requires_fused_config():
    model = FdOctModel(ACQ, CFG,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0,
                                        0.0, 0.0))
    raw = np.zeros((2,) + ACQ.buffer_shape, np.uint16)
    with pytest.raises(ValueError, match="strategy='batch'"):
        model.process_chunk(raw, strategy="batch")
    with pytest.raises(ValueError, match="strategy"):
        model.process_chunk(raw, strategy="bogus")


def test_scheduled_series_honors_stop_after_record_only_at_the_end(tmp_path):
    """stop_after_record in the params of a scheduled series must not kill
    the stream after recording 1; it stops the stream after the FINAL
    recording of the series."""
    eng = make_engine(n_buffers=None)  # endless source
    params = RecordingParams(save_dir=str(tmp_path), name="series",
                             buffers_to_record=1, save_raw=True,
                             save_meta=False, stop_after_record=True)
    eng.schedule_recordings(params, interval_s=0.0, total=3)
    n = eng.run(max_buffers=200)
    raws = glob.glob(str(tmp_path / "*series_raw*.raw"))
    assert len(raws) == 3          # all three recordings happened
    assert n < 200                 # ... and the stream then auto-stopped
    assert eng.scheduler.done == 3


def test_recording_screenshots_render_on_cpu(tmp_path, monkeypatch):
    """The screenshot raycast must be pinned to the CPU backend: the
    display path must not contend with the processing stream on the card
    (same rule as the live viewer, glwindow3d.cpp:316-323)."""
    import octproz_tpu.viz as viz
    from octproz_tpu.viz.render import cpu_device

    seen = []
    real = viz.render_volume

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(viz, "render_volume", spy)
    eng = make_engine(n_buffers=4, stream_to_host=True)
    eng.start_recording(RecordingParams(
        save_dir=str(tmp_path), name="shot", buffers_to_record=1,
        save_raw=False, save_processed=True, save_meta=False,
        save_screenshots=True))
    eng.run()
    assert seen and all(d is not None and d == cpu_device() for d in seen)
    assert glob.glob(str(tmp_path / "*_volume.png"))


def test_dequantize_uses_code_max_not_container_max():
    import jax.numpy as jnp

    from octproz_tpu.ops.quantize import code_max, dequantize, quantize

    x = np.linspace(0, 1, 9, dtype=np.float32)
    codes = np.asarray(quantize(jnp.asarray(x), 12))
    assert codes.dtype == np.uint16 and codes.max() == 4095
    back = dequantize(codes, 12)
    np.testing.assert_allclose(back, x, atol=1e-3)  # NOT 16x dark
    assert code_max(12) == 4095.0 and code_max(16) == 65535.0


def test_assembled_volume_is_full_scale_at_12_bit(tmp_path):
    """The VolumeAssembler receives [0,1]-normalized data for 12-bit
    streams (normalizing by the uint16 container max made it 16x dark)."""
    from octproz_tpu.io.volume import VolumeAssembler

    eng = make_engine(n_buffers=2, stream_to_host=True)
    eng.assembler = VolumeAssembler(ACQ)
    eng.run()
    vol = eng.assembler.volume
    assert vol.max() > 0.2  # the synthetic reflector peaks near full scale


def test_quantized_recording_without_streaming(tmp_path):
    """save_processed (quantized) must record and auto-stop even with
    stream_to_host=False: recording forces the fetch like the reference
    forcing streaming on (octprozapp.cpp:408-416)."""
    eng = make_engine(n_buffers=None, stream_to_host=False)
    eng.start_recording(RecordingParams(
        save_dir=str(tmp_path), name="noq", buffers_to_record=2,
        save_raw=False, save_processed=True, save_meta=False,
        stop_after_record=True))
    n = eng.run(max_buffers=50)
    assert n < 50
    assert glob.glob(str(tmp_path / "*noq_processed*.raw"))


def test_float_recording_keeps_quantized_extension_stream(tmp_path):
    """During float32 recording the recorder gets un-quantized floats while
    extensions keep receiving the QUANTIZED, skip-decimated stream (the
    reference's two separate streams, cuda_code.cu:1595-1604)."""
    eng = make_engine(n_buffers=6, stream_to_host=True, streaming_skip=1)
    ext = CollectingExtension()
    eng.extensions.add(ext)
    ext.activate()
    eng.start_recording(RecordingParams(
        save_dir=str(tmp_path), name="both", buffers_to_record=6,
        save_raw=False, save_processed=True, save_as_32bit_float=True,
        save_meta=False))
    eng.run()
    f = glob.glob(str(tmp_path / "*float32*.raw"))
    assert f and np.fromfile(f[0], np.float32).size == \
        6 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    # extensions saw only integer codes, at exactly the decimated rate
    # (6 buffers, skip=1 -> every 2nd)
    assert len(ext.processed_calls) == 3
    for buf, bits, nr in ext.processed_calls:
        assert np.issubdtype(np.asarray(buf).dtype, np.integer)


def test_extension_activated_mid_stream_gets_raw_data():
    eng = make_engine(n_buffers=8, stream_to_host=True)
    ext = CollectingExtension()
    ext.deactivate()
    eng.extensions.add(ext)

    seen_before = []

    def activate_late(host, nr):
        if len(seen_before) == 2:
            ext.activate()
        seen_before.append(nr)

    eng.on_processed = activate_late
    eng.run()
    assert ext.raw_calls, "raw fan-out never started after mid-stream activation"


def test_recording_started_mid_stream_excludes_in_flight_quantized(tmp_path):
    """Recording is an ENQUEUE-time decision: quantized buffers already in
    flight when a float32 recording starts must not be recorded (they would
    consume slots with pre-start data AND mix uint16 codes into the float
    file)."""
    eng = make_engine(n_buffers=12, stream_to_host=True, max_in_flight=4)
    started = []

    def cb(host, nr):
        if not started:
            started.append(1)
            eng.start_recording(RecordingParams(
                save_dir=str(tmp_path), name="mid", buffers_to_record=3,
                save_raw=False, save_processed=True,
                save_as_32bit_float=True, save_meta=False))

    eng.on_processed = cb
    eng.run()
    f = glob.glob(str(tmp_path / "*float32*.raw"))
    assert f
    data = np.fromfile(f[0], np.float32)
    assert data.size == 3 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    # float magnitudes are O(1) (unclamped); mixed-in uint16 codes would
    # reach the 4095 full scale
    assert np.isfinite(data).all() and data.max() < 10.0


def test_upload_prefetch_matches_inline_uploads():
    """The pipelined-H2D feeder (the async-DMA analog) must
    be a pure performance transform: identical processed output, in order,
    with and without it — per-buffer AND device-stacked chunk dispatch."""
    def collect(**kw):
        ext = CollectingExtension()
        exts = ExtensionManager()
        exts.add(ext)
        ext.activate()
        eng = make_engine(n_buffers=5, extensions=exts, stream_to_host=True,
                          **kw)
        assert eng.run() == 5
        return [c[0] for c in ext.processed_calls], [c[2] for c in ext.processed_calls]

    base, base_nr = collect(upload_prefetch=False)
    fed, fed_nr = collect(upload_prefetch=True)
    chunked, chunked_nr = collect(upload_prefetch=True, dispatch_chunk=2)
    assert base_nr == fed_nr == chunked_nr
    for a, b, c in zip(base, fed, chunked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_upload_feeder_stages_device_arrays():
    """With upload_prefetch the step must receive an ALREADY-uploaded
    device array (no inline H2D on the loop thread)."""
    import jax

    model = FdOctModel(ACQ, CFG,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    seen = []
    orig = model.process_buffer

    def spy(raw):
        seen.append(isinstance(raw, jax.Array))
        return orig(raw)

    model.process_buffer = spy
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=3),
                          upload_prefetch=True)
    assert eng.run() == 3
    assert seen == [True, True, True]


def test_upload_feeder_propagates_source_error():
    class Boom(Exception):
        pass

    class BadSource:
        def buffers(self):
            yield SyntheticSource(ACQ, n_buffers=1).read_buffer(0)
            raise Boom("acquisition died")

    model = FdOctModel(ACQ, CFG,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    eng = StreamingEngine(model, BadSource(), upload_prefetch=True)
    with pytest.raises(Boom):
        eng.run()


def test_packed12_wire_format_matches_uint16_wire():
    """wire_format='packed12': the source yields packed wire bytes
    (1.5 B/sample), the upload crosses the link packed and is unpacked ON
    DEVICE — output must be bit-identical to the uint16 container wire
    (the UINT12_PACKED capability the reference enumerates but never
    implements, octalgorithmparameters.h:69)."""
    from octproz_tpu import native

    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16)
            for _ in range(3)]

    class U16Source:
        def buffers(self):
            yield from bufs

    class PackedSource:
        def buffers(self):
            for b in bufs:
                yield native.pack_uint12(b.reshape(-1))

    def collect(source, **kw):
        ext = CollectingExtension()
        exts = ExtensionManager()
        exts.add(ext)
        ext.activate()
        model = FdOctModel(ACQ, CFG,
                           resample_coeffs=(0.0, ACQ.samples_per_line - 1.0,
                                            0.0, 0.0))
        eng = StreamingEngine(model, source(), extensions=exts,
                              stream_to_host=True, **kw)
        assert eng.run() == 3
        return [c[0] for c in ext.processed_calls]

    base = collect(U16Source)
    packed = collect(PackedSource, wire_format="packed12")
    packed_inline = collect(PackedSource, wire_format="packed12",
                            upload_prefetch=False)
    packed_chunked = collect(PackedSource, wire_format="packed12",
                             dispatch_chunk=3)
    for a, b, c, d in zip(base, packed, packed_inline, packed_chunked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)


def test_packed12_raw_fanout_is_unpacked():
    """Raw-data extensions must see SAMPLE-valued arrays under the
    packed-12 wire, not pack bytes (SignalMonitor statistics on
    pack bytes were silently wrong); the raw recorder keeps the wire bytes
    verbatim.  The engine's wire metrics must also report actual link
    bytes (1.5 B/sample)."""
    from octproz_tpu import native

    rng = np.random.default_rng(6)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16)
            for _ in range(2)]

    class RawCollector(Extension):
        name = "rawcollector"
        wants_raw_data = True

        def __init__(self):
            super().__init__()
            self.buffers = []

        def raw_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv,
                              nr):
            self.buffers.append(np.array(buffer))

    class PackedSource:
        def buffers(self):
            for b in bufs:
                yield native.pack_uint12(b.reshape(-1))

    ext = RawCollector()
    exts = ExtensionManager()
    exts.add(ext)
    ext.activate()
    model = FdOctModel(ACQ, CFG,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0,
                                        0.0, 0.0))
    eng = StreamingEngine(model, PackedSource(), extensions=exts,
                          wire_format="packed12")
    assert eng.meter._wire_bytes == ACQ.samples_per_buffer * 3 // 2
    assert eng.run() == 2
    assert len(ext.buffers) == 2
    for got, want in zip(ext.buffers, bufs):
        assert got.shape == ACQ.buffer_shape
        np.testing.assert_array_equal(got, want)


def test_stop_interrupts_run_while_upload_is_wedged():
    """engine.stop() must end the run loop even when the upload thread is
    stuck inside device_put (a transfer that never returns): feeder.get()
    honors the engine's stop event between polls."""
    import threading
    import time as _time

    model = FdOctModel(ACQ, CFG,
                       resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    release = threading.Event()
    orig = model.put_buffer

    def wedged_put(raw):
        release.wait(timeout=30.0)   # simulated hung transfer
        return orig(raw)

    model.put_buffer = wedged_put
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=4),
                          upload_prefetch=True)
    threading.Timer(0.3, eng.stop).start()
    t0 = _time.monotonic()
    n = eng.run()
    elapsed = _time.monotonic() - t0
    release.set()                    # unblock the feeder thread for cleanup
    assert n == 0
    assert elapsed < 5.0, f"stop() took {elapsed:.1f}s to take effect"
