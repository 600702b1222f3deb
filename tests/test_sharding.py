"""Sharded step vs single-device pipeline parity on an 8-device CPU mesh.

The conftest defaults JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=8, so every mesh shape here runs with
real SPMD partitioning (psum over segment statistics, boundary exchanges for
the fast-axis ops) without accelerator hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from octproz_tpu import curves as curves_mod
from octproz_tpu import pipeline
from octproz_tpu.params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType
from octproz_tpu.parallel import make_mesh, make_sharded_step


ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=64,
                bscans_per_buffer=16, bit_depth=12)


def _raw(rng, acq=ACQ):
    return rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16)


def _curves(cfg, acq=ACQ):
    return curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 14.0, -9.0),
        dispersion_coeffs=(0.0, 2.0, -13.0, 7.0),
        window_type=WindowType.HANNING,
    )


def _run_both(rng, cfg, mesh_shape, acq=ACQ):
    raw = _raw(rng, acq)
    curves = _curves(cfg, acq)
    state0 = pipeline.initial_fpn_state(acq)

    ref_step = pipeline.make_step(acq, cfg)
    ref, ref_state = ref_step(jnp.asarray(raw), curves, state0)

    mesh = make_mesh(*mesh_shape)
    step = make_sharded_step(acq, cfg, mesh)
    got, got_state = step(jnp.asarray(raw), curves, state0)
    return np.asarray(ref), np.asarray(got), ref_state, got_state


FULL_CFG = ProcConfig(
    bitshift=True,
    background_removal=True, rolling_average_window=16,
    resampling=True, interpolation=Interpolation.CUBIC,
    windowing=True, dispersion=True,
    fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
    log_scaling=True,
    bscan_flip=True, sinusoidal_correction=True,
    post_background_removal=True,
)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 8), (4, 2), (2, 2)])
def test_full_chain_parity(rng, mesh_shape):
    ref, got, _, _ = _run_both(rng, FULL_CFG, mesh_shape)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fpn_mode", [FpnMode.ONCE, FpnMode.CONTINUOUS])
def test_fpn_state_parity(rng, fpn_mode):
    """The psum-combined minimum-variance mean line matches the local one."""
    cfg = ProcConfig(resampling=True, windowing=True, dispersion=True,
                     fpn_mode=fpn_mode, bscans_for_noise=3)
    ref, got, ref_state, got_state = _run_both(rng, cfg, (4, 2))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got_state.mean_line),
                               np.asarray(ref_state.mean_line),
                               rtol=1e-4, atol=1e-5)
    assert bool(got_state.determined)


def test_fpn_once_reuses_mean_line(rng):
    """Second buffer must reuse the first buffer's mean line (ONCE mode),
    exactly like the single-device carried state (cuda_code.cu:1521-1524)."""
    cfg = ProcConfig(resampling=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=2)
    curves = _curves(cfg)
    mesh = make_mesh(4, 2)
    step = make_sharded_step(ACQ, cfg, mesh)

    state = pipeline.initial_fpn_state(ACQ)
    _, state1 = step(jnp.asarray(_raw(rng)), curves, state)
    out2, state2 = step(jnp.asarray(_raw(rng)), curves, state1)

    np.testing.assert_array_equal(np.asarray(state1.mean_line),
                                  np.asarray(state2.mean_line))

    # replay buffer 2 on the single-device path with the same carried
    # state: the post-determination sharded output must match it
    ref_step = pipeline.make_step(ACQ, cfg)
    raw2 = _raw(np.random.default_rng(99))
    ref_out, _ = ref_step(jnp.asarray(raw2), curves, state1)
    got_out, _ = step(jnp.asarray(raw2), curves, state1)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               rtol=2e-4, atol=2e-4)


def test_output_sharding_layout(rng):
    cfg = ProcConfig(resampling=True, windowing=True, log_scaling=True)
    mesh = make_mesh(8, 1)
    step = make_sharded_step(ACQ, cfg, mesh)
    out, _ = step(jnp.asarray(_raw(rng)), _curves(cfg),
                  pipeline.initial_fpn_state(ACQ))
    assert out.shape == ACQ.processed_buffer_shape
    # block-sharded over bscan axis
    assert len(out.sharding.device_set) == 8


def test_uneven_noise_bscans_span_shards(rng):
    """bscans_for_noise smaller than one shard's block still reduces globally."""
    cfg = ProcConfig(resampling=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=1)
    ref, got, _, _ = _run_both(rng, cfg, (8, 1))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_fdoct_model_with_mesh_matches_single_device():
    import jax

    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.parallel import make_mesh

    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=4, log_scaling=True)
    kw = dict(resample_coeffs=(0.0, 63.0, 4.0, 0.0),
              dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
    raw = np.random.default_rng(5).integers(
        0, 4095, size=acq.buffer_shape).astype(np.uint16)

    single = FdOctModel(acq, cfg, **kw)
    sharded = FdOctModel(acq, cfg, mesh=make_mesh(4, 2, devices=jax.devices()), **kw)
    a = np.asarray(single.process_buffer(raw))
    b = np.asarray(sharded.process_buffer(raw))
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_streaming_engine_with_sharded_model():
    import jax

    from octproz_tpu.io.source import SyntheticSource
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.parallel import make_mesh
    from octproz_tpu.runtime import StreamingEngine

    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True)
    model = FdOctModel(acq, cfg, mesh=make_mesh(8, 1, devices=jax.devices()),
                       resample_coeffs=(0.0, 63.0, 0.0, 0.0))
    got = []
    eng = StreamingEngine(model, SyntheticSource(acq, n_buffers=4),
                          stream_to_host=True,
                          on_processed=lambda b, nr: got.append(b.shape))
    assert eng.run() == 4
    assert got and got[0] == acq.processed_buffer_shape


@pytest.mark.parametrize("has_post", [False, True])
def test_output_dtype_bf16_parity(rng, has_post, kernel_interpret):
    """output_dtype='bfloat16' on the mesh: both lax.cond branches must
    agree on dtype (FPN ONCE + fused path crashed at trace time before),
    post-stage arithmetic stays float32, and the result matches the
    single-device pipeline bit-for-bit."""
    import dataclasses

    cfg = dataclasses.replace(
        FULL_CFG, output_dtype="bfloat16",
        # the crash case: the depth/scale kernel + FPN ONCE puts the bf16
        # store decision inside a lax.cond whose branches must agree on dtype
        fft_via_matmul=True, compute_dtype="bfloat16",
        background_removal=False,
        bscan_flip=has_post, sinusoidal_correction=has_post,
        post_background_removal=False)
    ref, got, ref_state, got_state = _run_both(rng, cfg, (4, 2))
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)
    # steady state (determined=True) takes the FUSED branch
    raw2 = _raw(rng)
    curves = _curves(cfg)
    ref2, _ = pipeline.make_step(ACQ, cfg)(jnp.asarray(raw2), curves,
                                           ref_state)
    got2, _ = make_sharded_step(ACQ, cfg, make_mesh(4, 2))(
        jnp.asarray(raw2), curves, got_state)
    assert np.asarray(got2).dtype == np.asarray(ref2).dtype
    np.testing.assert_allclose(np.asarray(got2, np.float32),
                               np.asarray(ref2, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_sharded_fpn_rejects_too_few_lines(rng):
    """Fewer noise lines than segments must raise (ops/fpn.py contract),
    not silently zero the mean line via empty-segment argmin."""
    import dataclasses

    acq = AcqParams(samples_per_line=64, ascans_per_bscan=4,
                    bscans_per_buffer=8, bit_depth=12)
    cfg = dataclasses.replace(FULL_CFG, bscans_for_noise=1,
                              background_removal=False,
                              bscan_flip=False, sinusoidal_correction=False,
                              post_background_removal=False)
    raw = _raw(rng, acq)
    curves = _curves(cfg, acq)
    mesh = make_mesh(4, 1)
    step = make_sharded_step(acq, cfg, mesh)
    with pytest.raises(ValueError, match="at least"):
        step(jnp.asarray(raw), curves, pipeline.initial_fpn_state(acq))


def test_packed12_wire_on_mesh_matches_uint16(rng):
    """Packed-12 wire on a device mesh: the wire
    buffer ships sharded on B-scan boundaries, unpacks shard-locally
    (ops.convert.unpack_uint12_rows), and the processed output is
    bit-identical to the uint16-container mesh path."""
    import jax

    from octproz_tpu import native
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.parallel import make_mesh

    acq = AcqParams(samples_per_line=256, ascans_per_bscan=8,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=4, log_scaling=True)
    kw = dict(resample_coeffs=(0.0, 255.0, 6.0, 0.0),
              dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
    raw = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)
    packed = native.pack_uint12(raw.reshape(-1))

    model = FdOctModel(acq, cfg, mesh=make_mesh(4, 2, devices=jax.devices()),
                       **kw)
    # the committed unpacked buffer equals the raw samples, and carries the
    # mesh's buffer sharding (so the step consumes it with no reshard)
    dev = model.put_packed_buffer(packed)
    np.testing.assert_array_equal(np.asarray(dev), raw)
    assert len(dev.sharding.device_set) == 8

    a = np.asarray(model.process_buffer(model.put_buffer(raw)))
    model.redetermine_fpn()
    b = np.asarray(model.process_buffer(model.put_packed_buffer(packed)))
    np.testing.assert_array_equal(a, b)


def test_streaming_engine_packed12_on_mesh(rng):
    """The full engine path (upload feeder included) runs the packed wire
    against a sharded model."""
    import jax

    from octproz_tpu import native
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.parallel import make_mesh
    from octproz_tpu.runtime import StreamingEngine

    acq = AcqParams(samples_per_line=256, ascans_per_bscan=8,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True)
    bufs = [rng.integers(0, 4095, acq.buffer_shape).astype(np.uint16)
            for _ in range(3)]

    class PackedSource:
        def buffers(self):
            for b in bufs:
                yield native.pack_uint12(b.reshape(-1))

    model = FdOctModel(acq, cfg, mesh=make_mesh(8, 1, devices=jax.devices()),
                       resample_coeffs=(0.0, 255.0, 0.0, 0.0))
    got = []
    eng = StreamingEngine(model, PackedSource(), stream_to_host=True,
                          wire_format="packed12",
                          on_processed=lambda b, nr: got.append(np.array(b)))
    assert eng.run() == 3
    assert len(got) == 3 and got[0].shape == acq.processed_buffer_shape


def test_packed12_wire_on_mesh_nonaligned_line_length(rng):
    """B-scan-granular packed-wire fallback (review r5 #7): line lengths
    that are NOT 256-sample aligned (e.g. the figshare dataset's 1664)
    still ship packed on a mesh — the wire shards on B-scan axes only,
    unpacks shard-locally, and GSPMD reshards onto the full buffer spec.
    Exact parity vs the uint16 container path, A-scan-sharded mesh
    included."""
    import jax

    from octproz_tpu import native
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.parallel import make_mesh

    # 192 % 256 != 0, but a whole B-scan (4*192 = 768 samples) is aligned
    acq = AcqParams(samples_per_line=192, ascans_per_bscan=4,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True)
    kw = dict(resample_coeffs=(0.0, 191.0, 0.0, 0.0))
    raw = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)
    packed = native.pack_uint12(raw.reshape(-1))

    model = FdOctModel(acq, cfg, mesh=make_mesh(4, 2, devices=jax.devices()),
                       **kw)
    dev = model.put_packed_buffer(packed)
    np.testing.assert_array_equal(np.asarray(dev), raw)
    a = np.asarray(model.process_buffer(model.put_buffer(raw)))
    b = np.asarray(model.process_buffer(model.put_packed_buffer(packed)))
    np.testing.assert_array_equal(a, b)

    # a geometry aligned at NEITHER granularity is rejected loudly
    bad = AcqParams(samples_per_line=40, ascans_per_bscan=3,
                    bscans_per_buffer=8, bit_depth=12)
    bad_model = FdOctModel(bad, cfg, mesh=make_mesh(4, 1),
                           resample_coeffs=(0.0, 39.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="multiple of 256"):
        bad_model.put_packed_buffer(
            native.pack_uint12(np.zeros(bad.samples_per_buffer, np.uint16)))
