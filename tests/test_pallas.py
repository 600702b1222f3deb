"""Parity tests of the full-fold formulation (ops/fold.py) and the
depth/scale kernel (pallas/depth_scale.py) against the staged reference ops,
across flag combinations.

On the CPU the pipeline runs the plain XLA form of the fold; tests that take
the ``kernel_interpret`` fixture run the kernel in the Pallas interpreter
instead.  The fold only reassociates linear operations, so the numerics must
match the staged chain to float32 tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from octproz_tpu import AcqParams, Interpolation, ProcConfig, curves as curves_mod
from octproz_tpu import pipeline
from octproz_tpu.params import FpnMode, WindowType


ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=16, bscans_per_buffer=2,
                buffers_per_volume=1, bit_depth=12)


def _raw(rng, acq=ACQ):
    return rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)


def _compare(cfg, rng, acq=ACQ, atol=2e-2):
    """The staged prep_spectra against the folded prep operator applied in
    float64 numpy: decode -> lines @ build_prep_operator -> phasor."""
    from octproz_tpu.ops.fold import build_prep_operator

    kw = dict(resample_coeffs=(0.0, acq.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
              window_type=WindowType.HANNING)
    cv = curves_mod.make_curves(acq, cfg, **kw)
    raw = _raw(rng, acq)
    got = pipeline.prep_spectra(jnp.asarray(raw), cv, acq, cfg)
    x = raw.astype(np.float64)
    if cfg.bitshift:
        x = np.floor(x / 16)
    op = build_prep_operator(
        acq, cfg, np.asarray(cv.resample_matrix) if cfg.resampling else None,
        np.asarray(cv.window) if cfg.windowing else None)
    want = x @ op.astype(np.float64)
    if cfg.dispersion:
        want = want * np.asarray(cv.phase, np.complex128)
        assert jnp.iscomplexobj(got)
    else:
        assert not jnp.iscomplexobj(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("interp", [Interpolation.LINEAR, Interpolation.CUBIC,
                                    Interpolation.LANCZOS])
def test_fused_full_chain(interp, rng):
    cfg = ProcConfig(resampling=True, interpolation=interp, windowing=True,
                     dispersion=True, background_removal=True,
                     rolling_average_window=16)
    _compare(cfg, rng)


def test_fused_no_dispersion_returns_real(rng):
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=False)
    _compare(cfg, rng)


def test_fused_background_only(rng):
    cfg = ProcConfig(background_removal=True, rolling_average_window=8)
    _compare(cfg, rng)


def test_fused_window_only(rng):
    cfg = ProcConfig(windowing=True)
    _compare(cfg, rng)


def test_fused_bitshift(rng):
    cfg = ProcConfig(bitshift=True, resampling=True,
                     interpolation=Interpolation.LINEAR, windowing=True,
                     dispersion=True)
    _compare(cfg, rng)


def test_fused_odd_line_count(rng):
    # 24 lines per buffer
    acq = AcqParams(samples_per_line=128, ascans_per_bscan=12,
                    bscans_per_buffer=2, buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True)
    _compare(cfg, rng, acq=acq)


@pytest.mark.parametrize("dispersion", [True, False])
def test_depth_operator_full_fold(dispersion, rng):
    """fft_via_matmul: decode..IFFT..truncate as ONE complex GEMM must match
    the staged pipeline."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=dispersion,
                     background_removal=True, rolling_average_window=16,
                     fpn_mode=FpnMode.OFF, log_scaling=True)
    fold_cfg = dataclasses.replace(cfg, fft_via_matmul=True)
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
              window_type=WindowType.HANNING)
    c_base = curves_mod.make_curves(ACQ, cfg, **kw)
    c_fold = curves_mod.make_curves(ACQ, fold_cfg, **kw)
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    want, _ = pipeline.process_buffer(raw, c_base, state, ACQ, cfg)
    got, _ = pipeline.process_buffer(raw, c_fold, state, ACQ, fold_cfg)
    # final B-scan surface comparison (log scale amplifies tiny absolute
    # diffs at near-zero bins; compare on the clipped display range)
    w = np.clip(np.asarray(want), 0.0, 1.0)
    g = np.clip(np.asarray(got), 0.0, 1.0)
    psnr = 10 * np.log10(1.0 / max(np.mean((w - g) ** 2), 1e-30))
    assert psnr > 60.0, f"PSNR {psnr:.1f} dB"


def test_depth_operator_xla_backend_matches_pallas(rng, kernel_interpret):
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True)
    xla_cfg = dataclasses.replace(cfg, fold_backend="xla")
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    curves = curves_mod.make_curves(ACQ, cfg, **kw)
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    a, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    b, _ = pipeline.process_buffer(raw, curves, state, ACQ, xla_cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_depth_operator_bfloat16_psnr(rng):
    """compute_dtype=bfloat16 trades precision for MXU speed; characterize:
    the B-scan PSNR vs float32 must stay above 30 dB on the display range."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    curves = curves_mod.make_curves(ACQ, cfg, **kw)
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    a, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    b, _ = pipeline.process_buffer(raw, curves, state, ACQ, bf16)
    a = np.clip(np.asarray(a), 0, 1)
    b = np.clip(np.asarray(b), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-30))
    assert psnr > 30.0, f"bf16 PSNR {psnr:.1f} dB"


def test_depth_operator_fpn_once(rng):
    """Full fold composes with FPN carried state."""
    # bscans_for_noise=2 -> 32 noise lines / 9 segments, width 3: avoids the
    # degenerate width-1 case where a single-line segment has zero variance
    # and subtracts itself to exactly zero (-inf after log; the reference
    # behaves identically there)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=2, log_scaling=True, fft_via_matmul=True)
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    out, state = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    assert bool(state.determined)
    assert np.isfinite(np.asarray(out)).all()


def test_fused_full_pipeline_end_to_end(rng, kernel_interpret):
    """Whole process_buffer parity: the fold with the depth/scale kernel
    against the staged FFT pipeline."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True)
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 5.0, 0.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    fold_cfg = dataclasses.replace(cfg, fft_via_matmul=True)
    c_base = curves_mod.make_curves(ACQ, cfg, **kw)
    c_fold = curves_mod.make_curves(ACQ, fold_cfg, **kw)
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    want, _ = pipeline.process_buffer(raw, c_base, state, ACQ, cfg)
    got, _ = pipeline.process_buffer(raw, c_fold, state, ACQ, fold_cfg)
    w, g = np.asarray(want), np.asarray(got)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], atol=5e-3, rtol=1e-4)


def test_fused_scale_epilogue_matches_unfused(rng, kernel_interpret):
    """The depth/scale kernel (GEMM + FPN subtraction + log scale in one
    pass) must reproduce the plain XLA form, including the lax.cond between
    the FPN-determination buffer and the steady-state kernel."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=2, log_scaling=True,
                     fft_via_matmul=True, compute_dtype="bfloat16")
    unfused = dataclasses.replace(cfg, fold_backend="xla")
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    curves = curves_mod.make_curves(ACQ, cfg, **kw)
    sa = pipeline.initial_fpn_state(ACQ)
    sb = pipeline.initial_fpn_state(ACQ)
    for _ in range(3):  # buffer 0 determines FPN; buffers 1-2 hit the kernel
        raw = jnp.asarray(_raw(rng))
        a, sa = pipeline.process_buffer(raw, curves, sa, ACQ, cfg)
        b, sb = pipeline.process_buffer(raw, curves, sb, ACQ, unfused)
        an, bn = np.asarray(a), np.asarray(b)
        # a voxel -inf in one path but finite in the other is a real mismatch
        np.testing.assert_array_equal(np.isfinite(an), np.isfinite(bn))
        fin = np.isfinite(an)
        np.testing.assert_allclose(an[fin], bn[fin], atol=1e-4, rtol=1e-5)
    assert bool(sa.determined) and bool(sb.determined)
    np.testing.assert_allclose(np.asarray(sa.mean_line),
                               np.asarray(sb.mean_line), atol=1e-5)


def test_fused_scale_epilogue_fpn_off(rng, kernel_interpret):
    """With FPN off the kernel subtracts the zero initial mean line --
    identical output to the plain path, state untouched."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=False,
                     fft_via_matmul=True, matmul_precision="high")
    unfused = dataclasses.replace(cfg, fold_backend="xla")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    a, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    b, _ = pipeline.process_buffer(raw, curves, state, ACQ, unfused)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_matmul_precision_knob_plumbs_through(rng, precision):
    """matmul_precision traces through every GEMM path.  On the CPU
    "default" is exact float32; "high"/"highest" run the manual bf16 splits
    on EVERY backend (backend-independent numerics) and must agree to their
    ~2^-16 / ~2^-24 relative error bounds instead."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True,
                     matmul_precision=precision)
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    out, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    base = dataclasses.replace(cfg, matmul_precision="default")
    want, _ = pipeline.process_buffer(raw, curves, state, ACQ, base)
    # the knob must actually change the computation (split vs single pass)
    assert not np.array_equal(np.asarray(out), np.asarray(want)), \
        "precision knob is inert: split output identical to default"
    w = np.clip(np.asarray(want, np.float64), 0, 1)
    g = np.clip(np.asarray(out, np.float64), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((g - w) ** 2)), 1e-30))
    need = 60.0 if precision == "high" else 90.0
    assert psnr > need, f"{precision} PSNR {psnr:.1f} dB (need {need})"


def test_high_precision_fidelity_ladder(rng):
    """The bf16x3 "high" mode must recover (nearly) float32 fidelity: vs the
    exact-f32 CPU reference, "high" sits far above bf16-grade compute."""
    cfg = ProcConfig(bitshift=True, resampling=True,
                     interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.OFF, log_scaling=True,
                     fft_via_matmul=True)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    high = dataclasses.replace(cfg, matmul_precision="high")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    ref, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    ref = np.clip(np.asarray(ref, np.float64), 0, 1)

    def psnr(c):
        got, _ = pipeline.process_buffer(raw, curves, state, ACQ, c)
        g = np.clip(np.asarray(got, np.float64), 0, 1)
        return 10 * np.log10(1.0 / max(float(np.mean((g - ref) ** 2)), 1e-30))

    p_bf16, p_high = psnr(bf16), psnr(high)
    assert p_high > 60.0, f"high: {p_high:.1f} dB"
    assert p_high > p_bf16 + 15.0, (
        f"high ({p_high:.1f} dB) should clearly beat bf16 ({p_bf16:.1f} dB)")


def test_precision_ladder_vs_float64_oracle(rng):
    """Full fidelity ladder vs the float64 oracle with FPN OFF (the FPN
    minimum-variance argmin is a chaotic discrete choice: near-tied segment
    variances flip under ANY precision change, so it is excluded from the
    precision measurement): bf16-grade < high (3-pass) < highest (5-pass),
    with highest at true-f32 grade."""
    import oracle

    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True)
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
              window_type=WindowType.HANNING)
    cv = curves_mod.make_curves(ACQ, cfg, **kw)
    raw = _raw(rng)
    want, _ = oracle.full_pipeline(
        raw, ACQ.bit_depth,
        resample_curve=np.asarray(cv.resample_curve),
        interpolation="cubic",
        window=np.asarray(cv.window), phase=np.asarray(cv.phase),
        log_scaling=True, gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
        addend=cfg.addend, coeff=cfg.multiplicator)
    ref = np.clip(np.asarray(want, np.float64), 0, 1)
    state = pipeline.initial_fpn_state(ACQ)

    def psnr(c):
        got, _ = pipeline.process_buffer(jnp.asarray(raw), cv, state, ACQ, c)
        g = np.clip(np.asarray(got, np.float64), 0, 1)
        return 10 * np.log10(1.0 / max(float(np.mean((g - ref) ** 2)), 1e-30))

    p_bf16 = psnr(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    p_high = psnr(dataclasses.replace(cfg, matmul_precision="high"))
    p_highest = psnr(dataclasses.replace(cfg, matmul_precision="highest"))
    assert p_high > p_bf16 + 10.0, f"{p_bf16:.1f} -> {p_high:.1f}"
    assert p_highest > p_high + 10.0, f"{p_high:.1f} -> {p_highest:.1f}"
    assert p_highest > 85.0, f"highest: {p_highest:.1f} dB"


def test_precision_ladder_fpn_on(rng):
    """With the tie-banded FPN argmin (ops/fpn.py) the ladder's fidelity
    survives END-TO-END with FPN enabled: the segment selection no longer
    flips across precision rungs, so high/highest reach their oracle grades
    instead of saturating at segment-choice chaos."""
    import oracle

    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=2, log_scaling=True,
                     fft_via_matmul=True)
    kw = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
              window_type=WindowType.HANNING)
    cv = curves_mod.make_curves(ACQ, cfg, **kw)
    raw = _raw(rng)
    want, _ = oracle.full_pipeline(
        raw, ACQ.bit_depth,
        resample_curve=np.asarray(cv.resample_curve),
        interpolation="cubic",
        window=np.asarray(cv.window), phase=np.asarray(cv.phase),
        fpn_lines=ACQ.ascans_per_bscan * 2,
        log_scaling=True, gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
        addend=cfg.addend, coeff=cfg.multiplicator)
    ref = np.clip(np.asarray(want, np.float64), 0, 1)
    state = pipeline.initial_fpn_state(ACQ)

    def psnr(c):
        got, _ = pipeline.process_buffer(jnp.asarray(raw), cv, state, ACQ, c)
        g = np.clip(np.asarray(got, np.float64), 0, 1)
        return 10 * np.log10(1.0 / max(float(np.mean((g - ref) ** 2)), 1e-30))

    p_high = psnr(dataclasses.replace(cfg, matmul_precision="high"))
    p_highest = psnr(dataclasses.replace(cfg, matmul_precision="highest"))
    assert p_high > 55.0, f"high with FPN on: {p_high:.1f} dB"
    assert p_highest > 80.0, f"highest with FPN on: {p_highest:.1f} dB"


def test_high_precision_xla_backend_matches_pallas(rng, kernel_interpret):
    """"high" uses the same manual 3-product split in the kernel and in the
    plain form, so they agree to float32 accumulation-order tolerance."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True,
                     matmul_precision="high")
    xla_cfg = dataclasses.replace(cfg, fold_backend="xla")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    a, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    b, _ = pipeline.process_buffer(raw, curves, state, ACQ, xla_cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_high_precision_prep_kernel(rng):
    """The 3-product split also covers the staged matmul resampler."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True,
                     matmul_precision="high")
    _compare(cfg, rng, atol=5e-2)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_output_dtype_bfloat16(rng, backend, kernel_interpret):
    """output_dtype=bfloat16 narrows only the stored volume: dtype is bf16
    on every fold backend and the image stays within bf16 rounding of the
    float32 path (arithmetic itself is unchanged)."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True,
                     fold_backend=backend, output_dtype="bfloat16")
    f32 = dataclasses.replace(cfg, output_dtype="float32")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    got, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    want, _ = pipeline.process_buffer(raw, curves, state, ACQ, f32)
    assert got.dtype == jnp.bfloat16
    assert want.dtype == jnp.float32
    g = np.clip(np.asarray(got, np.float64), 0, 1)
    w = np.clip(np.asarray(want, np.float64), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((g - w) ** 2)), 1e-30))
    assert psnr > 40.0, f"bf16-output PSNR {psnr:.1f} dB"


def test_output_dtype_bfloat16_unfused_path(rng):
    """The non-matmul (FFT) pipeline honors output_dtype too."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True,
                     output_dtype="bfloat16")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    out, _ = pipeline.process_buffer(raw, curves,
                                     pipeline.initial_fpn_state(ACQ), ACQ, cfg)
    assert out.dtype == jnp.bfloat16


def test_fused_scale_batch_matches_scan(rng, kernel_interpret):
    """Batch formulation (FdOctModel.process_chunk "batch", bench "mega"):
    after FPN determination the mean line is constant, so a STACK of
    buffers can run as one fused_depth_scale call on the flattened line
    axis -- equal to threading the per-buffer step."""
    from octproz_tpu.pallas.depth_scale import fused_depth_scale

    cfg = ProcConfig(bitshift=True, resampling=True,
                     interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=2, log_scaling=True,
                     fft_via_matmul=True, matmul_precision="high")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    chunk = 3
    raw_stack = jnp.asarray(np.stack([_raw(rng) for _ in range(chunk)]))
    state = pipeline.initial_fpn_state(ACQ)
    _, state = pipeline.process_buffer(raw_stack[0], curves, state, ACQ, cfg)
    outs, st = [], state
    for i in range(chunk):
        o, st = pipeline.process_buffer(raw_stack[i], curves, st, ACQ, cfg)
        outs.append(np.asarray(o))
    mega = np.asarray(fused_depth_scale(raw_stack, curves.depth_op_re,
                                        curves.depth_op_im, state.mean_line,
                                        ACQ, cfg, interpret=True))
    assert mega.shape == (chunk,) + outs[0].shape
    for i in range(chunk):
        a, b = outs[i], mega[i]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5)


def test_invalid_config_values_raise():
    """fold_backend and the ladder/knob fields are validated at config
    construction (not at trace time)."""
    for bad in (dict(fold_backend="mega"), dict(compute_dtype="float16"),
                dict(matmul_precision="hi"), dict(output_dtype="int8")):
        with pytest.raises(ValueError):
            ProcConfig(**bad)


def test_output_dtype_bfloat16_postprocess_runs_float32(rng):
    """With post-stages enabled (flip/sinusoidal/post-bg) the bf16 narrowing
    happens AFTER postprocess_volume: the result equals the float32 path's
    post-processed volume narrowed once at the end."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True,
                     sinusoidal_correction=True, bscan_flip=True,
                     output_dtype="bfloat16")
    f32 = dataclasses.replace(cfg, output_dtype="float32")
    curves = curves_mod.make_curves(
        ACQ, cfg, resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    raw = jnp.asarray(_raw(rng))
    state = pipeline.initial_fpn_state(ACQ)
    got, _ = pipeline.process_buffer(raw, curves, state, ACQ, cfg)
    want, _ = pipeline.process_buffer(raw, curves, state, ACQ, f32)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want.astype(jnp.bfloat16),
                                             np.float32))


def test_bf16_compute_never_passes_native_high_precision():
    """compute_dtype='bfloat16' + matmul_precision='high'/'highest' must
    normalize to the single-pass bf16 rung (the split is meaningless on
    bf16 operands) and match plain bf16 output."""
    from octproz_tpu.ops.fold import effective_precision
    from octproz_tpu.pallas.depth_scale import fused_depth_scale

    assert effective_precision("bfloat16", "high") == "default"
    assert effective_precision("bfloat16", "highest") == "default"
    assert effective_precision("float32", "high") == "high"

    acq = AcqParams(samples_per_line=128, ascans_per_bscan=16,
                    bscans_per_buffer=2, bit_depth=12)
    curves_kw = dict(resample_coeffs=(0.0, 127.0, 5.0, 0.0),
                     window_type=WindowType.HANNING)
    raw = jnp.asarray(np.random.default_rng(3).integers(
        0, 4096, acq.buffer_shape).astype(np.uint16))
    outs = []
    for prec in ("default", "high"):
        cfg = ProcConfig(bitshift=True, resampling=True,
                         interpolation=Interpolation.CUBIC, windowing=True,
                         log_scaling=True, fft_via_matmul=True,
                         compute_dtype="bfloat16", matmul_precision=prec)
        curves = curves_mod.make_curves(acq, cfg, **curves_kw)
        mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
        outs.append(np.asarray(fused_depth_scale(
            raw, curves.depth_op_re, curves.depth_op_im, mean, acq, cfg,
            interpret=True)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_fused_depth_scale_odd_line_count():
    """Odd (non-power-of-two) line counts run through the masked edge block
    of the kernel and still match the XLA fold."""
    acq = AcqParams(samples_per_line=128, ascans_per_bscan=15,
                    bscans_per_buffer=7, bit_depth=12)  # 105 lines
    cfg = ProcConfig(bitshift=True, resampling=True,
                     interpolation=Interpolation.CUBIC, windowing=True,
                     log_scaling=True, fft_via_matmul=True,
                     compute_dtype="bfloat16")
    curves = curves_mod.make_curves(
        acq, cfg, resample_coeffs=(0.0, 127.0, 5.0, 0.0),
        window_type=WindowType.HANNING)
    raw = jnp.asarray(np.random.default_rng(5).integers(
        0, 4096, acq.buffer_shape).astype(np.uint16))
    mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
    from octproz_tpu.pallas.depth_scale import fused_depth_scale

    got = np.asarray(fused_depth_scale(raw, curves.depth_op_re,
                                       curves.depth_op_im, mean, acq, cfg,
                                       interpret=True))
    xcfg = dataclasses.replace(cfg, fold_backend="xla")
    from octproz_tpu.pipeline import initial_fpn_state, make_step

    want, _ = make_step(acq, xcfg)(raw, curves, initial_fpn_state(acq))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
