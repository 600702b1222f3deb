"""Golden regression: the full pipeline on a fixed deterministic input must
keep producing the same B-scans.

The reference's quality assurance is comparison against a recorded dataset
(SURVEY.md section 4); without network access to the figshare volume, we
freeze our own golden: a deterministic synthetic interferogram through the
full benchmark chain, with exact probe pixels, summary statistics, a
quantized-volume hash, and per-precision-rung bounds against the float64
oracle.  Any numerics change (intended or not) shows up here first; update
the constants deliberately when the change is intended and note why.

Tolerance discipline (round-4 tightening): probe pixels are pinned at
1e-4 absolute — a 0.5 %-of-full-scale perturbation (5e-3) fails by ~50x —
and the 16-bit-quantized volume is pinned by SHA-256 (any 1-code change
flips it).  The hashes and probes are CPU-XLA-specific by design: a jax
upgrade that changes float32 GEMM accumulation order is a deliberate
update-the-constants event, not noise.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

from octproz_tpu import AcqParams, FpnMode, Interpolation, ProcConfig
from octproz_tpu import curves as curves_mod, pipeline
from octproz_tpu.ops import quantize
from octproz_tpu.params import WindowType


ACQ = AcqParams(samples_per_line=256, ascans_per_bscan=32, bscans_per_buffer=4,
                buffers_per_volume=1, bit_depth=12)


def _golden_raw():
    """Deterministic multi-reflector interferogram with per-line variation."""
    n = ACQ.samples_per_line
    x = np.arange(n)
    lines = []
    for j in range(ACQ.ascans_per_buffer):
        s = (1800.0
             + 600.0 * np.cos(2 * np.pi * 30 * x / n + 0.01 * j)
             + 300.0 * np.cos(2 * np.pi * 70 * x / n)
             + 100.0 * np.cos(2 * np.pi * (5 + 0.02 * j) * x / n))
        lines.append(s)
    raw = np.stack(lines).reshape(ACQ.buffer_shape)
    return np.clip(raw, 0, 4095).astype(np.uint16)


CFG = ProcConfig(bitshift=False, background_removal=True,
                 rolling_average_window=32, resampling=True,
                 interpolation=Interpolation.CUBIC, windowing=True,
                 dispersion=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=4,
                 log_scaling=True, fft_via_matmul=True)
KW = dict(resample_coeffs=(0.0, 255.0, 8.0, -3.0),
          dispersion_coeffs=(0.0, 0.0, 6.0, 0.0),
          window_type=WindowType.HANNING)

# Eight probe pixels scattered over (bscan, ascan, depth), away from the
# FPN-determination chaos (FpnMode.ONCE's mean line is deterministic on
# this fixed input).  Frozen 2026-08-21 on CPU XLA (jax in-image version).
PROBES = [(0, 10, 102), (2, 5, 105), (2, 11, 111), (0, 25, 114),
          (3, 14, 8), (0, 29, 68), (1, 14, 37), (0, 8, 35)]

# Re-frozen 2026-08-21 after the FPN tie-banded argmin change
# (ops/fpn.py:_banded_argmin): the golden input has
# near-tied segment variances by construction, so the stabilized selection
# legitimately picks different (lowest-index) tied segments.
GOLDEN = {
    # fold=True: the planar full-fold GEMM (the exported defaults' path)
    True: dict(mean=-0.095318, std=0.328408,
               vals=[-0.355045, -0.255469, -0.441004, -0.268356,
                     0.682220, -0.237136, 0.103938, -0.075919],
               sha256="6655835363d2d668488f82fe72a707e6"
                      "45aee46edc46de33aea1a0d87c05b31f"),
    # fold=False: jnp.fft path (complex-capable backends)
    False: dict(mean=-0.095319, std=0.328409,
                vals=[-0.355058, -0.255454, -0.441029, -0.268355,
                      0.682220, -0.237078, 0.103934, -0.075910],
                sha256="c2949d9e538bf30e216a97adc0295b94"
                       "b58d6ec63ebdc8d9fe785500240540eb"),
}


@pytest.mark.parametrize("fold", [False, True])
def test_golden_pipeline(fold):
    cfg = dataclasses.replace(CFG, fft_via_matmul=fold)
    curves = curves_mod.make_curves(ACQ, cfg, **KW)
    state = pipeline.initial_fpn_state(ACQ)
    out, _ = pipeline.process_buffer(_golden_raw(), curves, state, ACQ, cfg)
    out = np.asarray(out)
    g = GOLDEN[fold]

    assert out.shape == (4, 32, 128)
    line = out[2, 16]
    assert int(np.argmax(line[10:])) + 10 == 30  # strongest reflector bin
    np.testing.assert_allclose(out.mean(), g["mean"], atol=1e-5)
    np.testing.assert_allclose(out.std(), g["std"], atol=1e-5)
    np.testing.assert_allclose([out[p] for p in PROBES], g["vals"], atol=1e-4)


@pytest.mark.parametrize("fold", [False, True])
def test_golden_quantized_volume_hash(fold):
    """Exact pin of the integer output stream: the 16-bit floatToOutput
    codes of the golden volume (cuda_code.cu:943-967 analog) are frozen by
    hash — a single-code numerics drift anywhere in the chain fails."""
    cfg = dataclasses.replace(CFG, fft_via_matmul=fold)
    curves = curves_mod.make_curves(ACQ, cfg, **KW)
    state = pipeline.initial_fpn_state(ACQ)
    out, _ = pipeline.process_buffer(_golden_raw(), curves, state, ACQ, cfg)
    q = np.asarray(quantize.quantize(np.asarray(out), 16))
    assert q.dtype == np.uint16
    assert hashlib.sha256(q.tobytes()).hexdigest() == GOLDEN[fold]["sha256"]


def test_golden_rung_probes_vs_float64_oracle():
    """Per-rung probe-pixel bounds vs the float64 oracle on display-clipped
    ([0,1]) output, each at the grade its ladder rung actually delivers
    (docs/performance.md): unclipped log output amplifies GEMM error
    without bound in noise-floor bins, so the display range is the honest
    comparison domain (same convention as the ladder PSNR tests).  FPN off
    (argmin chaos excluded, CLAUDE.md).  Measured on CPU XLA 2026-08-21:
    default 2.5e-6, high 2.1e-4, highest 1.3e-6, bf16 0.17 (bf16 is the
    24.6 dB throughput rung — probe-level pins are meaningless there, so
    it gets a PSNR floor instead)."""
    import oracle

    cfg = dataclasses.replace(CFG, fpn_mode=FpnMode.OFF,
                              background_removal=False)
    cv = curves_mod.make_curves(ACQ, cfg, **KW)
    raw = _golden_raw()
    want, _ = oracle.full_pipeline(
        raw, ACQ.bit_depth,
        resample_curve=np.asarray(cv.resample_curve),
        interpolation="cubic",
        window=np.asarray(cv.window), phase=np.asarray(cv.phase),
        log_scaling=True, gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
        addend=cfg.addend, coeff=cfg.multiplicator)
    want = np.clip(np.asarray(want, np.float64), 0, 1)
    state = pipeline.initial_fpn_state(ACQ)

    def run(c):
        got, _ = pipeline.process_buffer(raw, cv, state, ACQ, c)
        return np.clip(np.asarray(got, np.float64), 0, 1)

    def max_probe_err(c):
        g = run(c)
        return max(abs(g[p] - want[p]) for p in PROBES)

    assert max_probe_err(cfg) < 2e-5                       # f32 default
    assert max_probe_err(
        dataclasses.replace(cfg, matmul_precision="high")) < 1e-3
    assert max_probe_err(
        dataclasses.replace(cfg, matmul_precision="highest")) < 1e-5
    bf16 = run(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    psnr = 10 * np.log10(1.0 / max(float(np.mean((bf16 - want) ** 2)), 1e-30))
    # 18.7 dB measured on this (deliberately busy) input; the 24.6 dB
    # headline figure is on the standard golden-pair interferogram
    assert psnr > 15.0, f"bf16 rung PSNR {psnr:.1f} dB"
