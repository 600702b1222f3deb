"""The depth/scale kernel (pallas/depth_scale.py): the kernel in the Pallas
interpreter against the plain XLA form, the wrapper's choice of
implementation per platform, the GPU route it names, and its padding.  The
compiled kernel is checked on the card by the ``gpu``-marked test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from octproz_tpu import curves as curves_mod
from octproz_tpu.ops import fold
from octproz_tpu.pallas import depth_scale as ds
from octproz_tpu.params import (AcqParams, FpnMode, Interpolation, ProcConfig,
                                WindowType)

RUNGS = {"bf16": dict(compute_dtype="bfloat16"),
         "high": dict(matmul_precision="high"),
         "highest": dict(matmul_precision="highest")}


def _setup(n, ascans, bscans, rung, seed=0, **cfg_kw):
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=ascans,
                    bscans_per_buffer=bscans, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                     log_scaling=True, fft_via_matmul=True,
                     **RUNGS[rung], **cfg_kw)
    cv = curves_mod.make_curves(
        acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
        window_type=WindowType.HANNING)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 4096, acq.buffer_shape).astype(np.uint16)
    if cfg.bitshift:
        raw = raw << 4
    return acq, cfg, cv, jnp.asarray(raw), rng


def _both(acq, cfg, cv, raw, mean):
    got = ds.fused_depth_scale(raw, cv.depth_op_re, cv.depth_op_im, mean,
                               acq, cfg, interpret=True)
    want = fold.depth_scale(raw, cv.depth_op_re, cv.depth_op_im, mean, acq,
                            cfg)
    return np.asarray(got, np.float32), np.asarray(want, np.float32)


@pytest.mark.parametrize("n,ascans,bscans,rung,out_dtype,fpn", [
    (1024, 16, 2, "bf16", "float32", False),
    (1024, 16, 2, "high", "float32", True),
    (1024, 15, 7, "bf16", "bfloat16", True),     # 105 lines: masked rows
    (1024, 13, 3, "highest", "float32", False),  # 39 lines
    (1664, 8, 2, "bf16", "float32", True),       # 832 columns: masked block
    (1664, 12, 2, "high", "bfloat16", False),
    (1664, 9, 3, "highest", "float32", True),    # 27 lines
    (128, 15, 7, "high", "float32", True),       # K and columns under a block
])
def test_kernel_matches_plain(n, ascans, bscans, rung, out_dtype, fpn):
    acq, cfg, cv, raw, rng = _setup(n, ascans, bscans, rung,
                                    output_dtype=out_dtype)
    half = acq.output_ascan_length
    mean = jnp.asarray(rng.normal(0, 50, (2, half)).astype(np.float32)
                       if fpn else np.zeros((2, half), np.float32))
    got, want = _both(acq, cfg, cv, raw, mean)
    assert got.shape == want.shape == acq.processed_buffer_shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # same products; only the summation order differs (bf16 output: one
    # bf16 rounding step of a value below 2)
    tol = 1e-2 if out_dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got[fin], want[fin], atol=tol, rtol=0)


@pytest.mark.parametrize("bitshift,log_scaling", [(True, True),
                                                  (False, False)])
def test_kernel_bitshift_and_lin_scaling(bitshift, log_scaling):
    acq, cfg, cv, raw, _ = _setup(256, 8, 3, "bf16", bitshift=bitshift)
    cfg = dataclasses.replace(cfg, log_scaling=log_scaling)
    mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
    got, want = _both(acq, cfg, cv, raw, mean)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("platform,kw,bit_depth,interpret,want", [
    ("gpu", RUNGS["bf16"], 12, False, "kernel"),
    ("gpu", RUNGS["high"], 12, False, "kernel"),
    ("gpu", RUNGS["highest"], 16, False, "kernel"),
    ("gpu", {}, 12, False, "plain"),                       # TF32 rung
    ("gpu", dict(RUNGS["bf16"], fold_backend="xla"), 12, False, "plain"),
    ("gpu", RUNGS["bf16"], 24, False, "plain"),            # 32-bit container
    ("cpu", RUNGS["bf16"], 12, False, "plain"),
    ("cpu", RUNGS["high"], 12, True, "interpret"),
    ("cpu", {}, 12, True, "plain"),
])
def test_implementation_per_platform(platform, kw, bit_depth, interpret,
                                     want):
    cfg = ProcConfig(fft_via_matmul=True, **kw)
    assert ds.implementation(platform, cfg, bit_depth, interpret) == want


def _pallas_calls(jaxpr):
    """Every pallas_call equation in ``jaxpr`` and its nested jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            found.append(eqn)
        for p in eqn.params.values():
            inner = getattr(p, "jaxpr", None)
            if inner is not None and hasattr(inner, "eqns"):
                found += _pallas_calls(inner)
    return found


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_wrapper_routes_by_platform(platform):
    """On a GPU the wrapper traces the Triton-route pallas_call (with
    compiled, not interpreted, lowering); on the CPU the plain form has
    none."""
    acq, cfg, cv, raw, _ = _setup(1024, 8, 2, "high")
    mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda r: ds.fused_depth_scale(
        r, cv.depth_op_re, cv.depth_op_im, mean, acq, cfg,
        platform=platform))(raw).jaxpr
    calls = _pallas_calls(jaxpr)
    if platform == "cpu":
        assert calls == []
        return
    (eqn,) = calls
    assert not eqn.params["interpret"]
    assert eqn.params["compiler_params"]["triton"].num_warps == \
        ds.BLOCKS["high"][1]


@pytest.mark.parametrize("n,lines,rung", [(1024, 131072, "bf16"),
                                          (1664, 8192, "high"),
                                          (128, 105, "highest")])
def test_kernel_grid_and_padding(n, lines, rung):
    """Grid = (column blocks, line blocks), both rounded up; the operators
    are zero-padded to whole blocks, the output is not."""
    half = n // 2
    (bm, bn, bk), warps, stages = ds.BLOCKS[rung]
    w = jnp.zeros((n, half), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda r: ds._depth_scale_kernel(
        r, w, w, jnp.zeros((2, half), jnp.float32), bitshift=False,
        compute_dtype="bfloat16" if rung == "bf16" else "float32",
        precision="default" if rung == "bf16" else rung, log_scaling=True,
        a=1.0, b=0.0, output_dtype="float32", interpret=False))(
        jax.ShapeDtypeStruct((lines, n), jnp.uint16)).jaxpr
    (eqn,) = _pallas_calls(jaxpr)
    grid = eqn.params["grid_mapping"].grid
    assert grid == (-(-half // bn), -(-lines // bm))
    kp = -(-n // bk) * bk
    hp = -(-half // bn) * bn
    op_shapes = [v.aval.shape for v in eqn.invars[1:-1]]
    assert op_shapes and all(s == (kp, hp) for s in op_shapes)
    assert eqn.outvars[0].aval.shape == (lines, half)


@pytest.mark.gpu
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_compiled_kernel_matches_plain_on_card(gpu, rung):
    """The kernel compiled for the card against the plain XLA form at the
    1024-sample width: <= 1e-3 display units on finite entries (same
    products, only the summation order differs)."""
    acq, cfg, cv, raw, _ = _setup(1024, 512, 16, rung)
    mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
    got = np.asarray(ds.fused_depth_scale(raw, cv.depth_op_re,
                                          cv.depth_op_im, mean, acq, cfg))
    want = np.asarray(fold.depth_scale(raw, cv.depth_op_re, cv.depth_op_im,
                                       mean, acq, cfg))
    fin = np.isfinite(got) & np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-3
