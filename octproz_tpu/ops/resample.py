"""k-linearization: resample raw spectra at the positions given by the
resampling curve.

The reference implements four interpolators as per-sample CUDA gathers
(octproz_project/octproz/src/cuda_code.cu:213-326):

* linear      -- 2 taps      (cuda_code.cu:213-231)
* quadratic   -- 3 taps, Newton forward differences (cuda_code.cu:233-256)
* cubic       -- 4 taps, Catmull-Rom Hermite with the ``n0 = abs(n1-1)``
                 edge trick (cuda_code.cu:258-295)
* lanczos a=8 -- 16 taps windowed sinc (cuda_code.cu:297-326)

GEMM formulation: the fractional source position ``curve[j]`` depends
only on the *output column* j (cuda_code.cu:222), so every interpolator is a
**static banded linear operator** R with R[j, t] = weight of input sample t in
output sample j.  We materialize R once per curve update (host-side numpy,
analogous to the reference's LUT upload cuda_code.cu:969-973) and apply it as
``spectra @ R.T`` -- a dense matmul, which folds with windowing, dispersion
phase and the inverse DFT into one operator (ops/fold.py).  A gather
formulation (`apply_gather`) is kept for cross-checking and for very large
n where the dense matmul would dominate.

Boundary-handling parity notes:
* cubic: the reference computes ``n0 = abs(n1 - 1)``, so for n1 == 0 the
  first tap aliases to input sample 1; we reproduce this exactly.
* lanczos: the reference clamps the *A-scan base offset* to [8, samples-9]
  (cuda_code.cu:313), which for the FIRST A-scan of every buffer shifts all
  reads by 8 samples into the next line -- an artifact of its flat-buffer
  addressing.  We instead clamp each *tap index* to the A-scan ([0, n-1],
  edge replication).  Results are identical wherever the reference's taps
  stay inside the line (i.e. everywhere except the first A-scan per buffer
  and curve values within 7 samples of the line edges).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..params import Interpolation


def _lanczos8_kernel(x: np.ndarray) -> np.ndarray:
    """Lanczos a=8 kernel: sinc(x) * sinc(x/8), 1 at x == 0 (cuda_code.cu:297-302)."""
    ax = np.abs(x).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc_x = np.sin(math.pi * ax) / (math.pi * ax)
        sinc_x8 = np.sin(math.pi / 8.0 * ax) / (math.pi / 8.0 * ax)
    w = sinc_x * sinc_x8
    return np.where(ax < 1e-5, 1.0, w)


def interpolation_taps(curve: np.ndarray, mode: Interpolation):
    """Per-output-sample tap indices and weights.

    Returns (indices int32[n_out, taps], weights float32[n_out, taps]).
    Indices may exceed [0, n-1] only for LANCZOS; callers clamp.
    """
    curve = np.asarray(curve, dtype=np.float32)
    x0 = curve.astype(np.int32)  # truncation; curve is clamped >= 0
    t = (curve - x0.astype(np.float32)).astype(np.float64)

    if mode == Interpolation.LINEAR:
        idx = np.stack([x0, x0 + 1], axis=1)
        w = np.stack([1.0 - t, t], axis=1)
    elif mode == Interpolation.QUADRATIC:
        # f = f0 + (f1-f0)t + (f2-2f1+f0)/2 * t(t-1)
        q = t * (t - 1.0) / 2.0
        idx = np.stack([x0, x0 + 1, x0 + 2], axis=1)
        w = np.stack([1.0 - t + q, t - 2.0 * q, q], axis=1)
    elif mode == Interpolation.CUBIC:
        # Catmull-Rom expanded to per-tap weights; n0 = abs(n1 - 1) edge trick.
        n1 = x0
        n0 = np.abs(n1 - 1)
        idx = np.stack([n0, n1, n1 + 1, n1 + 2], axis=1)
        t2, t3 = t * t, t * t * t
        w = np.stack(
            [
                0.5 * (-t3 + 2.0 * t2 - t),
                0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
                0.5 * (-3.0 * t3 + 4.0 * t2 + t),
                0.5 * (t3 - t2),
            ],
            axis=1,
        )
    elif mode == Interpolation.LANCZOS:
        offsets = np.arange(-7, 9)  # 16 taps, i = -7..8 (cuda_code.cu:319)
        idx = x0[:, None] + offsets[None, :]
        w = _lanczos8_kernel(curve[:, None].astype(np.float64) - idx.astype(np.float64))
    else:
        raise ValueError(f"unknown interpolation mode {mode}")
    return idx.astype(np.int32), w.astype(np.float32)


def build_resample_matrix(curve: np.ndarray, mode: Interpolation, n_in: int | None = None) -> np.ndarray:
    """Dense (n_out, n_in) interpolation operator for ``out = R @ line``.

    Taps outside [0, n_in-1] (possible for LANCZOS near the edges) are clamped
    to the edge sample (edge replication).
    """
    curve = np.asarray(curve, dtype=np.float32)
    n_out = curve.shape[0]
    if n_in is None:
        n_in = n_out
    idx, w = interpolation_taps(curve, mode)
    idx = np.clip(idx, 0, n_in - 1)
    r = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.repeat(np.arange(n_out), idx.shape[1])
    np.add.at(r, (rows, idx.reshape(-1)), w.reshape(-1))
    return r


def apply_matmul(x: jnp.ndarray, resample_matrix: jnp.ndarray,
                 compute_dtype=jnp.float32,
                 precision: str = "default") -> jnp.ndarray:
    """Resample spectra as a GEMM: x (..., n_in) @ R.T -> (..., n_out).

    ``precision``: "high"/"highest" run the same manual bf16 operand-split
    multi-pass GEMM as the fold paths (ops/fold.dot_split), so their
    output does not depend on how a backend lowers lax.Precision.  Ignored
    for bfloat16 compute.
    """
    from .fold import SPLIT_PARTS, dot_split, effective_precision, split_bf16

    m = resample_matrix.T
    precision = effective_precision(
        "bfloat16" if compute_dtype == jnp.bfloat16 else "float32",
        precision)
    parts = SPLIT_PARTS.get(precision)
    if parts:
        return dot_split(x.astype(jnp.float32),
                         split_bf16(m.astype(jnp.float32), parts)
                         ).astype(jnp.float32)
    return jnp.matmul(
        x.astype(compute_dtype),
        m.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    ).astype(jnp.float32)


def apply_gather(x: jnp.ndarray, curve: jnp.ndarray, mode: Interpolation) -> jnp.ndarray:
    """Gather-based reference implementation (for parity checks / fallback).

    Works on traced curves; tap geometry mirrors `interpolation_taps` but is
    computed in jnp so the curve can change without retracing.
    """
    n = x.shape[-1]
    x0 = curve.astype(jnp.int32)
    t = curve - x0.astype(jnp.float32)

    def take(i):
        return jnp.take(x, jnp.clip(i, 0, n - 1), axis=-1)

    if mode == Interpolation.LINEAR:
        f0, f1 = take(x0), take(x0 + 1)
        return f0 + (f1 - f0) * t
    if mode == Interpolation.QUADRATIC:
        f0, f1, f2 = take(x0), take(x0 + 1), take(x0 + 2)
        b1 = f1 - f0
        b2 = ((f2 - f1) - b1) / 2.0
        return f0 + b1 * t + b2 * t * (t - 1.0)
    if mode == Interpolation.CUBIC:
        n1 = x0
        n0 = jnp.abs(n1 - 1)
        y0, y1, y2, y3 = take(n0), take(n1), take(n1 + 1), take(n1 + 2)
        a = -y0 + 3.0 * (y1 - y2) + y3
        b = 2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3
        c = -y0 + y2
        return 0.5 * t * ((a * t + b) * t + c) + y1
    if mode == Interpolation.LANCZOS:
        acc = jnp.zeros_like(jnp.take(x, x0, axis=-1))
        for i in range(-7, 9):
            tap = x0 + i
            d = curve - tap.astype(jnp.float32)
            ax = jnp.abs(d)
            pi = jnp.float32(math.pi)
            sinc_x = jnp.sin(pi * ax) / (pi * ax)
            sinc_x8 = jnp.sin(pi / 8 * ax) / (pi / 8 * ax)
            w = jnp.where(ax < 1e-5, 1.0, sinc_x * sinc_x8)
            acc = acc + take(tap) * w
        return acc
    raise ValueError(f"unknown interpolation mode {mode}")
