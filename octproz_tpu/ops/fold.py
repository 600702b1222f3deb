"""The full-fold formulation: the whole pre-FPN chain as one GEMM per line.

Every pre-FFT stage is a *linear* operator on each A-scan whose
coefficients depend only on the intra-line index:

  decode        d = float(raw)            (elementwise)
  background    b = (I - M) d             M = rolling-mean band matrix
                                          (cuda_code.cu:165-211)
  k-linearize   r = R b                   R = interpolation band matrix
                                          (cuda_code.cu:213-326)
  window        w = diag(win) r           (cuda_code.cu:328-339)
  dispersion    z = w * (cos phi, sin phi)  (cuda_code.cu:609-622)

and so is the unnormalized inverse DFT with mirror truncation.  The chain
therefore folds into one complex (n_in, half) operator, precomputed once per
curve update on the host (the analog of the reference's LUT uploads,
cuda_code.cu:636-657), and applied as two real GEMMs ``raw @ (re | im)``.
This is the analog of the reference's triple-fused CUDA kernels
``klinearization{,Cubic,Lanczos}AndWindowingAndDispersionCompensation``
(cuda_code.cu:413-489), extended through the IFFT.

This module holds the operator builders, the precision rungs, the
dynamic-range epilogue constants, and the plain XLA forms of the fold.  The
hand-written GPU kernel of the steady-state step lives in
``octproz_tpu.pallas.depth_scale``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import AcqParams, ProcConfig
from .background import rolling_average_indices


def effective_precision(compute_dtype: str, precision: str) -> str:
    """``matmul_precision`` is ignored with compute_dtype="bfloat16"
    (ProcConfig contract): the operands are already bf16, so the multi-pass
    split is meaningless.  Callers normalize through this so the jit cache
    key and the computation agree."""
    return "default" if compute_dtype == "bfloat16" else precision


#: Operator split widths of the manual multi-pass GEMM:
#: "high" -> 2 bf16 parts (3 bf16 products), "highest" -> 3 parts (5).
SPLIT_PARTS = {"high": 2, "highest": 3}


def bf16_trunc(v):
    """The exactly-bf16-representable truncation of float32 v, computed by
    MASKING the low 16 mantissa bits (bitcast + AND).

    Not written as ``v.astype(bf16).astype(f32)``: a compiler may fold that
    lossy cast round trip back to ``v``, and the split would then collapse
    to single-pass accuracy.  An integer mask cannot be elided.  Truncation
    (vs round-to-nearest) costs <1 bit in the split's error bound."""
    i = jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.int32)
    return jax.lax.bitcast_convert_type(
        jax.lax.bitwise_and(i, jnp.int32(-65536)), jnp.float32)


def split_bf16(w, parts: int = 2):
    """Decompose a float32 matrix into ``parts`` bf16 terms whose sum equals
    w to ~8*parts mantissa bits (hi keeps the top 8 bits, each further part
    the next 8).  Each term is exactly representable in bf16 (mask-based
    truncation), so the f32->bf16 conversions are value-preserving."""
    out = []
    rem = w
    for k in range(parts):
        p = bf16_trunc(rem) if k < parts - 1 else rem
        out.append(p.astype(jnp.bfloat16))
        rem = rem - p
    return tuple(out)


def dot_split(x, w_parts):
    """float32-grade GEMM from bf16 tensor-core products:

        x @ w ~= sum_j x_hi @ w_j  +  sum_{j<last} x_lo @ w_j

    with f32 accumulation, smallest terms first.  x is split into two bf16
    terms; for the OCT decode path x is integer-valued (<= 16-bit), so
    x == x_hi + x_lo exactly and the only operand error is w's last-part
    rounding plus the dropped lowest-order cross terms:

      parts=2 ("high"):    3 products, ~2^-16 relative  (vs 2^-8 for bf16)
      parts=3 ("highest"): 5 products, ~2^-24 relative  (true-f32 grade)
    """
    x_hi_f = bf16_trunc(x)  # mask-based: immune to cast folding
    x_hi = x_hi_f.astype(jnp.bfloat16)
    x_lo = (x - x_hi_f).astype(jnp.bfloat16)
    terms = [(x_hi, w) for w in w_parts] + [(x_lo, w) for w in w_parts[:-1]]
    acc = None
    for xa, wa in reversed(terms):  # low-order products first
        t = jnp.dot(xa, wa, preferred_element_type=jnp.float32)
        acc = t if acc is None else acc + t
    return acc


def build_prep_operator(
    acq: AcqParams,
    cfg: ProcConfig,
    resample_matrix: Optional[np.ndarray],
    window: Optional[np.ndarray],
) -> np.ndarray:
    """Fold background removal, k-linearization and windowing into one
    (n_in, n_out) operator applied as ``lines @ op``.

    Composition order matches the pipeline stage order (cuda_code.cu:
    1422-1511): background first, then resampling, then window scaling.
    """
    n = acq.samples_per_line
    op = np.eye(n, dtype=np.float64)
    if cfg.background_removal:
        start, end, count = rolling_average_indices(n, cfg.rolling_average_window)
        m = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            m[i, start[i]:end[i] + 1] = 1.0 / count[i]
        op = op - m  # (I - M)
    if cfg.resampling:
        if resample_matrix is None:
            raise ValueError("resampling enabled but no resample matrix given")
        op = np.asarray(resample_matrix, np.float64) @ op
    if cfg.windowing:
        if window is None:
            raise ValueError("windowing enabled but no window curve given")
        op = np.asarray(window, np.float64)[:, None] * op
    return np.ascontiguousarray(op.T, dtype=np.float32)  # (n_in, n_out)


def build_depth_operator(
    acq: AcqParams,
    cfg: ProcConfig,
    resample_matrix: Optional[np.ndarray],
    window: Optional[np.ndarray],
    phase: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold the ENTIRE pre-FPN chain -- background, k-linearization, window,
    dispersion phasor, unnormalized inverse DFT, mirror truncation -- into one
    complex (n_in, half) operator applied as ``lines @ (re + i im)``.

    With F[k, j] = exp(+2i pi k j / n) (the unnormalized inverse-DFT rows for
    the kept half, matching cufftExecC2C(CUFFT_INVERSE),
    cuda_code.cu:1513-1515):

        z_half = F_half . diag(phasor) . diag(win) . R . (I - M) . decode(raw)

    A dense (n x n/2) complex GEMM costs ~40x the FLOPs of an FFT, but it
    replaces five memory-bound passes with one pass over the raw integers.
    """
    n = acq.samples_per_line
    half = acq.output_ascan_length
    op = build_prep_operator(acq, cfg, resample_matrix, window)  # (n_in, n_out)
    opd = op.astype(np.float64).T  # (n_out, n_in)
    if cfg.dispersion:
        if phase is None:
            raise ValueError("dispersion enabled but no phasor given")
        opd = np.asarray(phase, np.complex128)[:, None] * opd
    j = np.arange(n, dtype=np.float64)
    k = np.arange(half, dtype=np.float64)
    f_half = np.exp(2j * np.pi * np.outer(k, j) / n)  # (half, n_out)
    total = f_half @ opd                               # (half, n_in) complex
    total_t = np.ascontiguousarray(total.T)            # (n_in, half)
    return (total_t.real.astype(np.float32), total_t.imag.astype(np.float32))


def scale_affine(log_scaling: bool, half: int, gmin: float, gmax: float,
                 addend: float, coeff: float) -> Tuple[float, float]:
    """Fold the dynamic-range scaling into two constants so the epilogue is
    one transcendental plus one fma per element:

      log: coeff*((10*log10(p/half) - gmin)/(gmax-gmin) + addend) = A*log10(p) + B
      lin: coeff*((sqrt(p)/half   - gmin)/(gmax-gmin) + addend) = A*sqrt(p)  + B

    Computed in float64 numpy (division by a zero range yields inf, matching
    the unfolded expression's behavior, not a Python exception)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.float64(coeff) / (np.float64(gmax) - np.float64(gmin))
        base = np.float64(coeff) * addend - s * gmin
        if log_scaling:
            a = 10.0 * s
            b = base - s * 10.0 * np.log10(np.float64(half))
        else:
            a = s / np.float64(half)
            b = base
    return float(a), float(b)


def scale_epilogue(p, *, log_scaling: bool, a: float, b: float):
    """``A*log10(p) + B`` (or ``A*sqrt(p) + B``) on the power p = re²+im²."""
    v = jnp.log10(p) if log_scaling else jnp.sqrt(p)
    return jnp.float32(a) * v + jnp.float32(b)


def depth_transform(raw, depth_op_re, depth_op_im, acq: AcqParams,
                    cfg: ProcConfig):
    """Raw uint lines -> truncated depth profiles through XLA's own GEMMs
    (stages 1-4 + IFFT + truncation).  Returns PLANAR (re, im) float32
    (..., half).  XLA fuses the integer decode into the GEMM operand read."""
    if depth_op_re is None or depth_op_im is None:
        raise ValueError(
            "cfg.fft_via_matmul is set but curves.depth_op_* is None -- "
            "build the curves with the same config (make_curves(acq, cfg, ...))")
    from .convert import decode

    lead_shape = raw.shape[:-1]
    x = decode(raw.reshape(-1, raw.shape[-1]), acq.bit_depth, cfg.bitshift)
    parts = SPLIT_PARTS.get(effective_precision(cfg.compute_dtype,
                                                cfg.matmul_precision))
    if parts:
        re = dot_split(x, split_bf16(depth_op_re, parts))
        im = dot_split(x, split_bf16(depth_op_im, parts))
    else:  # one pass: bf16 products, or float32 at DEFAULT precision
        if cfg.compute_dtype == "bfloat16":
            x = x.astype(jnp.bfloat16)
            depth_op_re = depth_op_re.astype(jnp.bfloat16)
            depth_op_im = depth_op_im.astype(jnp.bfloat16)
        re = jnp.matmul(x, depth_op_re, preferred_element_type=jnp.float32)
        im = jnp.matmul(x, depth_op_im, preferred_element_type=jnp.float32)
    half = re.shape[-1]
    return re.reshape(*lead_shape, half), im.reshape(*lead_shape, half)


def depth_scale(raw, depth_op_re, depth_op_im, mean2, acq: AcqParams,
                cfg: ProcConfig):
    """The plain XLA form of the steady-state step: fold GEMMs, FPN mean-line
    subtraction (``mean2`` = float32 (2, half) rows re, im; zeros when FPN is
    off) and dynamic-range scaling, stored in ``cfg.output_dtype``."""
    re, im = depth_transform(raw, depth_op_re, depth_op_im, acq, cfg)
    re = re - mean2[0]
    im = im - mean2[1]
    a, b = scale_affine(cfg.log_scaling, acq.output_ascan_length,
                        cfg.grayscale_min, cfg.grayscale_max, cfg.addend,
                        cfg.multiplicator)
    out = scale_epilogue(re * re + im * im, log_scaling=cfg.log_scaling,
                         a=a, b=b)
    return out.astype(jnp.bfloat16 if cfg.output_dtype == "bfloat16"
                      else jnp.float32)
