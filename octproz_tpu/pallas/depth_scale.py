"""Steady-state hot kernel: raw integers -> scaled magnitude in one pass.

``fused_depth_scale`` runs the full-fold GEMMs (ops/fold.py), the FPN
mean-line subtraction and the log/lin dynamic-range scaling as one Pallas
kernel through Triton.  The epilogue ``A*log10(re²+im²) + B`` needs both
GEMM outputs at once, which XLA cannot fuse into one GEMM; unfused, every
buffer writes and re-reads the planar (re, im) volumes.  Here both
accumulators stay in registers and only the final image is stored.

Grid and loop: one program per (depth-column block, line block); a
``fori_loop`` walks the contraction axis in ``BK`` steps, decodes one raw
uint tile and feeds it to two ``pl.dot``s (re, im) with float32
accumulators.  Column blocks are the fastest grid axis so the programs that
share a raw tile run together and read it from L2.  Line and column edges
that the blocks do not divide are masked; the operators are zero-padded on
the host side of the call to whole blocks.

Precision rungs (``ProcConfig.compute_dtype`` / ``matmul_precision``):

* bfloat16: one bf16 product per GEMM and K step;
* float32 "default" is not a kernel rung: with TF32 operands XLA's own
  GEMMs measured faster on an H100, so it runs the plain form;
* float32 "high" / "highest": the manual bf16 split of ops/fold.dot_split,
  3 / 5 bf16 products per GEMM and K step, with the same operand
  decomposition as the plain form.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops import fold
from ..params import AcqParams, ProcConfig

#: Per rung: (lines, depth columns, contraction step) block, warps,
#: pipeline stages.  Two float32 accumulators of one block stay in
#: registers; the operator parts of all stages share the 227 KB of shared
#: memory a block may use, so the 5-product rung runs 2 stages.  Chosen by
#: a sweep on an H100 (benchmarks/fold_kernel.py --blocks).
BLOCKS = {
    "bf16": ((128, 128, 64), 8, 3),
    "high": ((128, 128, 64), 8, 3),
    "highest": ((128, 64, 64), 4, 2),
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _kernel(raw_ref, *refs, n_lines: int, n_in: int, half: int, bm: int,
            bn: int, bk: int, parts: int, bitshift: bool,
            log_scaling: bool, a: float, b: float):
    n_w = max(parts, 1)
    wre_refs, wim_refs = refs[:n_w], refs[n_w:2 * n_w]
    mean_ref, out_ref = refs[2 * n_w:]
    j = pl.program_id(0)  # depth-column block
    i = pl.program_id(1)  # line block
    rows = i * bm + jnp.arange(bm)
    row_ok = (rows < n_lines)[:, None]
    cols = pl.ds(j * bn, bn)

    def body(k, acc):
        re, im = acc
        kk = k * bk + jnp.arange(bk)
        x = plgpu.load(raw_ref.at[pl.ds(i * bm, bm), pl.ds(k * bk, bk)],
                       mask=row_ok & (kk < n_in)[None, :], other=0)
        xi = x.astype(jnp.int32)
        if bitshift:
            xi = xi >> 4
        xf = xi.astype(jnp.float32)
        ks = pl.ds(k * bk, bk)
        if parts:
            x_hi = fold.bf16_trunc(xf)  # the split of ops/fold.dot_split
            xs = (x_hi.astype(jnp.bfloat16),
                  (xf - x_hi).astype(jnp.bfloat16))
            # x_hi against every operator part, x_lo against all but the last
            terms = [(0, p) for p in range(parts)] + \
                    [(1, p) for p in range(parts - 1)]
            for xa, p in reversed(terms):  # low-order products first
                re = re + pl.dot(xs[xa], wre_refs[p][ks, cols])
                im = im + pl.dot(xs[xa], wim_refs[p][ks, cols])
        else:
            xc = xf.astype(jnp.bfloat16)
            re = re + pl.dot(xc, wre_refs[0][ks, cols])
            im = im + pl.dot(xc, wim_refs[0][ks, cols])
        return re, im

    zero = jnp.zeros((bm, bn), jnp.float32)
    re, im = jax.lax.fori_loop(0, pl.cdiv(n_in, bk), body, (zero, zero))
    re = re - mean_ref[0:1, cols]
    im = im - mean_ref[1:2, cols]
    out = fold.scale_epilogue(re * re + im * im, log_scaling=log_scaling,
                              a=a, b=b)
    col_ok = (j * bn + jnp.arange(bn) < half)[None, :]
    plgpu.store(out_ref.at[pl.ds(i * bm, bm), cols],
                out.astype(out_ref.dtype), mask=row_ok & col_ok)


def rung(compute_dtype: str, precision: str) -> str:
    """The precision rung's name: "bf16", "f32" (single pass), "high" or
    "highest"."""
    if compute_dtype == "bfloat16":
        return "bf16"
    return "f32" if precision == "default" else precision


@functools.partial(jax.jit, static_argnames=(
    "bitshift", "compute_dtype", "precision", "log_scaling", "a", "b",
    "output_dtype", "interpret", "block", "num_warps", "num_stages"))
def _depth_scale_kernel(raw2d, w_re, w_im, mean2, *, bitshift: bool,
                        compute_dtype: str, precision: str, log_scaling: bool,
                        a: float, b: float, output_dtype: str,
                        interpret: bool, block=None, num_warps=None,
                        num_stages=None):
    n_lines, n_in = raw2d.shape
    half = w_re.shape[1]
    tuned = BLOCKS[rung(compute_dtype, precision)]
    bm, bn, bk = block or tuned[0]
    num_warps = num_warps or tuned[1]
    num_stages = num_stages or tuned[2]
    kp, hp = _round_up(n_in, bk), _round_up(half, bn)
    parts = fold.SPLIT_PARTS.get(precision, 0)

    def pad(w):  # zero rows/columns: padded K steps and columns add nothing
        return jnp.pad(w, ((0, kp - w.shape[0]), (0, hp - w.shape[1])))

    if parts:
        ops = [pad(p) for p in fold.split_bf16(w_re, parts)] + \
              [pad(p) for p in fold.split_bf16(w_im, parts)]
    else:
        ops = [pad(w_re).astype(jnp.bfloat16), pad(w_im).astype(jnp.bfloat16)]
    mean_p = jnp.pad(mean2.astype(jnp.float32), ((0, 0), (0, hp - half)))
    odt = jnp.bfloat16 if output_dtype == "bfloat16" else jnp.float32
    kernel = functools.partial(
        _kernel, n_lines=n_lines, n_in=n_in, half=half, bm=bm, bn=bn, bk=bk,
        parts=parts, bitshift=bitshift, log_scaling=log_scaling, a=a, b=b)
    n_dots = 2 * (2 * parts - 1 if parts else 1)
    return pl.pallas_call(
        kernel,
        grid=(hp // bn, pl.cdiv(n_lines, bm)),
        out_shape=jax.ShapeDtypeStruct((n_lines, half), odt),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        cost_estimate=pl.CostEstimate(
            flops=n_dots * 2 * n_lines * n_in * half,
            bytes_accessed=raw2d.size * raw2d.dtype.itemsize
            + sum(o.size * o.dtype.itemsize for o in ops)
            + n_lines * half * jnp.dtype(odt).itemsize,
            transcendentals=n_lines * half),
        interpret=interpret,
        name="fold_depth_scale",
    )(raw2d, *ops, mean_p)


def implementation(platform: str, cfg: ProcConfig, bit_depth: int,
                   interpret: bool = False) -> str:
    """Which form of the step runs: the "plain" XLA form when the config
    asks for it (``fold_backend="xla"``), for containers wider than 16 bits,
    and for the single-pass float32 rung (TF32 operands, where XLA's own
    GEMMs measured faster on an H100); else "interpret" when a caller asks
    for the Pallas interpreter, the compiled "kernel" on a GPU, and the
    "plain" form anywhere else."""
    precision = fold.effective_precision(cfg.compute_dtype,
                                         cfg.matmul_precision)
    if (cfg.fold_backend == "xla" or bit_depth > 16
            or rung(cfg.compute_dtype, precision) == "f32"):
        return "plain"
    if interpret:
        return "interpret"
    return "kernel" if platform == "gpu" else "plain"


def fused_depth_scale(
    raw: jnp.ndarray,
    depth_op_re: jnp.ndarray,
    depth_op_im: jnp.ndarray,
    mean2: jnp.ndarray,
    acq: AcqParams,
    cfg: ProcConfig,
    interpret: bool = False,
    platform: Optional[str] = None,
) -> jnp.ndarray:
    """Raw uint lines (..., n) -> scaled magnitude (..., half) in
    ``cfg.output_dtype``: stages 1-4 + IFFT + truncation + FPN mean
    subtraction + log/lin dynamic range.  ``mean2`` is float32 (2, half):
    the (re, im) FPN mean line (zeros when FPN is off).

    ``platform`` defaults to ``jax.default_backend()``; see
    :func:`implementation` for the choice it makes."""
    if depth_op_re is None or depth_op_im is None:
        raise ValueError(
            "cfg.fft_via_matmul is set but curves.depth_op_* is None -- "
            "build the curves with the same config (make_curves(acq, cfg, ...))")
    impl = implementation(platform or jax.default_backend(), cfg,
                          acq.bit_depth, interpret)
    if impl == "plain":
        return fold.depth_scale(raw, depth_op_re, depth_op_im, mean2, acq, cfg)
    lead_shape = raw.shape[:-1]
    a, b = fold.scale_affine(cfg.log_scaling, acq.output_ascan_length,
                             cfg.grayscale_min, cfg.grayscale_max,
                             cfg.addend, cfg.multiplicator)
    mag = _depth_scale_kernel(
        raw.reshape(-1, raw.shape[-1]), depth_op_re, depth_op_im, mean2,
        bitshift=cfg.bitshift, compute_dtype=cfg.compute_dtype,
        precision=fold.effective_precision(cfg.compute_dtype,
                                           cfg.matmul_precision),
        log_scaling=cfg.log_scaling, a=a, b=b,
        output_dtype=cfg.output_dtype, interpret=impl == "interpret")
    return mag.reshape(*lead_shape, mag.shape[-1])
