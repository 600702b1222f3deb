"""The per-buffer FD-OCT reconstruction step.

Functional, jit-compiled equivalent of the reference's GPU hot loop
``octCudaPipeline`` (octproz_project/octproz/src/cuda_code.cu:1389-1605).
Stage order (matching the reference exactly):

  1. decode raw integers (+ optional >>4 bitshift)      cuda_code.cu:1408-1414
  2. rolling-average DC background removal [opt]        cuda_code.cu:1422-1429
  3. k-linearization x window x dispersion phase [opt]  cuda_code.cu:1447-1511
  4. batched unnormalized inverse FFT                   cuda_code.cu:1513-1515
  5. fixed-pattern-noise removal [opt]                  cuda_code.cu:1517-1527
  6. mirror-artifact truncation + log/lin scaling       cuda_code.cu:1537-1543
  7. B-scan flip [opt]                                  cuda_code.cu:1545-1548
  8. sinusoidal scan correction [opt]                   cuda_code.cu:1550-1554
  9. post-process background removal [opt]              cuda_code.cu:1556-1568

Differences by design (a JAX design, not a port):

* The reference dispatches one of ~12 pre-fused CUDA kernels per flag
  combination at runtime; here the flags are *static* fields of
  :class:`~octproz_tpu.params.ProcConfig`, so tracing resolves the dispatch
  once and XLA fuses the surviving ops (resampling runs as a matmul with
  window/phase fused into its epilogue).
* cuFFT's in-place C2C inverse becomes XLA's batched FFT; when no dispersion
  phasor is applied the spectra are still real and the RFFT identity halves
  the FFT work (see octproz_tpu.ops.fft).
* The FPN mean line is explicit carried state (:class:`FpnState`) instead of
  a device global + host flag (cuda_code.cu:105,1521-1524).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .params import AcqParams, Curves, FpnMode, FpnState, ProcConfig
from .ops import background, convert, dispersion, fft, fpn, postprocess, resample


def prep_spectra(raw: jnp.ndarray, curves: Curves, acq: AcqParams,
                 cfg: ProcConfig) -> jnp.ndarray:
    """Stages 1-3: decode -> DC removal -> resample x window x phase.

    raw: uint (bscans, ascans, samples).  Returns float32 (real path) or
    complex64 (dispersion path), shape (bscans, ascans, samples).
    """
    x = convert.decode(raw, acq.bit_depth, cfg.bitshift)

    if cfg.background_removal:
        x = background.remove_background(x, cfg.rolling_average_window)

    if cfg.resampling:
        if cfg.resample_via_matmul:
            compute_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
            x = resample.apply_matmul(x, curves.resample_matrix, compute_dtype,
                                      precision=cfg.matmul_precision)
        else:
            x = resample.apply_gather(x, curves.resample_curve, cfg.interpolation)

    return dispersion.prep_spectra(
        x,
        curves.window if cfg.windowing else None,
        curves.phase if cfg.dispersion else None,
    )


def transform_to_depth(spectra: jnp.ndarray, half: int) -> jnp.ndarray:
    """Stage 4 + truncation: IFFT and keep the positive-depth half.

    Uses the half-spectrum RFFT path when the spectra are still real.
    Returns complex64 (bscans, ascans, half).
    """
    if jnp.issubdtype(spectra.dtype, jnp.complexfloating):
        return postprocess.truncate_half(fft.ifft_spectra(spectra))
    return fft.ifft_spectra_real_half(spectra, half)


def apply_fpn_planar(z_re: jnp.ndarray, z_im: jnp.ndarray, state: FpnState,
                     acq: AcqParams, cfg: ProcConfig
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, FpnState]:
    """Stage 5: fixed-pattern-noise removal with carried mean-line state.

    Planar (re, im) formulation -- no complex64 arrays.  The statistics use
    the first ``bscans_for_noise * ascans_per_bscan`` A-scans of the buffer
    (cuda_code.cu:1519-1522), computed on the truncated half (exactly the
    part the subtraction consumes).
    """
    width = z_re.shape[-1]
    n_noise_lines = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
    lines_re = z_re.reshape(-1, width)[:n_noise_lines]
    lines_im = z_im.reshape(-1, width)[:n_noise_lines]

    def compute():
        return FpnState.pack(*fpn.minimum_variance_mean_planar(lines_re, lines_im))

    if cfg.fpn_mode == FpnMode.CONTINUOUS:
        mean = compute()
    else:  # ONCE: reuse once determined (cuda_code.cu:1521-1524)
        mean = jax.lax.cond(state.determined, lambda: state.mean_line, compute)
    new_state = FpnState(mean_line=mean, determined=jnp.ones((), jnp.bool_))
    return z_re - mean[0], z_im - mean[1], new_state


def apply_fpn(z_half: jnp.ndarray, state: FpnState, acq: AcqParams,
              cfg: ProcConfig) -> Tuple[jnp.ndarray, FpnState]:
    """Complex-array wrapper around :func:`apply_fpn_planar`."""
    re, im, new_state = apply_fpn_planar(z_half.real, z_half.imag, state, acq, cfg)
    return jax.lax.complex(re, im), new_state


def postprocess_volume(mag: jnp.ndarray, curves: Curves, cfg: ProcConfig) -> jnp.ndarray:
    """Stages 7-9 on the scaled magnitude volume (bscans, ascans, depth)."""
    if cfg.bscan_flip:
        mag = postprocess.bscan_flip(mag)
    if cfg.sinusoidal_correction:
        mag = postprocess.sinusoidal_correction(mag, curves.sinusoidal_curve)
    if cfg.post_background_removal:
        mag = postprocess.remove_post_background(
            mag, curves.post_background,
            cfg.post_background_weight, cfg.post_background_offset)
    return mag


def process_buffer(
    raw: jnp.ndarray,
    curves: Curves,
    fpn_state: FpnState,
    acq: AcqParams,
    cfg: ProcConfig,
) -> Tuple[jnp.ndarray, FpnState]:
    """Full per-buffer step: raw uint (bscans, ascans, samples) ->
    (processed (bscans, ascans, samples//2) in cfg.output_dtype, new FPN
    state)."""
    half = acq.output_ascan_length

    # Stages 7-9 interpolate/subtract on the magnitude volume; with
    # output_dtype="bfloat16" that arithmetic must still run in float32
    # (the narrowing is a *storage* decision), so the narrow happens AFTER
    # postprocess_volume whenever any of those stages is enabled.
    has_post = (cfg.bscan_flip or cfg.sinusoidal_correction
                or cfg.post_background_removal)

    def narrow(mag):
        # cfg.output_dtype: arithmetic stays float32; only the stored volume
        # is narrowed (the fused kernel writes this dtype directly when no
        # post-stage follows it).
        if cfg.output_dtype == "bfloat16" and mag.dtype != jnp.bfloat16:
            return mag.astype(jnp.bfloat16)
        return mag

    if cfg.fft_via_matmul:
        # fully planar path: no complex64 anywhere
        import dataclasses as _dc

        from .ops.fold import depth_transform
        from .pallas.depth_scale import fused_depth_scale

        # the kernel's store dtype: float32 while post-stages still consume it
        kcfg = (_dc.replace(cfg, output_dtype="float32")
                if has_post and cfg.output_dtype == "bfloat16" else cfg)

        def unfused(state):
            z_re, z_im = depth_transform(raw, curves.depth_op_re,
                                         curves.depth_op_im, acq, cfg)
            if cfg.fpn_mode != FpnMode.OFF:
                z_re, z_im, state = apply_fpn_planar(z_re, z_im, state,
                                                     acq, cfg)
            scale = (postprocess.scale_log_planar if cfg.log_scaling
                     else postprocess.scale_lin_planar)
            mag = scale(z_re, z_im, half, cfg.grayscale_min,
                        cfg.grayscale_max, cfg.addend, cfg.multiplicator)
            if not has_post:
                mag = narrow(mag)
            return mag, state

        # Steady state: GEMM + FPN subtraction + dynamic-range scaling in
        # one step (pallas/depth_scale.py), usable when the FPN mean line is
        # an INPUT: FPN off (zeros) or FPN ONCE after determination
        # (lax.cond picks the determination path for the first buffer only).
        if cfg.fpn_mode in (FpnMode.OFF, FpnMode.ONCE):
            def fused(state):
                # OFF ignores any carried state (e.g. from a prior ONCE run):
                # subtract zeros so fused and unfused OFF semantics match.
                mean = (jnp.zeros_like(state.mean_line)
                        if cfg.fpn_mode == FpnMode.OFF else state.mean_line)
                mag = fused_depth_scale(raw, curves.depth_op_re,
                                        curves.depth_op_im, mean,
                                        acq, kcfg)
                return mag, state

            if cfg.fpn_mode == FpnMode.OFF:
                mag, fpn_state = fused(fpn_state)
            else:
                mag, fpn_state = jax.lax.cond(fpn_state.determined, fused,
                                              unfused, fpn_state)
        else:
            mag, fpn_state = unfused(fpn_state)
        return narrow(postprocess_volume(mag, curves, cfg)), fpn_state

    spectra = prep_spectra(raw, curves, acq, cfg)
    z_half = transform_to_depth(spectra, half)

    if cfg.fpn_mode != FpnMode.OFF:
        z_half, fpn_state = apply_fpn(z_half, fpn_state, acq, cfg)

    if cfg.log_scaling:
        mag = postprocess.scale_log(z_half, half, cfg.grayscale_min,
                                    cfg.grayscale_max, cfg.addend, cfg.multiplicator)
    else:
        mag = postprocess.scale_lin(z_half, half, cfg.grayscale_min,
                                    cfg.grayscale_max, cfg.addend, cfg.multiplicator)

    return narrow(postprocess_volume(mag, curves, cfg)), fpn_state


@functools.lru_cache(maxsize=64)
def make_step(acq: AcqParams, cfg: ProcConfig, donate_raw: bool = False):
    """Build the jitted per-buffer step for a static (acq, cfg) pair.

    Returns ``step(raw, curves, fpn_state) -> (processed, fpn_state)``.
    One executable per configuration -- the compile-cache analog of the
    reference's kernel dispatch table.

    Only the Curves fields this configuration consumes enter the jit
    (curves.consumed_fields); unused LUTs -- which make_curves keeps as host
    numpy arrays -- are never transferred to the device.
    """
    from .curves import consumed_fields

    used = consumed_fields(cfg)
    donate = (0,) if donate_raw else ()

    @functools.partial(jax.jit, donate_argnums=donate)
    def inner(raw, used_vals, fpn_state):
        cv = Curves(**dict(zip(used, used_vals)))
        return process_buffer(raw, cv, fpn_state, acq=acq, cfg=cfg)

    def step(raw, curves: Curves, fpn_state):
        return inner(raw, tuple(getattr(curves, f) for f in used), fpn_state)

    return step


@functools.lru_cache(maxsize=64)
def make_scan_step(acq: AcqParams, cfg: ProcConfig, donate_raw: bool = False):
    """Build a jitted MULTI-buffer step: one device dispatch processes a
    stacked batch of raw buffers via ``lax.scan``, threading the FPN state
    buffer-to-buffer exactly like repeated :func:`make_step` calls.

    Returns ``scan_step(raw_stack, curves, fpn_state) ->
    (processed_stack, fpn_state)`` with ``raw_stack`` of shape
    ``(k, bscans, ascans, samples)``.

    This is the throughput-mode entry point: one dispatch per k buffers
    instead of one per buffer, at the cost of k buffers of latency.
    Latency-sensitive streaming keeps using :func:`make_step` per buffer.
    """
    from .curves import consumed_fields

    used = consumed_fields(cfg)
    donate = (0,) if donate_raw else ()

    @functools.partial(jax.jit, donate_argnums=donate)
    def inner(raw_stack, used_vals, fpn_state):
        cv = Curves(**dict(zip(used, used_vals)))

        def body(st, raw):
            out, st = process_buffer(raw, cv, st, acq=acq, cfg=cfg)
            return st, out

        fpn_state, outs = jax.lax.scan(body, fpn_state, raw_stack)
        return outs, fpn_state

    def scan_step(raw_stack, curves: Curves, fpn_state):
        return inner(raw_stack, tuple(getattr(curves, f) for f in used),
                     fpn_state)

    return scan_step


def initial_fpn_state(acq: AcqParams) -> FpnState:
    """FPN state sized for the truncated (positive-depth) half."""
    return FpnState.initial(acq.output_ascan_length)
