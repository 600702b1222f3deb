"""Fixed-pattern-noise removal (minimum-variance mean A-line method,
Moon et al. 2010).

Numerics match the reference kernels
(octproz_project/octproz/src/cuda_code.cu):

* ``getMinimumVarianceMean`` (:523-565): split the first
  ``bscans_for_noise * ascans_per_bscan`` post-IFFT A-scans into
  FPN_SEGMENTS = 9 segments of ``height // 9`` consecutive lines
  (octalgorithmparameters.h:35); per depth index, compute each segment's
  complex mean and variance (E|z|^2 - |Ez|^2) and keep the mean of the
  minimum-variance segment.
* ``meanALineSubtraction`` (:567-584): subtract that complex mean from the
  positive-depth (first) half of every A-scan; the mirror half is about to
  be truncated anyway (cuda_code.cu:1526).

Formulation: a reshape + two reductions + argmin-select -- all
elementwise-friendly, no atomics.  The per-depth statistics are also exposed as raw
segment sums so the sharded pipeline can psum them across devices
(see octproz_tpu.parallel.sharding).

Deliberate divergence from the reference: the segment selection is a
TOLERANCE-BANDED minimum (see :func:`_banded_argmin`), not an exact argmin.
The exact argmin flips on near-tied variances under any numeric
perturbation, which made end-to-end fidelity chaotic across precision
rungs; any segment inside the band is an equally good FPN estimate, so the
band changes nothing physically while making the choice deterministic.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..params import FPN_SEGMENTS, FPN_TIE_EPS


def _banded_argmin(variance: jnp.ndarray, power_scale: jnp.ndarray) -> jnp.ndarray:
    """Perturbation-stable minimum-variance segment choice.

    The reference picks the exact argmin (cuda_code.cu:548-560); under
    near-ties that choice flips on any numeric perturbation (different
    precision rung, different accumulation order), making end-to-end
    fidelity chaotic.  We band the minimum: every
    segment whose variance is within ``FPN_TIE_EPS * power_scale`` of the
    minimum is a tie, and the LOWEST segment index wins.  ``power_scale``
    is the per-depth mean power E|z|^2 across segments — a positive,
    cancellation-free magnitude, so the band is robust even when the
    variance itself (computed as E|z|^2 - |Ez|^2) suffers catastrophic
    cancellation or rounds slightly negative.

    variance: float32 (segments, width); power_scale: float32 (width,).
    Returns int32 (width,).
    """
    v_min = jnp.min(variance, axis=0)
    thresh = v_min + jnp.float32(FPN_TIE_EPS) * power_scale
    tied = variance <= thresh[None, :]
    return jnp.argmax(tied, axis=0)  # first True == lowest tied index


def segment_sums(lines: jnp.ndarray, segments: int = FPN_SEGMENTS):
    """Per-segment complex sums and power sums.

    lines: complex64 (n_lines, width) -- post-IFFT A-scans (any width; the
    pipeline passes the truncated positive-depth half, which yields results
    identical to the reference's full-width kernel for the half it uses).

    Returns (sum_z complex64 (segments, width), sum_sq float32 (segments, width),
    seg_width int) where seg_width = n_lines // segments lines per segment
    (trailing remainder lines are ignored, like the reference's integer
    division cuda_code.cu:531).
    """
    n_lines, width = lines.shape
    if n_lines < segments:
        raise ValueError(
            f"fixed-pattern-noise determination needs at least {segments} "
            f"A-scans (FPN_SEGMENTS, octalgorithmparameters.h:35) but got "
            f"{n_lines}; raise bscans_for_noise or ascans_per_bscan, or "
            f"disable FPN for this geometry")
    seg_width = max(n_lines // segments, 1)
    used = lines[: segments * seg_width].reshape(segments, seg_width, width)
    sum_z = jnp.sum(used, axis=1)
    sum_sq = jnp.sum(used.real**2 + used.imag**2, axis=1)
    return sum_z, sum_sq, seg_width


def select_min_variance_mean(sum_z: jnp.ndarray, sum_sq: jnp.ndarray,
                             seg_count) -> jnp.ndarray:
    """Combine segment statistics into the minimum-variance mean line.

    seg_count: scalar or per-segment line count (after any cross-device psum).
    Returns complex64 (width,).
    """
    factor = 1.0 / jnp.asarray(seg_count, jnp.float32)
    mean = sum_z * factor
    variance = sum_sq * factor - (mean.real**2 + mean.imag**2)
    power_scale = jnp.mean(sum_sq * factor, axis=0)
    best = _banded_argmin(variance, power_scale)  # (width,)
    return jnp.take_along_axis(mean, best[None, :], axis=0)[0]


def minimum_variance_mean(lines: jnp.ndarray, segments: int = FPN_SEGMENTS) -> jnp.ndarray:
    """complex64 (n_lines, width) -> minimum-variance mean line (width,)."""
    sum_z, sum_sq, seg_width = segment_sums(lines, segments)
    return select_min_variance_mean(sum_z, sum_sq, seg_width)


def subtract_mean_line(z_half: jnp.ndarray, mean_line_half: jnp.ndarray) -> jnp.ndarray:
    """Subtract the mean line from every (already truncated) A-scan.

    z_half: complex64 (..., width/2); mean_line_half: complex64 (width/2,).
    """
    return z_half - mean_line_half


# ---------------------------------------------------------------------------
# Planar (re, im) variants: identical numerics with no complex64 arrays.
# Used by the fft_via_matmul path, which never builds complex64 arrays.
# ---------------------------------------------------------------------------

def segment_sums_planar(re: jnp.ndarray, im: jnp.ndarray,
                        segments: int = FPN_SEGMENTS):
    """Planar analog of :func:`segment_sums`.

    re/im: float32 (n_lines, width).  Returns (sum_re, sum_im, sum_sq,
    seg_width)."""
    n_lines, width = re.shape
    if n_lines < segments:
        raise ValueError(
            f"fixed-pattern-noise determination needs at least {segments} "
            f"A-scans (FPN_SEGMENTS, octalgorithmparameters.h:35) but got "
            f"{n_lines}; raise bscans_for_noise or ascans_per_bscan, or "
            f"disable FPN for this geometry")
    seg_width = max(n_lines // segments, 1)
    used_re = re[: segments * seg_width].reshape(segments, seg_width, width)
    used_im = im[: segments * seg_width].reshape(segments, seg_width, width)
    sum_re = jnp.sum(used_re, axis=1)
    sum_im = jnp.sum(used_im, axis=1)
    sum_sq = jnp.sum(used_re**2 + used_im**2, axis=1)
    return sum_re, sum_im, sum_sq, seg_width


def select_min_variance_mean_planar(sum_re, sum_im, sum_sq, seg_count):
    """Planar analog of :func:`select_min_variance_mean` -> (mean_re, mean_im)."""
    factor = 1.0 / jnp.asarray(seg_count, jnp.float32)
    mean_re = sum_re * factor
    mean_im = sum_im * factor
    variance = sum_sq * factor - (mean_re**2 + mean_im**2)
    power_scale = jnp.mean(sum_sq * factor, axis=0)
    best = _banded_argmin(variance, power_scale)
    take = lambda m: jnp.take_along_axis(m, best[None, :], axis=0)[0]
    return take(mean_re), take(mean_im)


def minimum_variance_mean_planar(re, im, segments: int = FPN_SEGMENTS):
    sum_re, sum_im, sum_sq, seg_width = segment_sums_planar(re, im, segments)
    return select_min_variance_mean_planar(sum_re, sum_im, sum_sq, seg_width)
