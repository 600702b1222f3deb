"""Independent NumPy implementation of the reference pipeline numerics.

This is the unit/golden-test oracle: a direct, scalar-minded transcription of
the *mathematics* of each reference CUDA kernel (file:line citations below
point into the reference sources), written in NumPy float64 without any of
the GEMM reformulations (no matmul resampler, no RFFT shortcut).  The
production code in octproz_tpu/ must agree with this to float32 tolerance.
"""

from __future__ import annotations

import numpy as np

FPN_SEGMENTS = 9  # octalgorithmparameters.h:35


# -- input conversion (cuda_code.cu:109-147) --------------------------------

def decode(raw: np.ndarray, bit_depth: int, bitshift: bool = False) -> np.ndarray:
    raw = np.asarray(raw)
    if bit_depth <= 16:
        if bitshift:
            raw = raw >> 4
        return raw.astype(np.float64)
    if bitshift:
        return raw.astype(np.float64) / 4294967296.0
    return raw.astype(np.float64)


# -- rolling-average background removal (cuda_code.cu:165-211) --------------

def rolling_background(x: np.ndarray, window: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    oflat = out.reshape(-1, n)
    for line in range(flat.shape[0]):
        for i in range(n):
            start = max(0, i - window + 1)
            end = min(n - 1, i + window)
            mean = flat[line, start:end + 1].mean()
            oflat[line, i] = flat[line, i] - mean
    return out


# -- k-linearization (cuda_code.cu:213-326) ----------------------------------

def _lanczos8(x: float) -> float:
    ax = abs(x)
    if ax < 1e-5:
        return 1.0
    return (np.sin(np.pi * ax) / (np.pi * ax)) * \
           (np.sin(np.pi / 8 * ax) / (np.pi / 8 * ax))


def resample_line(line: np.ndarray, curve: np.ndarray, mode: str) -> np.ndarray:
    n = line.shape[0]
    out = np.empty(curve.shape[0], np.float64)
    for j, x in enumerate(curve):
        x0 = int(x)
        t = x - x0
        if mode == "linear":
            out[j] = line[x0] + (line[x0 + 1] - line[x0]) * t
        elif mode == "quadratic":
            f0, f1, f2 = line[x0], line[x0 + 1], line[x0 + 2]
            b1 = f1 - f0
            b2 = ((f2 - f1) - b1) / 2.0
            out[j] = f0 + b1 * t + b2 * t * (t - 1.0)
        elif mode == "cubic":
            n1 = x0
            n0 = abs(n1 - 1)
            y0, y1, y2, y3 = line[n0], line[n1], line[n1 + 1], line[n1 + 2]
            a = -y0 + 3.0 * (y1 - y2) + y3
            b = 2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3
            c = -y0 + y2
            out[j] = 0.5 * t * ((a * t + b) * t + c) + y1
        elif mode == "lanczos":
            n0 = x0
            acc = 0.0
            for i in range(-7, 9):
                tap = min(max(n0 + i, 0), n - 1)  # edge-clamped taps
                acc += line[tap] * _lanczos8(x - (n0 + i))
            out[j] = acc
        else:
            raise ValueError(mode)
    return out


def resample(x: np.ndarray, curve: np.ndarray, mode: str) -> np.ndarray:
    flat = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    out = np.stack([resample_line(l, curve, mode) for l in flat])
    return out.reshape(x.shape[:-1] + (curve.shape[0],))


def resample_fast(x: np.ndarray, curve: np.ndarray, mode: str) -> np.ndarray:
    """Vectorized float64 resampler, bit-equal in math to
    :func:`resample_line` (test-pinned): the curve is shared by all lines,
    so x0/t/tap indices are computed once and applied as fancy-indexed
    gathers over the whole line matrix.  Needed for full-geometry
    (1024x512x256) oracle runs where the scalar loop is hours-slow."""
    flat = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    n = flat.shape[-1]
    curve = np.asarray(curve)
    x0 = curve.astype(np.int64)
    # t in the CURVE's dtype then promoted — resample_line computes
    # `t = x - x0` on the (typically float32) curve scalar, and bit-equality
    # with it is this function's contract
    t = (curve - x0.astype(curve.dtype)).astype(np.float64)
    if mode == "linear":
        out = flat[:, x0] + (flat[:, x0 + 1] - flat[:, x0]) * t
    elif mode == "quadratic":
        f0, f1, f2 = flat[:, x0], flat[:, x0 + 1], flat[:, x0 + 2]
        b1 = f1 - f0
        b2 = ((f2 - f1) - b1) / 2.0
        out = f0 + b1 * t + b2 * t * (t - 1.0)
    elif mode == "cubic":
        n0 = np.abs(x0 - 1)
        y0, y1, y2, y3 = (flat[:, n0], flat[:, x0],
                          flat[:, x0 + 1], flat[:, x0 + 2])
        a = -y0 + 3.0 * (y1 - y2) + y3
        b = 2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3
        c = -y0 + y2
        out = 0.5 * t * ((a * t + b) * t + c) + y1
    elif mode == "lanczos":
        out = np.zeros((flat.shape[0], curve.shape[0]))
        for i in range(-7, 9):
            tap = np.clip(x0 + i, 0, n - 1)
            # offsets in the curve's dtype (python-int tap index), exactly
            # like the scalar loop's `x - (n0 + i)`
            w = np.array([float(_lanczos8(c - (int(c0) + i)))
                          for c, c0 in zip(curve, x0)])
            out += flat[:, tap] * w
    else:
        raise ValueError(mode)
    return out.reshape(x.shape[:-1] + (curve.shape[0],))


# -- windowing / dispersion (cuda_code.cu:328-339, 593-634) ------------------

def prep(x: np.ndarray, window=None, phase=None):
    y = np.asarray(x, np.float64)
    if window is not None:
        y = y * window
    if phase is not None:
        return y * np.asarray(phase, np.complex128)
    return y


# -- unnormalized inverse FFT (cufftExecC2C CUFFT_INVERSE) -------------------

def ifft_unnormalized(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    return np.fft.ifft(x, axis=-1) * n


# -- fixed-pattern noise (cuda_code.cu:523-584) ------------------------------

FPN_TIE_EPS = 1e-3  # octproz_tpu.params.FPN_TIE_EPS — keep in sync


def min_variance_mean(lines: np.ndarray, segs: int = FPN_SEGMENTS) -> np.ndarray:
    """Banded minimum-variance segment selection (ops/fpn.py numerics).

    Deliberate divergence from the reference's exact argmin
    (cuda_code.cu:548-560): segments whose variance is within
    FPN_TIE_EPS * mean-power of the minimum are ties and the LOWEST
    segment index wins, so the choice is invariant under numeric
    perturbation (precision rungs, accumulation order)."""
    n_lines, width = lines.shape
    seg_width = n_lines // segs
    used = lines[: segs * seg_width].reshape(segs, seg_width, width)
    mean = used.mean(axis=1)                       # (segs, width)
    power = (np.abs(used) ** 2).mean(axis=1)       # (segs, width)
    var = power - np.abs(mean) ** 2
    thresh = var.min(axis=0) + FPN_TIE_EPS * power.mean(axis=0)
    best = np.argmax(var <= thresh[None, :], axis=0)
    return mean[best, np.arange(width)]


# -- truncation + scaling (cuda_code.cu:699-741) -----------------------------

def truncate_log(z: np.ndarray, gmin, gmax, addend, coeff) -> np.ndarray:
    half = z.shape[-1] // 2
    zh = z[..., :half]
    mag2 = zh.real ** 2 + zh.imag ** 2
    db = 10.0 * np.log10(mag2 / half)
    return coeff * ((db - gmin) / (gmax - gmin) + addend)


def truncate_lin(z: np.ndarray, gmin, gmax, addend, coeff) -> np.ndarray:
    half = z.shape[-1] // 2
    zh = z[..., :half]
    mag = np.sqrt(zh.real ** 2 + zh.imag ** 2) / half
    return coeff * ((mag - gmin) / (gmax - gmin) + addend)


# -- geometric post-processing (cuda_code.cu:491-521, 769-807) ---------------

def bscan_flip(vol: np.ndarray) -> np.ndarray:
    out = vol.copy()
    out[0::2] = out[0::2, ::-1, :]
    return out


def sinusoidal_curve(length: int) -> np.ndarray:
    k = np.arange(length, dtype=np.float64)
    return (length / np.pi) * np.arccos(1.0 - 2.0 * k / length)


def sinusoidal_correction(vol: np.ndarray) -> np.ndarray:
    b, a, d = vol.shape
    curve = sinusoidal_curve(a)
    out = np.empty_like(vol)
    for k in range(a):
        x = curve[k]
        x0 = min(int(x), a - 1)
        x1 = min(x0 + 1, a - 1)
        out[:, k, :] = vol[:, x0, :] + (vol[:, x1, :] - vol[:, x0, :]) * (x - int(x))
    out[-1, -1, :] = vol[-1, -1, :]  # index < samples-width guard
    return out


def post_background(vol: np.ndarray) -> np.ndarray:
    return vol.mean(axis=(0, 1))


def remove_post_background(vol, bg, weight, offset):
    return np.clip(vol - (weight * bg + offset), 0.0, 1.0)


# -- full pipeline -----------------------------------------------------------

def full_pipeline(
    raw: np.ndarray,
    bit_depth: int,
    *,
    bitshift=False,
    background_window=None,
    resample_curve=None,
    interpolation="cubic",
    window=None,
    phase=None,
    fpn_lines=0,
    fpn_mean=None,
    log_scaling=True,
    gmin=0.0, gmax=60.0, addend=0.0, coeff=1.0,
    flip=False,
    sinusoidal=False,
    post_bg=None, post_bg_weight=1.0, post_bg_offset=0.0,
    fast=False,
):
    """End-to-end oracle. Returns (processed volume, fpn mean line or None).

    ``fast=True`` uses the vectorized resampler (same math, test-pinned
    equal) for full-geometry runs."""
    x = decode(raw, bit_depth, bitshift)
    if background_window:
        x = rolling_background(x, background_window)
    if resample_curve is not None:
        x = (resample_fast if fast else resample)(x, resample_curve,
                                                  interpolation)
    spec = prep(x, window, phase)
    z = ifft_unnormalized(spec)

    mean_line = None
    if fpn_lines:
        lines = z.reshape(-1, z.shape[-1])[:fpn_lines]
        mean_line = fpn_mean if fpn_mean is not None else min_variance_mean(lines)
        half = z.shape[-1] // 2
        z = z.copy()
        z[..., :half] -= mean_line[:half]

    if log_scaling:
        mag = truncate_log(z, gmin, gmax, addend, coeff)
    else:
        mag = truncate_lin(z, gmin, gmax, addend, coeff)

    if flip:
        mag = bscan_flip(mag)
    if sinusoidal:
        mag = sinusoidal_correction(mag)
    if post_bg is not None:
        mag = remove_post_background(mag, post_bg, post_bg_weight, post_bg_offset)
    return mag, mean_line
