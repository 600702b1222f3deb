"""Batched inverse FFT along the spectral axis.

The reference runs one batched, in-place, UNNORMALIZED cuFFT C2C inverse plan
over all A-scans of a buffer (cufftPlan1d + cufftExecC2C(CUFFT_INVERSE),
octproz_project/octproz/src/cuda_code.cu:1140,1513-1515); the 1/N
normalization is folded into the log/lin scaling stage instead
(cuda_code.cu:713-714).

XLA's batched FFT.  ``norm="forward"`` gives the unnormalized
inverse transform matching cuFFT.  When the spectra are still real (no
dispersion phasor), we use the RFFT identity

    ifft_unnormalized(x)[k] = conj(fft(x)[k])        (x real)

so only the first n/2+1 bins are ever computed; every consumer downstream
(fixed-pattern-noise statistics, magnitude scaling) only uses first-half
magnitudes and complex *differences*, which are invariant under conjugation,
so the results are bit-identical in exact arithmetic.  This roughly halves
FFT work for dispersion-free configurations.
"""

from __future__ import annotations

import jax.numpy as jnp


def ifft_spectra(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized inverse FFT along the last axis -> complex64 (..., n)."""
    return jnp.fft.ifft(x, axis=-1, norm="forward").astype(jnp.complex64)


def ifft_spectra_real_half(x_real: jnp.ndarray, half: int) -> jnp.ndarray:
    """First ``half`` bins of the unnormalized inverse FFT of REAL spectra.

    Returns conj(rfft(x))[..., :half] -- see module docstring for why this
    equals ifft_unnormalized(x)[..., :half] for real x.
    """
    return jnp.conj(jnp.fft.rfft(x_real, axis=-1))[..., :half].astype(jnp.complex64)
