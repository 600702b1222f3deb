"""Rolling-average DC background removal.

Numerics match ``rollingAverageBackgroundRemoval``
(octproz_project/octproz/src/cuda_code.cu:165-211): for every sample i of an
A-scan of length n, subtract the mean over the window
``[max(0, i-W+1), min(n-1, i+W)]`` (W = rolling_average_window), i.e. an
asymmetric window of up to ``2W`` samples clamped to the A-scan.

Formulation: the window bounds depend only on the intra-A-scan index, so
we compute an exclusive prefix sum along the spectral axis and take two static
gathers -- one fused elementwise pass instead of the reference's
shared-memory tile.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def rolling_average_indices(n: int, window: int):
    """Static (start, end_inclusive, count) index vectors for line length n."""
    i = np.arange(n)
    start = np.maximum(0, i - window + 1)
    end = np.minimum(n - 1, i + window)
    count = (end - start + 1).astype(np.float32)
    return start, end, count


def remove_background(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """x: float32 (..., n) real spectra; returns x - rolling_mean(x)."""
    n = x.shape[-1]
    start, end, count = rolling_average_indices(n, window)
    # exclusive cumsum with a leading zero: csum[k] = sum(x[..., :k])
    csum = jnp.cumsum(x, axis=-1, dtype=jnp.float32)
    csum = jnp.concatenate([jnp.zeros_like(csum[..., :1]), csum], axis=-1)
    window_sum = jnp.take(csum, end + 1, axis=-1) - jnp.take(csum, start, axis=-1)
    return x - window_sum / jnp.asarray(count)
