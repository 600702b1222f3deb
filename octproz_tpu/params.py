"""Processing parameters for the FD-OCT pipeline.

Capability-equivalent of the reference's ``OctAlgorithmParameters`` singleton
(reference: octproz_project/octproz/src/octalgorithmparameters.h:46-209), but
designed for JAX: instead of a mutable singleton with dirty flags we split the
parameter space into

* :class:`AcqParams`     -- acquisition geometry (static; changes => recompile)
* :class:`ProcConfig`    -- boolean/enum pipeline switches and scalars that are
                            resolved at trace time (static; mirrors the
                            reference's kernel dispatch table,
                            cuda_code.cu:1448-1511)
* :class:`Curves`        -- device-side LUT arrays (traced; live re-tuning a
                            curve does NOT recompile, mirroring the reference's
                            dirty-flag driven async LUT uploads,
                            cuda_code.cu:1432-1445)

All three are hashable / pytree-compatible as appropriate so the jitted step
function caches one executable per (AcqParams, ProcConfig) pair.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp


class Interpolation(enum.Enum):
    """k-linearization interpolators (octalgorithmparameters.h:55-59).

    QUADRATIC exists in the reference CUDA code (cuda_code.cu:233-256) but is
    not reachable from its GUI enum; we expose it anyway.
    """

    LINEAR = "linear"
    CUBIC = "cubic"
    LANCZOS = "lanczos"
    QUADRATIC = "quadratic"


class WindowType(enum.Enum):
    """Spectral window families (windowfunction.h / windowfunction.cpp:96-119).

    TAYLOR is implemented in the reference but not dispatchable from its enum
    (windowfunction.cpp:255-331); we expose it as a capability superset.
    """

    HANNING = "hanning"
    GAUSS = "gauss"
    SINE = "sine"
    LANCZOS = "lanczos"
    RECTANGULAR = "rectangular"
    FLATTOP = "flattop"
    TAYLOR = "taylor"


class FpnMode(enum.Enum):
    """Fixed-pattern-noise determination policy (cuda_code.cu:1517-1527)."""

    OFF = "off"
    ONCE = "once"            # determine on first buffer, then reuse
    CONTINUOUS = "continuous"  # redetermine every buffer


class DisplayFunction(enum.IntEnum):
    """Frame compositing mode for display slices (octalgorithmparameters.h:176-179)."""

    AVERAGING = 0
    MIP = 1


# Number of segments used by the minimum-variance fixed-pattern-noise
# estimator (octalgorithmparameters.h:35).
FPN_SEGMENTS = 9

# Relative tie band for the minimum-variance segment selection.  The
# reference's exact argmin (cuda_code.cu:523-565) flips on near-tied segment
# variances under ANY numeric perturbation, which caps end-to-end fidelity
# at the segment-choice chaos rather than the GEMM error.  We instead treat every segment whose variance lies within
# ``FPN_TIE_EPS`` of the minimum (scaled by the per-depth mean power, a
# cancellation-free magnitude) as tied and pick the LOWEST segment index —
# a deterministic choice that is invariant under precision-rung
# perturbations ~1e-5 relative (the measured "high"-split operand error)
# and numerically indistinguishable output-wise: any segment inside the
# band is an equally good FPN estimate.
FPN_TIE_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class AcqParams:
    """Acquisition geometry (octalgorithmparameters.h:109-113).

    A raw *buffer* is ``bscans_per_buffer`` B-scans of ``ascans_per_bscan``
    A-scans of ``samples_per_line`` raw spectral samples each; a *volume* is
    ``buffers_per_volume`` buffers.
    """

    samples_per_line: int = 1024
    ascans_per_bscan: int = 512
    bscans_per_buffer: int = 256
    buffers_per_volume: int = 1
    bit_depth: int = 12

    def __post_init__(self):
        if self.samples_per_line < 4:
            raise ValueError("samples_per_line must be >= 4")
        if self.bit_depth < 1 or self.bit_depth > 32:
            raise ValueError("bit_depth must be in [1, 32]")

    @property
    def bytes_per_sample(self) -> int:
        # ceil(bitDepth / 8), octalgorithmparameters.cpp:137
        return (self.bit_depth + 7) // 8

    @property
    def raw_dtype(self):
        if self.bit_depth <= 8:
            return jnp.uint8
        if self.bit_depth <= 16:
            return jnp.uint16
        return jnp.uint32

    @property
    def ascans_per_buffer(self) -> int:
        return self.ascans_per_bscan * self.bscans_per_buffer

    @property
    def samples_per_buffer(self) -> int:
        return self.samples_per_line * self.ascans_per_buffer

    @property
    def buffer_shape(self):
        """(bscans, ascans, samples) layout of one raw buffer."""
        return (self.bscans_per_buffer, self.ascans_per_bscan, self.samples_per_line)

    @property
    def output_ascan_length(self) -> int:
        """Depth samples kept after mirror-artifact truncation (cuda_code.cu:709)."""
        return self.samples_per_line // 2

    @property
    def processed_buffer_shape(self):
        return (self.bscans_per_buffer, self.ascans_per_bscan, self.output_ascan_length)

    @property
    def bytes_per_buffer(self) -> int:
        return self.samples_per_buffer * self.bytes_per_sample


@dataclasses.dataclass(frozen=True)
class ProcConfig:
    """Static pipeline configuration.

    One field per enable-flag / compile-relevant scalar of the reference's
    parameter singleton (octalgorithmparameters.h:117-166).  Hashable: used as
    a static jit argument, so each distinct configuration compiles exactly one
    executable (the analog of the reference picking one fused kernel chain per
    flag combination, cuda_code.cu:1448-1511).
    """

    # --- input conversion (cuda_code.cu:109-147) ---
    bitshift: bool = False

    # --- rolling-average DC background removal (cuda_code.cu:165-211) ---
    background_removal: bool = False
    rolling_average_window: int = 64

    # --- k-linearization (cuda_code.cu:213-326) ---
    resampling: bool = False
    interpolation: Interpolation = Interpolation.CUBIC

    # --- spectral windowing (cuda_code.cu:328-339) ---
    windowing: bool = False

    # --- numerical dispersion compensation (cuda_code.cu:586-634) ---
    dispersion: bool = False

    # --- fixed-pattern-noise removal (cuda_code.cu:523-584, 1517-1527) ---
    fpn_mode: FpnMode = FpnMode.OFF
    bscans_for_noise: int = 1

    # --- dynamic-range scaling (cuda_code.cu:699-741) ---
    log_scaling: bool = True
    grayscale_min: float = 0.0
    grayscale_max: float = 60.0
    multiplicator: float = 1.0
    addend: float = 0.0

    # --- geometric post-processing ---
    bscan_flip: bool = False          # cuda_code.cu:787-807
    sinusoidal_correction: bool = False  # cuda_code.cu:491-521

    # --- post-process background removal (cuda_code.cu:743-767) ---
    post_background_removal: bool = False
    post_background_weight: float = 1.0
    post_background_offset: float = 0.0

    # --- build knobs (no reference equivalent) ---
    # Apply the resampler as a sparse-matrix GEMM (recommended); False
    # uses an explicit gather formulation.
    resample_via_matmul: bool = True
    # Compute dtype of the spectral prep chain. float32 matches reference
    # numerics; bfloat16 trades PSNR for speed.
    compute_dtype: str = "float32"
    # Precision ladder for float32 GEMMs.  What each rung computes on an
    # NVIDIA H100:
    #   "default": one tensor-core pass with TF32 operands (10-bit
    #              mantissa, ~2^-11 relative); on the CPU, exact float32
    #   "high":    3 bf16 products of a manual operand split
    #              (ops/fold.dot_split), ~2^-16 relative
    #   "highest": 5 bf16 products, ~2^-24 relative (true-f32 grade)
    # The split rungs are computed the same way on every backend, so their
    # output does not depend on how a backend lowers lax.Precision.
    # Ignored when compute_dtype="bfloat16".
    matmul_precision: str = "default"
    # Fold the inverse DFT + truncation into the operator as well: the whole
    # pre-FPN chain becomes one complex (n, half) GEMM per line
    # (ops/fold.py).  ~40x the FLOPs of an FFT but one memory pass.
    fft_via_matmul: bool = False
    # Execution of the steady-state fold step: "pallas" runs the
    # hand-written kernel where it is compiled (a GPU) and the plain XLA
    # form elsewhere; "xla" always runs the plain XLA form.
    fold_backend: str = "pallas"
    # Storage dtype of the processed magnitude volume.  "bfloat16" halves
    # the per-buffer output write-back and every device->host streaming
    # transfer; the scaled image is display/quantize-grade data, so bf16's
    # ~2-decimal-digit mantissa costs ~45 dB PSNR vs float32 — far above
    # the 8..16-bit quantization applied before display/streaming anyway
    # (cuda_code.cu:943-967).  All arithmetic stays float32; only the final
    # store is narrowed.
    output_dtype: str = "float32"

    def __post_init__(self):
        if self.rolling_average_window < 1:
            raise ValueError("rolling_average_window must be >= 1")
        if self.bscans_for_noise < 1:
            raise ValueError("bscans_for_noise must be >= 1")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16'")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                "matmul_precision must be 'default', 'high' or 'highest'")
        if self.fold_backend not in ("pallas", "xla"):
            raise ValueError("fold_backend must be 'pallas' or 'xla'")
        if self.output_dtype not in ("float32", "bfloat16"):
            raise ValueError("output_dtype must be 'float32' or 'bfloat16'")


def default_full_config() -> ProcConfig:
    """The benchmark configuration of the reference: cubic k-linearization,
    dispersion, windowing, FPN once, log scaling
    (performance/v180/performance_v180.md:20-52).

    ``fft_via_matmul=True``: every exported default runs the planar
    full-fold GEMM (ops/fold.py).
    """
    return ProcConfig(
        resampling=True,
        interpolation=Interpolation.CUBIC,
        windowing=True,
        dispersion=True,
        fpn_mode=FpnMode.ONCE,
        log_scaling=True,
        fft_via_matmul=True,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Curves:
    """Device-side LUTs consumed by the jitted pipeline (all traced).

    Mirrors the reference's device curve buffers d_resampleCurve,
    d_windowCurve, d_phaseCartesian, d_sinusoidalResampleCurve,
    d_postProcBackgroundLine (cuda_code.cu:1082-1122).  ``resample_matrix``
    is the GEMM reformulation of the resample curve: a static
    (n_out, n_in) interpolation operator.
    """

    resample_curve: Optional[jax.Array] = None     # float32[n]
    resample_matrix: Optional[jax.Array] = None    # float32[n, n] (row j = weights)
    depth_op_re: Optional[jax.Array] = None        # float32[n_in, half] full fold
    depth_op_im: Optional[jax.Array] = None        # float32[n_in, half]
    window: Optional[jax.Array] = None             # float32[n]
    phase: Optional[jax.Array] = None              # complex64[n] = exp(+i*phi)
    sinusoidal_curve: Optional[jax.Array] = None   # float32[ascans_per_bscan]
    post_background: Optional[jax.Array] = None    # float32[n//2]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FpnState:
    """Carried state for fixed-pattern-noise removal.

    The reference keeps the mean A-line in a device global plus a host-side
    ``fixedPatternNoiseDetermined`` flag (cuda_code.cu:105, 1521-1524); in the
    functional formulation the jitted step threads this state explicitly.
    """

    #: planar storage (re, im): the fold path never materializes complex64
    mean_line: jax.Array   # float32[2, width] -- [0]=re, [1]=im
    determined: jax.Array  # bool[] -- True once a mean line has been computed

    @staticmethod
    def initial(samples_per_line: int) -> "FpnState":
        return FpnState(
            mean_line=jnp.zeros((2, samples_per_line), jnp.float32),
            determined=jnp.zeros((), jnp.bool_),
        )

    @property
    def mean_line_complex(self) -> jax.Array:
        return jax.lax.complex(self.mean_line[0], self.mean_line[1])

    @staticmethod
    def pack(mean_re: jax.Array, mean_im: jax.Array) -> jax.Array:
        return jnp.stack([mean_re, mean_im])
