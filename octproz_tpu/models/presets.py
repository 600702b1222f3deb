"""Named acquisition/processing presets.

The reference ships configuration implicitly (GUI defaults + the published
benchmark setup, performance/v180/performance_v180.md:20-52, and the figshare
test-volume geometry README.md:70-72); these presets make the common setups
constructible by name, for the CLI and tests.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..params import AcqParams, FpnMode, Interpolation, ProcConfig


def figshare_test_volume() -> AcqParams:
    """The published benchmark volume: 12-bit, 1024 x 512 x 256
    (README.md:70-72; the file on disk actually has 1664 samples/A-scan and
    is read as 1024, performance/v100/performance_v100.md:102)."""
    return AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                     bscans_per_buffer=256, buffers_per_volume=1,
                     bit_depth=12)


def benchmark_config(fold: bool = True) -> ProcConfig:
    """The reference's headline benchmark chain: cubic k-linearization +
    windowing + dispersion + FPN once + log scaling
    (performance/v180/performance_v180.md:20-52), with the 12-in-16-bit
    bitshift the figshare volume needs.  ``fold`` selects the planar
    full-fold GEMM path (ops/fold.py); False runs the staged FFT chain."""
    return ProcConfig(
        bitshift=True,
        resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True,
        fpn_mode=FpnMode.ONCE, log_scaling=True,
        fft_via_matmul=fold,
    )


def minimal_config(fold: bool = True) -> ProcConfig:
    """Bare reconstruction: IFFT + log only (every optional stage off).
    ``fold`` as in :func:`benchmark_config`."""
    return ProcConfig(log_scaling=True, fft_via_matmul=fold)


def handheld_sinusoidal_config(fold: bool = True) -> ProcConfig:
    """Resonant-scanner setup: full chain + bidirectional B-scan flip +
    sinusoidal scan correction (docs/docs/processing.md:150-189).
    ``fold`` as in :func:`benchmark_config`."""
    return ProcConfig(
        bitshift=True,
        background_removal=True,
        resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True,
        fpn_mode=FpnMode.ONCE, log_scaling=True,
        bscan_flip=True, sinusoidal_correction=True,
        fft_via_matmul=fold,
    )


PRESETS: Dict[str, Tuple[AcqParams, ProcConfig]] = {
    "benchmark": (figshare_test_volume(), benchmark_config()),
    "minimal": (figshare_test_volume(), minimal_config()),
    "handheld": (figshare_test_volume(), handheld_sinusoidal_config()),
}
