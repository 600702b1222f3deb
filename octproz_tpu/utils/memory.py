"""HBM pre-flight: estimate a configuration's device footprint and refuse
clearly before compiling.

Capability-equivalent of the reference's allocateAndInitializeBuffer guard
(octproz_project/octproz/src/cuda_code.cu:975-1015): cudaMemGetInfo is
checked before every allocation and initialization fails with a readable
error instead of a mid-stream OOM.  XLA allocates lazily at first execution,
so without this a too-large (acq, cfg) surfaces as an opaque RESOURCE_EXHAUSTED
after a long compile; the estimate lets the model/engine refuse up front.

The model mirrors the reference's buffer inventory (initializeCuda,
cuda_code.cu:1082-1122) translated to this pipeline's actual residents.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..params import AcqParams, FpnMode, ProcConfig


def estimate_footprint(acq: AcqParams, cfg: ProcConfig,
                       max_in_flight: int = 2) -> Dict[str, int]:
    """Per-component steady-state device footprint in bytes.

    Deliberately conservative (ignores XLA fusion wins, counts double
    buffering of transient operands once per in-flight step).
    """
    n = acq.samples_per_line
    half = acq.output_ascan_length
    lines = acq.ascans_per_buffer
    f = 4  # float32
    in_flight = max(1, max_in_flight)

    comp: Dict[str, int] = {}
    # raw buffers resident on device (H2D of each in-flight step) — sized
    # by the device CONTAINER dtype (a 24-bit source rides in uint32), not
    # the packed file bytes
    raw_container = np.dtype(acq.raw_dtype).itemsize
    comp["raw"] = acq.samples_per_buffer * raw_container * in_flight
    # processed magnitude output per in-flight step
    comp["processed"] = lines * half * f * in_flight

    if cfg.fft_via_matmul:
        # folded-operator GEMM: planar (n, half) re/im operators
        comp["operators"] = 2 * n * half * f
        from ..pallas.depth_scale import implementation

        if (cfg.fpn_mode != FpnMode.OFF
                or implementation("gpu", cfg, acq.bit_depth) != "kernel"):
            # the plain fold form, the FPN-determination branch and
            # CONTINUOUS FPN materialize the planar (re, im) depth volumes
            comp["planar_depth"] = 2 * lines * half * f
    else:
        ops = 0
        if cfg.resampling:
            ops += (n * n * f if cfg.resample_via_matmul else n * f)
        if cfg.windowing:
            ops += n * f
        if cfg.dispersion:
            ops += n * 2 * f  # complex phasor
        comp["operators"] = ops
        # decoded float spectra + complex FFT buffer per step
        comp["spectra"] = lines * n * f
        comp["fft"] = lines * n * 2 * f

    if cfg.fpn_mode != FpnMode.OFF:
        comp["fpn_state"] = 2 * half * f + 3 * 9 * half * f  # mean + segment sums
    if cfg.sinusoidal_correction or cfg.post_background_removal:
        comp["postprocess_tmp"] = lines * half * f
    comp["total"] = sum(comp.values())
    return comp


def device_memory_limit(device=None) -> Optional[int]:
    """Usable device memory in bytes, or None when unknown (e.g. CPU)."""
    import jax

    try:
        device = device or jax.devices()[0]
        stats = device.memory_stats() or {}
    except Exception:
        return None
    return stats.get("bytes_limit") or stats.get("bytes_reservable_limit")


def preflight_check(acq: AcqParams, cfg: ProcConfig, max_in_flight: int = 2,
                    device=None, limit_bytes: Optional[int] = None,
                    safety: float = 0.9) -> Dict[str, int]:
    """Raise MemoryError (with the component breakdown) when the estimated
    footprint exceeds ``safety`` x the device memory.  Returns the estimate.
    Unknown device memory (CPU, exotic backends) => check is skipped.
    """
    comp = estimate_footprint(acq, cfg, max_in_flight)
    limit = limit_bytes if limit_bytes is not None \
        else device_memory_limit(device)
    if limit is None:
        return comp
    budget = int(limit * safety)
    if comp["total"] > budget:
        detail = ", ".join(f"{k}={v / 1e6:.1f} MB" for k, v in comp.items()
                           if k != "total")
        raise MemoryError(
            f"configuration needs ~{comp['total'] / 1e6:.0f} MB of device "
            f"memory but only {budget / 1e6:.0f} MB is usable "
            f"({limit / 1e6:.0f} MB x {safety:.0%} safety): {detail}. "
            f"Reduce bscans_per_buffer/max_in_flight or disable stages "
            f"(cuda_code.cu:975-1015 analog).")
    return comp
