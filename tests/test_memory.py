"""HBM pre-flight estimate tests (cuda_code.cu:975-1015 analog)."""

import numpy as np
import pytest

from octproz_tpu import AcqParams, FpnMode, Interpolation, ProcConfig
from octproz_tpu.utils.memory import (device_memory_limit, estimate_footprint,
                                      preflight_check)

ACQ = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                bscans_per_buffer=256, bit_depth=12)
CFG = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                 windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                 log_scaling=True, fft_via_matmul=True)


def test_estimate_counts_the_big_residents():
    comp = estimate_footprint(ACQ, CFG, max_in_flight=2)
    # raw: 256 MB/buffer x 2; processed: 256 MB x 2; operators: 4 MB
    assert comp["raw"] == ACQ.bytes_per_buffer * 2
    assert comp["processed"] == ACQ.ascans_per_buffer * 512 * 4 * 2
    assert comp["operators"] == 2 * 1024 * 512 * 4
    assert comp["total"] >= comp["raw"] + comp["processed"]


def test_fused_off_path_has_no_planar_volumes():
    """The depth/scale kernel with FPN off never stores the planar (re, im)
    volumes; the plain form (and the FPN-determination branch) does."""
    import dataclasses
    fused_off = dataclasses.replace(CFG, fpn_mode=FpnMode.OFF,
                                    compute_dtype="bfloat16")
    assert "planar_depth" not in estimate_footprint(ACQ, fused_off)
    for plain in (dataclasses.replace(fused_off, fold_backend="xla"),
                  dataclasses.replace(fused_off, compute_dtype="float32"),
                  dataclasses.replace(fused_off, fpn_mode=FpnMode.ONCE)):
        assert estimate_footprint(ACQ, plain)["planar_depth"] > 0


def test_preflight_raises_with_breakdown():
    with pytest.raises(MemoryError, match="Reduce bscans_per_buffer"):
        preflight_check(ACQ, CFG, limit_bytes=100 * 1024 * 1024)


def test_preflight_passes_with_room():
    comp = preflight_check(ACQ, CFG, limit_bytes=16 * 1024 ** 3)
    assert comp["total"] < 16 * 1024 ** 3


def test_preflight_skips_when_memory_unknown():
    # CPU backend reports no usable limit -> check is a no-op
    comp = preflight_check(ACQ, CFG, limit_bytes=None)
    assert comp["total"] > 0


def test_model_preflight_wired():
    from octproz_tpu.models.fdoct import FdOctModel
    # CPU: unknown memory -> constructor must not raise
    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8,
                    bscans_per_buffer=4, bit_depth=12)
    cfg = ProcConfig(resampling=True, log_scaling=True)
    FdOctModel(acq, cfg, resample_coeffs=(0.0, 63.0, 0.0, 0.0))
