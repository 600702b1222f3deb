"""Fidelity harness tests: PSNR/SSIM math + the checked-in golden pair.

The golden pair (tests/data/golden_pair_*) pins the jitted pipeline to the
float64 NumPy-oracle output — the CI stand-in for the BASELINE's
figshare-volume PSNR bound (reference: README.md:70-72,
docs/docs/processing.md:134-146).  Regenerate with
scripts/make_golden_pair.py only on intentional numerics changes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from octproz_tpu import curves as curves_mod, pipeline
from octproz_tpu.params import (AcqParams, FpnMode, Interpolation, ProcConfig,
                                WindowType)
from octproz_tpu.utils.fidelity import (compare_volumes, load_volume, psnr,
                                        ssim)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


# ---------------------------------------------------------------------------
# metric math
# ---------------------------------------------------------------------------

def test_psnr_identity_is_inf(rng):
    a = rng.normal(size=(4, 8, 8))
    assert psnr(a, a) == float("inf")


def test_psnr_known_noise(rng):
    ref = np.zeros((16, 16))
    got = ref + 0.1  # MSE = 0.01, range -> default 1.0 when ref is flat
    assert abs(psnr(got, ref, data_range=1.0) - 20.0) < 1e-9


def test_ssim_identity_is_one(rng):
    a = rng.normal(size=(32, 32))
    assert ssim(a, a) == pytest.approx(1.0, abs=1e-9)


def test_ssim_decreases_with_noise(rng):
    a = rng.normal(size=(64, 64))
    s1 = ssim(a + 0.01 * rng.normal(size=a.shape), a)
    s2 = ssim(a + 0.5 * rng.normal(size=a.shape), a)
    assert 0.0 < s2 < s1 < 1.0


def test_compare_volumes_reports_worst_bscan(rng):
    ref = rng.normal(size=(4, 16, 16))
    got = ref.copy()
    got[2] += 0.5  # corrupt one B-scan
    res = compare_volumes(got, ref)
    assert res.worst_bscan == 2
    assert res.min_bscan_psnr_db < res.psnr_db
    assert res.n_bscans == 4


def test_load_volume_validates_size(tmp_path):
    p = tmp_path / "small.raw"
    np.zeros(10, np.float32).tofile(p)
    with pytest.raises(ValueError, match="samples"):
        load_volume(str(p), (4, 4, 4))


def test_load_volume_normalizes_uints(tmp_path):
    p = tmp_path / "q.raw"
    np.array([0, 32767, 65535], np.uint16).tofile(p)
    v = load_volume(str(p), (1, 1, 3), dtype="uint16")
    np.testing.assert_allclose(v.ravel(), [0.0, 32767 / 65535, 1.0])


# ---------------------------------------------------------------------------
# golden pair
# ---------------------------------------------------------------------------

def _golden():
    with open(os.path.join(DATA, "golden_pair.json")) as f:
        meta = json.load(f)
    acq = AcqParams(samples_per_line=meta["samples"],
                    ascans_per_bscan=meta["ascans"],
                    bscans_per_buffer=meta["bscans"],
                    bit_depth=meta["bit_depth"])
    cfg = ProcConfig(
        bitshift=meta["bitshift"],
        resampling=True, interpolation=Interpolation(meta["interpolation"]),
        windowing=True, dispersion=True,
        fpn_mode=FpnMode(meta["fpn_mode"]),
        bscans_for_noise=meta["bscans_for_noise"],
        log_scaling=meta["log_scaling"],
        grayscale_min=meta["grayscale_min"],
        grayscale_max=meta["grayscale_max"],
    )
    raw = np.fromfile(os.path.join(DATA, "golden_pair_input.raw"),
                      np.uint16).reshape(acq.buffer_shape)
    ref = load_volume(os.path.join(DATA, "golden_pair_ref.raw"),
                      tuple(meta["ref_shape"]))
    return meta, acq, cfg, raw, ref


@pytest.mark.parametrize("variant", ["gather", "fold_xla", "fold_pallas"])
def test_golden_pair_psnr_bound(variant, kernel_interpret):
    """Every execution path must stay within the PSNR bound of the float64
    oracle output — the enforced analog of the figshare comparison."""
    import dataclasses

    meta, acq, cfg, raw, ref = _golden()
    if variant == "fold_xla":
        cfg = dataclasses.replace(cfg, fft_via_matmul=True, fold_backend="xla")
    elif variant == "fold_pallas":
        # the kernel's 3-product split rung (the kernel_interpret fixture
        # runs it in the Pallas interpreter)
        cfg = dataclasses.replace(cfg, fft_via_matmul=True,
                                  fold_backend="pallas",
                                  matmul_precision="high")
    cv = curves_mod.make_curves(
        acq, cfg, resample_coeffs=tuple(meta["resample_coeffs"]),
        dispersion_coeffs=tuple(meta["dispersion_coeffs"]),
        window_type=WindowType(meta["window_type"]))
    step = pipeline.make_step(acq, cfg)
    got, _ = step(jnp.asarray(raw), cv, pipeline.initial_fpn_state(acq))
    res = compare_volumes(np.asarray(got), ref)
    # float32 vs float64 reference: expect way above any real-data SNR bound
    assert res.psnr_db >= 60.0, res
    assert res.min_bscan_psnr_db >= 55.0, res
    assert res.mean_ssim >= 0.99, res


def test_compare_cli_golden_pair(tmp_path, capsys):
    """End-to-end through the CLI: process-equivalent output vs the golden
    reference, pass and fail thresholds."""
    from octproz_tpu.cli import main

    meta, acq, cfg, raw, ref = _golden()
    cv = curves_mod.make_curves(
        acq, cfg, resample_coeffs=tuple(meta["resample_coeffs"]),
        dispersion_coeffs=tuple(meta["dispersion_coeffs"]),
        window_type=WindowType(meta["window_type"]))
    step = pipeline.make_step(acq, cfg)
    got, _ = step(jnp.asarray(raw), cv, pipeline.initial_fpn_state(acq))
    got_path = tmp_path / "got.raw"
    np.asarray(got).astype(np.float32).tofile(got_path)

    args = [str(got_path), os.path.join(DATA, "golden_pair_ref.raw"),
            "--bscans", str(meta["ref_shape"][0]),
            "--ascans", str(meta["ref_shape"][1]),
            "--depth", str(meta["ref_shape"][2])]
    rc = main(["compare"] + args + ["--min-psnr", "60"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and out["passed"] and out["psnr_db"] >= 60.0

    rc = main(["compare"] + args + ["--min-psnr", "1000"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and not out["passed"]


def test_compare_cli_quantized_reference(tmp_path, capsys):
    """A uint8-quantized reference (the streamed/recorded form,
    floatToOutput cuda_code.cu:943-967) round-trips through --ref-dtype with
    --clip01."""
    from octproz_tpu.cli import main

    rng = np.random.default_rng(3)
    vol = np.clip(rng.normal(0.5, 0.2, size=(2, 8, 16)), 0, 1)
    got_path, ref_path = tmp_path / "g.raw", tmp_path / "r.raw"
    vol.astype(np.float32).tofile(got_path)
    np.round(vol * 255).astype(np.uint8).tofile(ref_path)
    rc = main(["compare", str(got_path), str(ref_path),
               "--bscans", "2", "--ascans", "8", "--depth", "16",
               "--ref-dtype", "uint8", "--clip01", "--min-psnr", "40"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and out["psnr_db"] >= 40.0


def test_snr_bound_anchor_small_geometry(tmp_path):
    """CI-scale run of the full-geometry fidelity anchor
    (scripts/fullgeom_fidelity.py;): derives the reference
    SNR bound quantitatively (oracle on quantized codes vs on the analog
    interferogram), measures each precision rung against the float64
    oracle, and wires the `cli compare` gate on the saved pair.  The
    full-geometry artifact FIDELITY_r04.json is the same code at
    1024x512x256."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(DATA), "..", "scripts"))
    import fullgeom_fidelity as fg

    report = fg.run(samples=256, ascans=64, bscans=8,
                    save_pair_dir=str(tmp_path),
                    rungs=["bfloat16", "highest"])
    bound = report["snr_bound_db"]
    # the bound is a finite acquisition-noise number, not a degenerate pin
    assert 30.0 < bound < 90.0
    # the highest rung's numerics error is below the quantization noise of
    # the acquisition itself: "within the reference SNR bound"
    assert report["rungs"]["highest"]["within_reference_snr_bound"]
    assert report["rungs"]["highest"]["psnr_db"] > bound + 10
    # bf16 is the throughput rung; it must NOT falsely claim the bound
    assert not report["rungs"]["bfloat16"]["within_reference_snr_bound"]
    # the CLI gate ran against the saved pair and passed at the bound
    assert report["cli_compare"]["passed"]
    assert os.path.exists(report["pair"]["oracle"])
    # FPN-ON rungs (r5): with the tie-banded argmin the end-to-end chain
    # carries the rung's grade — highest stays within the bound WITH FPN,
    # where the r4 exact-argmin chaos capped it far below
    assert report["rungs_fpn_on"]["highest"]["within_reference_snr_bound"]
    assert report["rungs_fpn_on"]["highest"]["psnr_db"] > bound + 10
