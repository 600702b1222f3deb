"""Generate the checked-in golden fidelity pair (tests/data/golden_pair_*).

The pair pins the pipeline's numerics to reference math computed at float64:

* ``golden_pair_input.raw`` — deterministic 12-bit synthetic interferogram
  (multi-reflector fringes + seeded noise), uint16 little-endian.
* ``golden_pair_ref.raw``   — the float64 NumPy oracle (tests/oracle.py,
  numerics of cuda_code.cu:109-767) run on it with the full benchmark chain,
  stored float32.
* ``golden_pair.json``      — geometry + processing config + curve coeffs.

tests/test_fidelity.py re-processes the input with the jitted pipeline and
enforces the PSNR bound via octproz_tpu.utils.fidelity / `octproz_tpu
compare` — the CI stand-in for the figshare-volume comparison
(/root/reference/README.md:70-72).  Re-run this script only when the
numerics change INTENTIONALLY; commit the regenerated pair with the reason.
"""

import json
import os
import sys

import numpy as np

# pure host-math script: never opens the accelerator
import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import oracle  # tests/oracle.py  # noqa: E402

from octproz_tpu import curves as curves_mod  # noqa: E402
from octproz_tpu.params import (AcqParams, FpnMode, Interpolation,  # noqa: E402
                                ProcConfig, WindowType)

META = dict(
    samples=256, ascans=32, bscans=8, bit_depth=12,
    bitshift=True,
    interpolation="cubic",
    resample_coeffs=(0.0, 255.0, 10.0, -4.0),
    window_type="hanning",
    dispersion_coeffs=(0.0, 0.0, 8.0, 0.0),
    fpn_mode="once", bscans_for_noise=2,
    log_scaling=True, grayscale_min=0.0, grayscale_max=60.0,
    seed=20260819,
)


def make_input(meta) -> np.ndarray:
    n, asc, bsc = meta["samples"], meta["ascans"], meta["bscans"]
    rng = np.random.default_rng(meta["seed"])
    k = np.arange(n)
    raw = np.empty((bsc, asc, n))
    for b in range(bsc):
        for a in range(asc):
            s = (28000.0
                 + 9000.0 * np.cos(2 * np.pi * (30 + 0.05 * a) * k / n + 0.02 * b)
                 + 4500.0 * np.cos(2 * np.pi * 72.0 * k / n + 0.3)
                 + 1500.0 * np.cos(2 * np.pi * (9 + 0.01 * b) * k / n))
            raw[b, a] = s
    raw += rng.normal(0, 90.0, raw.shape)
    # 12-bit payload stored in the top bits of a 16-bit container (the
    # bitshift=True digitizer layout, cuda_code.cu:129-147): decode >>4
    return np.clip(raw, 0, 65535).astype(np.uint16)


def main() -> None:
    meta = dict(META)
    acq = AcqParams(samples_per_line=meta["samples"],
                    ascans_per_bscan=meta["ascans"],
                    bscans_per_buffer=meta["bscans"], bit_depth=meta["bit_depth"])
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
    cv = curves_mod.make_curves(
        acq, cfg, resample_coeffs=meta["resample_coeffs"],
        dispersion_coeffs=meta["dispersion_coeffs"],
        window_type=WindowType(meta["window_type"]))

    raw = make_input(meta)
    ref, _ = oracle.full_pipeline(
        raw, acq.bit_depth,
        bitshift=cfg.bitshift,
        resample_curve=np.asarray(cv.resample_curve, np.float64),
        interpolation=cfg.interpolation.value,
        window=np.asarray(cv.window, np.float64),
        phase=np.asarray(cv.phase, np.complex128),
        fpn_lines=cfg.bscans_for_noise * acq.ascans_per_bscan,
        log_scaling=cfg.log_scaling,
        gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
    )
    assert ref.shape == acq.processed_buffer_shape

    out_dir = os.path.join(ROOT, "tests", "data")
    os.makedirs(out_dir, exist_ok=True)
    raw.tofile(os.path.join(out_dir, "golden_pair_input.raw"))
    ref.astype(np.float32).tofile(os.path.join(out_dir, "golden_pair_ref.raw"))
    meta["ref_shape"] = list(ref.shape)
    with open(os.path.join(out_dir, "golden_pair.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote golden pair to {out_dir}: input {raw.nbytes} B, "
          f"ref {ref.size * 4} B")


if __name__ == "__main__":
    main()
