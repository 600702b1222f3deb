"""PSNR gate on the figshare SS-OCT test dataset: one command from
dataset-on-disk to a fidelity verdict.

The reference's QA anchor is this recorded volume
(/root/reference/README.md:70-72, performance/v100/performance_v100.md:9,
101: 12-bit, recorded 1664 samples/A-scan, 512 A-scans/B-scan, 256
B-scans).  The gate replays the first buffers through the jitted pipeline
at the in-SNR-bound precision rung and scores display-domain PSNR against
the float64 NumPy oracle (tests/oracle.py) on the SAME data — the
real-data complement of the synthetic golden pair.  It prints ONE JSON
line with the verdict against the 50.6 dB acquisition quantization-noise
bound (FIDELITY artifact).

Runs automatically when the dataset exists (tests/test_figshare_gate.py);
skips LOUDLY when it doesn't (zero-egress build environments — fetch with
scripts/fetch_figshare.py from a networked machine).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

SNR_BOUND_DB = 50.6  # FIDELITY artifact: 12-bit quantization-noise floor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def find_dataset(data_dir: str):
    """The dataset .raw file, or None with a loud reason."""
    if not os.path.isdir(data_dir):
        return None, (f"dataset directory {data_dir!r} does not exist — run "
                      f"`python scripts/fetch_figshare.py --dir {data_dir}` "
                      f"on a networked machine")
    raws = sorted(glob.glob(os.path.join(data_dir, "*.raw")),
                  key=os.path.getsize, reverse=True)
    if not raws:
        return None, (f"no .raw file in {data_dir!r} — run "
                      f"`python scripts/fetch_figshare.py --dir {data_dir}`")
    return raws[0], None


def run_gate(path: str, samples: int = 1664, ascans: int = 512,
             bscans_per_buffer: int = 16, n_buffers: int = 4,
             precision: str = "high", bitshift: bool = False) -> dict:
    """Process ``n_buffers`` of the dataset and PSNR-score vs the oracle."""
    import jax

    jax.config.update("jax_platforms", "cpu")  # beside the float64 oracle
    import numpy as np

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    from octproz_tpu import curves as curves_mod, pipeline
    from octproz_tpu.io.source import VirtualOctSource
    from octproz_tpu.params import (AcqParams, FpnMode, Interpolation,
                                    ProcConfig, WindowType)

    acq = AcqParams(samples_per_line=samples, ascans_per_bscan=ascans,
                    bscans_per_buffer=bscans_per_buffer,
                    buffers_per_volume=n_buffers, bit_depth=12)
    cfg = ProcConfig(bitshift=bitshift, resampling=True,
                     interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.ONCE,
                     bscans_for_noise=bscans_per_buffer, log_scaling=True,
                     fft_via_matmul=True, matmul_precision=precision)
    n1 = float(samples - 1)
    curves = curves_mod.make_curves(
        acq, cfg, resample_coeffs=(0.0, n1, 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
        window_type=WindowType.HANNING)
    src = VirtualOctSource(path, acq, total_buffers_to_acquire=n_buffers)

    step = pipeline.make_step(acq, cfg)
    state = pipeline.initial_fpn_state(acq)
    fpn_lines = cfg.bscans_for_noise * ascans
    mses, n_px = [], 0
    for i, raw in enumerate(src.buffers()):
        got, state = step(raw, curves, state)
        if i == 0:
            # oracle FPN mean from the SAME determination lines (banded
            # argmin — tests/oracle.py matches ops/fpn.py)
            z = oracle.ifft_unnormalized(oracle.prep(
                (oracle.resample_fast(
                    oracle.decode(np.asarray(raw), 12, bitshift),
                    np.asarray(curves.resample_curve), "cubic")),
                np.asarray(curves.window), np.asarray(curves.phase)))
            mean_line = oracle.min_variance_mean(
                z.reshape(-1, z.shape[-1])[:fpn_lines])
        want, _ = oracle.full_pipeline(
            np.asarray(raw), 12, bitshift=bitshift,
            resample_curve=np.asarray(curves.resample_curve),
            interpolation="cubic", window=np.asarray(curves.window),
            phase=np.asarray(curves.phase),
            fpn_lines=fpn_lines, fpn_mean=mean_line,
            log_scaling=True, gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
            addend=cfg.addend, coeff=cfg.multiplicator, fast=True)
        g = np.clip(np.asarray(got, np.float64), 0, 1)
        w = np.clip(np.asarray(want, np.float64), 0, 1)
        mses.append(float(np.mean((g - w) ** 2)) * g.size)
        n_px += g.size
    mse = sum(mses) / n_px
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-30))
    return {
        "dataset": os.path.basename(path),
        "geometry": {"samples": samples, "ascans": ascans,
                     "bscans_per_buffer": bscans_per_buffer,
                     "buffers": n_buffers},
        "matmul_precision": precision,
        "psnr_db": round(psnr, 1),
        "snr_bound_db": SNR_BOUND_DB,
        "within_bound": bool(psnr >= SNR_BOUND_DB),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=os.environ.get("OCTPROZ_FIGSHARE_DIR",
                                                   "data/figshare"))
    p.add_argument("--samples", type=int, default=1664,
                   help="1664 = the honest recorded geometry "
                        "(performance_v100.md:101); 1024 replicates the "
                        "reference's benchmark framing")
    p.add_argument("--ascans", type=int, default=512)
    p.add_argument("--bscans-per-buffer", type=int, default=16)
    p.add_argument("--buffers", type=int, default=4)
    p.add_argument("--precision", default="high",
                   choices=["default", "high", "highest"])
    p.add_argument("--bitshift", action="store_true")
    args = p.parse_args()
    path, reason = find_dataset(args.dir)
    if path is None:
        print(json.dumps({"skipped": True, "reason": reason}))
        return 2
    print(json.dumps(run_gate(path, samples=args.samples,
                              ascans=args.ascans,
                              bscans_per_buffer=args.bscans_per_buffer,
                              n_buffers=args.buffers,
                              precision=args.precision,
                              bitshift=args.bitshift)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
