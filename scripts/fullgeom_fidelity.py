"""Full-geometry fidelity anchor + quantitative SNR-bound derivation.

The reference's entire QA is comparison against a recorded SS-OCT volume
(/root/reference/README.md:70-72) and the BASELINE target is "PSNR within
the reference SNR bound" (BASELINE.md:39).  With no network access to the
figshare volume, this script builds the equivalent anchor from the
physics-modeled PhytoOCT device (io/phytooct.py) at the full benchmark
geometry (1024 x 512 x 256) and makes the SNR bound a NUMBER:

**Bound derivation.**  The reference acquires 12-bit samples; its output
fidelity can never exceed the acquisition's own quantization-noise floor.
We have the device model's *analog* interferogram (the float spectrum
before the ADC), so the bound is directly measurable: run the float64
oracle on the quantized 12-bit codes and on the analog signal, and take
the display-domain PSNR between them — exactly the reference's log-scaling
math (/root/reference/docs/docs/processing.md:134-146: i = 20*log10|IFFT|,
then (i - min)/(max - min) windowing).  Any pipeline rung whose PSNR vs
the float64 oracle exceeds this bound contributes numerics error BELOW the
quantization noise of the acquisition itself — unambiguously "within the
reference SNR bound".

Usage:
  python scripts/fullgeom_fidelity.py --out F.json # full geometry -> F.json
  python scripts/fullgeom_fidelity.py --small      # quick small-geometry run

tests/test_fidelity.py runs the same functions at small geometry as the
CI-style gate, including the `cli compare` wiring.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def device_and_volumes(samples=1024, ascans=512, bscans=256, seed=7):
    """Full-geometry PhytoOCT volume: returns (system, raw uint16 codes,
    analog float codes in 12-bit units)."""
    from octproz_tpu.io.phytooct import PhytoDeviceConfig, PortableOctSystem

    dev = PhytoDeviceConfig(samples_per_line=samples, ascans_per_bscan=ascans,
                            bscans_per_buffer=bscans, buffers_per_volume=1,
                            bidirectional=False, seed=seed)
    system = PortableOctSystem(dev)
    model = system.model
    pos = model.scan_positions(False)
    raw = np.empty((bscans, ascans, samples), np.uint16)
    analog = np.empty((bscans, ascans, samples), np.float64)
    for b in range(bscans):
        spec = model._ascan_spectrum(pos, noise_key=b)
        analog[b] = spec * 4096.0                      # analog, 12-bit units
        raw[b] = (spec * 4096.0).astype(np.uint16) << 4  # the device ADC
    return system, raw, analog


def anchor_config(system):
    """The processing chain for the SNR-bound derivation: the device's
    recommended chain with FPN off and no flip (the volume is
    unidirectional here).  The bound compares quantized vs analog inputs,
    whose actual quantization noise can legitimately move the FPN segment
    choice, so the bound instrument keeps FPN out; the FPN-ON fidelity is
    measured separately as first-class rungs (r5: the tie-banded argmin,
    ops/fpn.py, makes the selection perturbation-stable, so the end-to-end
    ladder no longer saturates at segment-choice chaos)."""
    from octproz_tpu.params import FpnMode

    return dataclasses.replace(system.recommended_config(),
                               fpn_mode=FpnMode.OFF, bscan_flip=False)


def oracle_display(x_codes, system, cfg, curves):
    """float64-oracle display output for 12-bit codes (int or analog)."""
    import oracle

    x = np.asarray(x_codes, np.float64)
    out, _ = oracle.full_pipeline(
        x, 12, bitshift=False,  # codes are already in 12-bit units
        resample_curve=np.asarray(curves.resample_curve),
        interpolation=cfg.interpolation.value,
        window=np.asarray(curves.window), phase=np.asarray(curves.phase),
        log_scaling=cfg.log_scaling, gmin=cfg.grayscale_min,
        gmax=cfg.grayscale_max, addend=cfg.addend, coeff=cfg.multiplicator,
        sinusoidal=cfg.sinusoidal_correction, fast=True)
    return np.clip(np.asarray(out, np.float64), 0.0, 1.0)


def derive_snr_bound(system, raw, analog, cfg, curves):
    """Display-domain PSNR between the oracle on quantized codes and on
    the analog signal: the acquisition quantization-noise floor in the
    reference's own output units."""
    from octproz_tpu.utils.fidelity import psnr

    quant = oracle_display(raw >> 4, system, cfg, curves)
    clean = oracle_display(analog, system, cfg, curves)
    return float(psnr(quant, clean, data_range=1.0)), quant


def rung_psnrs(system, raw, ref_display, cfg, curves, rungs=None):
    """PSNR of each precision rung's pipeline output vs the float64-oracle
    display reference, on this process's JAX backend."""
    import jax.numpy as jnp

    from octproz_tpu import pipeline
    from octproz_tpu.utils.fidelity import psnr

    rungs = rungs or ["bfloat16", "default", "high", "highest"]
    state = pipeline.initial_fpn_state(system.acq)
    results = {}
    for rung in rungs:
        c = (dataclasses.replace(cfg, compute_dtype="bfloat16")
             if rung == "bfloat16"
             else dataclasses.replace(cfg, matmul_precision=rung))
        t0 = time.perf_counter()
        step = pipeline.make_step(system.acq, c)
        out, _ = step(jnp.asarray(raw), curves, state)
        got = np.clip(np.asarray(out, np.float64), 0.0, 1.0)
        results[rung] = {
            "psnr_db": round(float(psnr(got, ref_display, data_range=1.0)), 1),
            "seconds": round(time.perf_counter() - t0, 1),
        }
    return results


def fpn_on_rung_psnrs(system, raw, cfg, curves, rungs=None,
                      bscans_for_noise=4):
    """END-TO-END fidelity WITH FPN ENABLED: each rung's
    pipeline output vs the float64 oracle running the SAME FPN chain
    (tests/oracle.py min_variance_mean — the tie-banded selection matching
    ops/fpn.py, so the segment choice is identical across rungs instead of
    chaotic)."""
    import jax.numpy as jnp

    import oracle

    from octproz_tpu import pipeline
    from octproz_tpu.params import FpnMode
    from octproz_tpu.utils.fidelity import psnr

    rungs = rungs or ["bfloat16", "default", "high", "highest"]
    acq = system.acq
    cfg_on = dataclasses.replace(cfg, fpn_mode=FpnMode.ONCE,
                                 bscans_for_noise=bscans_for_noise)
    # oracle consumes the 12-bit code values directly (the pipeline's
    # bitshift handles the <<4 container; same convention as oracle_display)
    x = np.asarray(raw >> 4, np.float64)
    want, _ = oracle.full_pipeline(
        x, 12, bitshift=False,
        resample_curve=np.asarray(curves.resample_curve),
        interpolation=cfg_on.interpolation.value,
        window=np.asarray(curves.window), phase=np.asarray(curves.phase),
        fpn_lines=bscans_for_noise * acq.ascans_per_bscan,
        log_scaling=cfg_on.log_scaling, gmin=cfg_on.grayscale_min,
        gmax=cfg_on.grayscale_max, addend=cfg_on.addend,
        coeff=cfg_on.multiplicator,
        sinusoidal=cfg_on.sinusoidal_correction, fast=True)
    ref = np.clip(np.asarray(want, np.float64), 0.0, 1.0)

    results = {}
    for rung in rungs:
        c = (dataclasses.replace(cfg_on, compute_dtype="bfloat16")
             if rung == "bfloat16"
             else dataclasses.replace(cfg_on, matmul_precision=rung))
        t0 = time.perf_counter()
        step = pipeline.make_step(acq, c)
        out, _ = step(jnp.asarray(raw), curves,
                      pipeline.initial_fpn_state(acq))
        got = np.clip(np.asarray(out, np.float64), 0.0, 1.0)
        results[rung] = {
            "psnr_db": round(float(psnr(got, ref, data_range=1.0)), 1),
            "seconds": round(time.perf_counter() - t0, 1),
        }
    return results


def run(samples=1024, ascans=512, bscans=256, out_json=None,
        save_pair_dir=None, rungs=None):
    import jax

    from octproz_tpu import curves as curves_mod

    t0 = time.perf_counter()
    system, raw, analog = device_and_volumes(samples, ascans, bscans)
    cfg = anchor_config(system)
    curves = curves_mod.make_curves(system.acq, cfg, **system.curve_kwargs())
    print(f"volume generated in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    bound_db, ref_display = derive_snr_bound(system, raw, analog, cfg, curves)
    print(f"SNR bound: {bound_db:.1f} dB", file=sys.stderr)

    rr = rung_psnrs(system, raw, ref_display, cfg, curves, rungs=rungs)
    for name, r in rr.items():
        r["within_reference_snr_bound"] = bool(r["psnr_db"] >= bound_db)

    rr_fpn = fpn_on_rung_psnrs(system, raw, cfg, curves, rungs=rungs)
    for name, r in rr_fpn.items():
        r["within_reference_snr_bound"] = bool(r["psnr_db"] >= bound_db)
    print(f"FPN-on rungs: "
          f"{ {k: v['psnr_db'] for k, v in rr_fpn.items()} }",
          file=sys.stderr)

    report = {
        "platform": jax.devices()[0].platform,
        "platform_note": (
            "rung PSNRs measure the pipeline's numerics on THIS backend; "
            "on a GPU float32 at default precision runs TF32 GEMMs, so "
            "only the high/highest split rungs carry their CPU-grade "
            "fidelity to the card"),
        "device_kind": jax.devices()[0].device_kind,
        "geometry": {"samples": samples, "ascans": ascans, "bscans": bscans},
        "anchor": "PhytoDeviceModel physics volume (io/phytooct.py), "
                  "unidirectional, sinusoidal scan, factory k-lin curve, "
                  "FPN off (argmin chaos excluded)",
        "snr_bound_db": round(bound_db, 1),
        "snr_bound_definition": (
            "display-domain PSNR between the float64 oracle on the 12-bit "
            "quantized codes and on the analog interferogram — the "
            "acquisition quantization-noise floor in the reference's "
            "output units (processing.md:134-146 scaling)"),
        "rungs": rr,
        "rungs_fpn_on": rr_fpn,
        "fpn_on_note": (
            "end-to-end PSNR with FPN ONCE enabled, oracle running the "
            "same tie-banded minimum-variance selection (ops/fpn.py r5): "
            "the rungs now carry their grade through the full chain "
            "instead of saturating at segment-choice chaos (~46-52 dB in "
            "r4)"),
    }

    if save_pair_dir:
        os.makedirs(save_pair_dir, exist_ok=True)
        raw_path = os.path.join(save_pair_dir, "fullgeom_input.raw")
        ref_path = os.path.join(save_pair_dir, "fullgeom_oracle.raw")
        raw.tofile(raw_path)
        ref_display.astype(np.float32).tofile(ref_path)
        report["pair"] = {"input": raw_path, "oracle": ref_path}
        # wire the `cli compare` gate against the saved pair: process the
        # input at the highest rung and gate via the CLI fidelity harness
        report["cli_compare"] = cli_compare_gate(
            system, raw, cfg, curves, ref_path, save_pair_dir,
            min_psnr=bound_db)

    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def cli_compare_gate(system, raw, cfg, curves, ref_path, work_dir,
                     min_psnr):
    """Run the `octproz_tpu compare` CLI as the pass/fail gate: process the
    volume at matmul_precision=highest, save it, and invoke the CLI with
    --min-psnr set to the derived bound."""
    import jax.numpy as jnp

    from octproz_tpu import pipeline
    from octproz_tpu.cli import main as cli_main

    c = dataclasses.replace(cfg, matmul_precision="highest")
    step = pipeline.make_step(system.acq, c)
    out, _ = step(jnp.asarray(raw), curves,
                  pipeline.initial_fpn_state(system.acq))
    got_path = os.path.join(work_dir, "fullgeom_highest.raw")
    np.clip(np.asarray(out, np.float32), 0.0, 1.0).tofile(got_path)
    acq = system.acq
    argv = ["compare", got_path, ref_path,
            "--bscans", str(acq.bscans_per_buffer),
            "--ascans", str(acq.ascans_per_bscan),
            "--depth", str(acq.output_ascan_length),
            "--data-range", "1.0", "--clip01",
            "--min-psnr", str(round(min_psnr, 1))]
    rc = cli_main(argv)
    return {"argv": argv, "returncode": rc, "passed": rc == 0}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true",
                   help="256x64x8 quick run (the CI-test geometry)")
    p.add_argument("--out", default=None)
    p.add_argument("--save-pair", default=None,
                   help="directory for the input/oracle .raw pair "
                        "(also wires the cli compare gate)")
    p.add_argument("--cpu", action="store_true",
                   help="pin jax to the CPU backend")
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.small:
        run(256, 64, 8, out_json=args.out, save_pair_dir=args.save_pair)
    else:
        run(out_json=args.out, save_pair_dir=args.save_pair)


if __name__ == "__main__":
    main()
