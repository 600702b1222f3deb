"""Smoke test of the FD-OCT chain on one NVIDIA GPU (or four with --multi).

    python chip_smoke.py            # one card: kernels, main path, CLI
    python chip_smoke.py --multi    # four cards: the B-scan-sharded stream

Phases (one process; any failed check exits non-zero):

* device   — JAX must report a GPU; prints kind, count, JAX version,
  XLA_FLAGS and the card's name and power limit.
* kernels  — the depth/scale kernel (pallas/depth_scale.py) compiled for
  the card per precision rung at 1024- and 1664-sample widths, 8192 lines:
  compile time, memory analysis, agreement with the plain XLA form
  (<= 1e-3 display units on finite entries: same products, only the
  summation order differs) and FPN-off PSNR against the float64 oracle
  (tests/oracle.py) at or above the rung's gate.
* main     — 1024 x 512 x 256, 12-bit, the benchmark chain, on a volume
  generated from a seed with reflectors at known depths: FdOctModel
  (FPN determination, fused steady state, batch chunk), StreamingEngine
  (upload feeder, quantized fetch, chunk 4), the CLI ``process`` and
  ``replay`` commands, the 1664-sample geometry on the packed-12 wire, and
  the golden pair's full-chain PSNR of the "high" rung against 50.6 dB.
* multi    — (--multi only, alone) FdOctModel over a 4-card B-scan mesh on
  the uint16 and packed-12 wires against single-card make_step.

The last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: Raw volumes for the CLI phase; inside the checkout, removed at the end.
WORK = os.path.join(REPO, ".smoke_data")
IN_BOUND_SNR_DB = 50.6
#: Rung name -> ProcConfig changes, and its oracle-PSNR gate (bench.py).
RUNGS = {"bf16": (dict(compute_dtype="bfloat16"), "default"),
         "f32": (dict(), "default"),
         "high": (dict(matmul_precision="high"), "high"),
         "highest": (dict(matmul_precision="highest"), "highest")}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)
    log(f"  ok: {what}")


def psnr(got, want) -> float:
    g = np.clip(np.asarray(got, np.float64), 0, 1)
    w = np.clip(np.asarray(want, np.float64), 0, 1)
    return float(10 * np.log10(1.0 / max(np.mean((g - w) ** 2), 1e-30)))


#: Why the depth-0 bin may hold -inf: with no dispersion its imaginary part
#: is exactly zero, so a real part that cancels exactly against the FPN
#: mean line gives log10(0) = -inf, as in the reference; a last-bit
#: difference decides where.  Every other bin must be finite.
DC_NOTE = "depth bin 0 excepted"


def finite_max_abs(a, b) -> float:
    """Max |a - b| over the entries finite in both; outside depth bin 0
    both must be finite at the same entries, and nothing may be NaN."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    odd = int((np.isfinite(a[..., 1:]) != np.isfinite(b[..., 1:])).sum())
    check(odd == 0 and not (np.isnan(a).any() or np.isnan(b).any()),
          f"same finite entries, no NaN ({DC_NOTE})")
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max())


# -- device --------------------------------------------------------------------

def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX reports {devs[0].platform}",
              file=sys.stderr)
        sys.exit(1)
    log(f"device: {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi reads the card")
    for line in smi.stdout.strip().splitlines():
        log(line)
    return devs


# -- synthetic data --------------------------------------------------------------

def depths_for(n: int):
    return [n // 10, n // 4, (2 * n) // 5]


def make_buffers(acq, n_buffers: int, seed: int, left_align: bool):
    """Raw buffers with reflectors at ``depths_for(n)`` in every B-scan but
    the first (which holds background only, so FPN ONCE, determined on it,
    leaves the reflectors standing)."""
    n = acq.samples_per_line
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    spec = np.full(n, 2000.0)
    for d, a in zip(depths_for(n), (600.0, 400.0, 250.0)):
        spec = spec + a * np.cos(2 * np.pi * d * k / n)
    # separate noise for the background B-scan: a reflector B-scan sharing
    # its noise would cancel against the FPN mean to an exact zero (-inf)
    bg = np.clip(2000.0 + rng.normal(0, 5, (8, acq.ascans_per_bscan, n)),
                 0, 4095).astype(np.uint16)
    refl = np.clip(spec + rng.normal(0, 5, (8, acq.ascans_per_bscan, n)),
                   0, 4095).astype(np.uint16)
    out = []
    for b in range(n_buffers):
        buf = np.empty(acq.buffer_shape, np.uint16)
        buf[0] = bg[b % 8]
        buf[1:] = refl[(b + np.arange(1, acq.bscans_per_buffer)) % 8]
        out.append(buf << 4 if left_align else buf)
    return out


def identity_klin(n: int) -> dict:
    """FdOctModel curve kwargs: identity k-linearization (the CLI default);
    dispersion coefficients stay zero."""
    return dict(resample_coeffs=(0.0, n - 1.0, 0.0, 0.0))


def check_peaks(vol, n: int, what: str) -> None:
    """Reflector peaks above the A-scan's median at every seeded depth."""
    vol = np.asarray(vol, np.float32)
    ok = True
    for b in (1, vol.shape[0] // 2, vol.shape[0] - 1):
        for a in (0, vol.shape[1] // 2):
            ascan = vol[b, a]
            med = np.median(ascan)
            ok &= all(ascan[d - 4:d + 5].max() > med + 0.15
                      for d in depths_for(n))
    bad = int((~np.isfinite(vol[..., 1:])).sum())
    check(bool(ok) and not np.isnan(vol).any() and bad == 0,
          f"{what}: finite ({DC_NOTE}), peaks at depths {depths_for(n)}")


# -- kernels -----------------------------------------------------------------------

def phase_kernels():
    import jax
    import jax.numpy as jnp

    import bench
    from octproz_tpu import curves as curves_mod
    from octproz_tpu.ops import fold
    from octproz_tpu.pallas import depth_scale as ds
    from octproz_tpu.params import (AcqParams, FpnMode, WindowType,
                                    default_full_config)

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    log("kernels: depth/scale kernel vs plain XLA vs float64 oracle "
        "(FPN off, 8192 lines)")
    for n in (1024, 1664):
        acq = AcqParams(samples_per_line=n, ascans_per_bscan=512,
                        bscans_per_buffer=16, bit_depth=12)
        base = dataclasses.replace(default_full_config(), fpn_mode=FpnMode.OFF)
        curves = curves_mod.make_curves(
            acq, base, resample_coeffs=(0.0, n - 1.0, 20.0, -10.0),
            dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
            window_type=WindowType.HANNING)
        raw = np.random.default_rng(n).integers(
            0, 4096, acq.buffer_shape).astype(np.uint16)
        want, _ = oracle.full_pipeline(
            raw, 12, resample_curve=np.asarray(curves.resample_curve),
            interpolation="cubic", window=np.asarray(curves.window),
            phase=np.asarray(curves.phase), log_scaling=True,
            gmin=base.grayscale_min, gmax=base.grayscale_max,
            addend=base.addend, coeff=base.multiplicator, fast=True)
        raw_dev = jnp.asarray(raw)
        mean = jnp.zeros((2, acq.output_ascan_length), jnp.float32)
        for rung, (kw, gate) in RUNGS.items():
            cfg = dataclasses.replace(base, **kw)
            impl = ds.implementation("gpu", cfg, acq.bit_depth)
            f = jax.jit(lambda r, cfg=cfg: ds.fused_depth_scale(
                r, curves.depth_op_re, curves.depth_op_im, mean, acq, cfg))
            t0 = time.perf_counter()
            compiled = f.lower(raw_dev).compile()
            compile_s = time.perf_counter() - t0
            got = np.asarray(compiled(raw_dev))
            p = psnr(got, want)
            log(f" {n}x{acq.output_ascan_length} {rung} [{impl}]: compile "
                f"{compile_s:.2f} s, oracle PSNR {p:.2f} dB (gate "
                f"{bench.ORACLE_GATE_DB[gate]})")
            log(f"   memory: {compiled.memory_analysis()}")
            check(p >= bench.ORACLE_GATE_DB[gate],
                  f"{n}/{rung} oracle PSNR {p:.2f} >= gate")
            if impl != "kernel":
                continue
            check("triton" in compiled.as_text().lower(),
                  f"{n}/{rung} runs a compiled Triton kernel")
            plain = np.asarray(jax.jit(lambda r, cfg=cfg: fold.depth_scale(
                r, curves.depth_op_re, curves.depth_op_im, mean, acq,
                cfg))(raw_dev))
            d = finite_max_abs(got, plain)
            check(d <= 1e-3, f"{n}/{rung} kernel vs plain XLA max |diff| "
                             f"{d:.2e} <= 1e-3")


# -- main path --------------------------------------------------------------------

def _time_steps(model, bufs, iters: int = 20) -> float:
    import jax

    dev = [model.put_buffer(b) for b in bufs[:2]]
    jax.block_until_ready(model.process_buffer(dev[0]))
    t0 = time.perf_counter()
    for i in range(iters):
        out = model.process_buffer(dev[i % 2])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1e3 / iters


def _engine(model, bufs, chunk: int, wire: str = "uint16"):
    import jax

    from octproz_tpu.ops.quantize import dequantize
    from octproz_tpu.runtime import StreamingEngine

    got = []
    # compile outside the timed run: the per-buffer step and the chunk step
    first = (model.put_packed_buffer(bufs[0]) if wire == "packed12"
             else model.put_buffer(bufs[0]))
    jax.block_until_ready(model.process_buffer(first))
    if chunk > 1:
        jax.block_until_ready(model.process_chunk(
            jax.numpy.stack([first] * chunk)))

    class Ring:
        def buffers(self):
            yield from bufs

    eng = StreamingEngine(model, Ring(), stream_to_host=True,
                          upload_prefetch=True, dispatch_chunk=chunk,
                          wire_format=wire,
                          on_processed=lambda h, nr: got.append(h))
    t0 = time.perf_counter()
    n = eng.run()
    el = time.perf_counter() - t0
    check(n == len(bufs) and len(got) == len(bufs),
          f"StreamingEngine ({wire}, chunk {chunk}) processed and fetched "
          f"{n}/{len(bufs)} buffers")
    log(f"   engine {wire} chunk {chunk}: {el * 1e3 / n:.2f} ms/buffer "
        f"host-fed, quantized fetch of every buffer (information)")
    return [dequantize(g, model.acq.bit_depth) for g in got]


def _cli(argv):
    from octproz_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    log(f"   $ octproz_tpu {' '.join(os.path.basename(a) for a in argv)}"
        f" -> rc {rc}")
    check(rc == 0, f"CLI {argv[0]} exits 0")
    return out


def phase_main():
    import bench
    from octproz_tpu import native
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.models.presets import benchmark_config
    from octproz_tpu.params import AcqParams, FpnMode
    from octproz_tpu.utils import configmap
    from octproz_tpu.utils.settings import SettingsManager

    n = 1024
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=512,
                    bscans_per_buffer=256, bit_depth=12)
    bufs = make_buffers(acq, 6, seed=11, left_align=True)
    lines = acq.ascans_per_buffer
    for rung in ("f32", "high"):
        cfg = dataclasses.replace(benchmark_config(), **RUNGS[rung][0])
        log(f"main: {n}x512x256 benchmark chain, rung {rung}")
        model = FdOctModel(acq, cfg, **identity_klin(n))
        outs = [model.process_buffer(b) for b in bufs[:3]]
        check(bool(model.fpn_state.determined), "FPN determined by buffer 0")
        for i, o in enumerate(outs):
            check_peaks(o, n, f"process_buffer #{i} "
                              f"({'FPN determination' if i == 0 else 'steady'})")
        check(model._batch_ready(), "batch chunk path is taken")
        chunk = np.asarray(model.process_chunk(np.stack(bufs[2:6])))
        check(chunk.shape == (4,) + acq.processed_buffer_shape, "chunk output shape")
        d = finite_max_abs(chunk[0], outs[2])
        check(d <= 1e-5, f"batch chunk == per-buffer step (max |diff| "
                         f"{d:.1e})")
        for i in range(1, 4):
            check_peaks(chunk[i], n, f"batch chunk buffer {i}")
        ms = _time_steps(model, bufs)
        log(f"   steady state: {ms:.3f} ms/buffer, {lines / ms / 1e3:.1f} MHz "
            f"device-resident (information)")
        for c in (1, 4):
            streamed = _engine(FdOctModel(acq, cfg, **identity_klin(n)), bufs,
                               chunk=c)
            check_peaks(streamed[-1], n, "streamed quantized buffer")

    log("main: golden pair, full chain, rung high")
    g = bench.golden_psnr(dataclasses.replace(benchmark_config(),
                                              matmul_precision="high"))
    check(g >= IN_BOUND_SNR_DB,
          f"golden PSNR {g:.2f} dB >= {IN_BOUND_SNR_DB} dB bound")

    os.makedirs(WORK, exist_ok=True)
    log("main: CLI process / replay on a 6-buffer volume file")
    path = os.path.join(WORK, "vol1024.raw")
    with open(path, "wb") as f:
        for b in bufs:
            b.tofile(f)
    out_path = os.path.join(WORK, "out1024.raw")
    geo = ["--preset", "benchmark", "--matmul-precision", "high"]
    _cli(["process", path, *geo, "--output", out_path])
    vol = np.fromfile(out_path, np.float32).reshape(
        -1, acq.ascans_per_bscan, acq.output_ascan_length)
    check(vol.shape[0] == 6 * 256, "process wrote 6 buffers")
    check_peaks(vol[256:512], n, "CLI process buffer 1")
    rep = json.loads(_cli(["replay", path, *geo, "--stream", "--chunk", "4",
                           "--max-buffers", "6"])
                     .strip().splitlines()[-1])
    check(rep["buffers_processed"] == 6, "replay processed 6 buffers")
    del bufs, vol

    n = 1664
    log(f"main: {n}x512x256 on the packed-12 wire, rung high")
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=512,
                    bscans_per_buffer=256, bit_depth=12)
    bufs = make_buffers(acq, 5, seed=13, left_align=False)
    wire = [native.pack_uint12(b.reshape(-1)) for b in bufs]
    cfg = dataclasses.replace(benchmark_config(), bitshift=False,
                              matmul_precision="high")
    model = FdOctModel(acq, cfg, **identity_klin(n))
    unpacked = model.put_packed_buffer(wire[1])
    check(bool((np.asarray(unpacked) == bufs[1]).all()),
          "packed-12 device unpack == the samples")
    streamed = _engine(model, wire, chunk=4, wire="packed12")
    check_peaks(streamed[-1], n, "1664 packed-12 streamed buffer")
    path = os.path.join(WORK, "vol1664.p12")
    with open(path, "wb") as f:
        for w in wire:
            w.tofile(f)
    ini = os.path.join(WORK, "packed1664.ini")
    sm = SettingsManager(ini)
    configmap.to_settings(sm, acq, cfg, source_kwargs={"packed_12bit": True})
    sm.save()
    rep = json.loads(_cli(["replay", path, "--settings", ini, "--packed-12bit",
                           "--keep-packed", "--wire-format", "packed12",
                           "--stream", "--chunk", "4", "--max-buffers", "5"])
                     .strip().splitlines()[-1])
    check(rep["buffers_processed"] == 5, "replay packed-12 processed 5 buffers")


# -- multi ----------------------------------------------------------------------------

def phase_multi():
    import jax

    from octproz_tpu import native, pipeline
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.models.presets import benchmark_config
    from octproz_tpu.parallel import make_mesh
    from octproz_tpu.params import AcqParams

    devs = jax.devices()
    check(len(devs) == 4, f"four cards visible (got {len(devs)})")
    mesh = make_mesh()
    log(f"multi: mesh {dict(mesh.shape)} over "
        f"{[d.id for d in mesh.devices.flat]}")
    # The sharded determination buffer sums its FPN statistics with psum
    # (NCCL) instead of one device's reduction: the mean line differs from
    # the single card's in its last bits (summation order).  Log scaling
    # magnifies that wherever a line nearly cancels against the mean, so a
    # few entries differ by a lot while the image does not: the volumes are
    # compared by PSNR against a 60 dB floor (the 12-bit acquisition noise
    # bounds display PSNR at 50.6 dB), and the mean lines to 1e-4 relative.
    floor_db, mean_rtol = 60.0, 1e-4
    for n, wire in ((1024, "uint16"), (1024, "packed12"), (1664, "packed12")):
        acq = AcqParams(samples_per_line=n, ascans_per_bscan=512,
                        bscans_per_buffer=256, bit_depth=12)
        cfg = dataclasses.replace(benchmark_config(), bitshift=False,
                                  matmul_precision="high")
        bufs = make_buffers(acq, 3, seed=n, left_align=False)
        sharded = FdOctModel(acq, cfg, mesh=mesh, **identity_klin(n))
        single = FdOctModel(acq, cfg, **identity_klin(n))
        step = pipeline.make_step(acq, cfg)
        state = pipeline.initial_fpn_state(acq)
        for i, b in enumerate(bufs):
            dev = (sharded.put_packed_buffer(native.pack_uint12(b.reshape(-1)))
                   if wire == "packed12" else sharded.put_buffer(b))
            got = sharded.process_buffer(dev)
            want, state = step(single.put_buffer(b), single.curves, state)
            placement = sorted((s.device.id, s.index[0].start, s.index[0].stop)
                               for s in got.addressable_shards)
            log(f"   {n} {wire} buffer {i}: shards (device, bscans) "
                f"{[(d, f'{a}:{e}') for d, a, e in placement]}")
            check(len({d for d, _, _ in placement}) == 4,
                  "the output is spread over four cards")
            g, w = np.asarray(got), np.asarray(want)
            d = finite_max_abs(g, w)
            fin = np.isfinite(g) & np.isfinite(w)
            p = psnr(np.where(fin, g, 0), np.where(fin, w, 0))
            ms, mw = (np.asarray(sharded.fpn_state.mean_line),
                      np.asarray(state.mean_line))
            rel = float(np.abs(ms - mw).max() / np.abs(mw).max())
            log(f"   max |diff| {d:.2e}, entries over 1e-3: "
                f"{int((np.abs(g - w)[fin] > 1e-3).sum())}, mean line "
                f"rel diff {rel:.1e}")
            check(p >= floor_db and rel <= mean_rtol,
                  f"{n} {wire} buffer {i} sharded vs single card: PSNR "
                  f"{p:.1f} dB >= {floor_db}, mean line within {mean_rtol}")
            check_peaks(got, n, f"{n} {wire} sharded buffer {i}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--deadline", type=float, default=1100.0,
                    help="seconds after which a stuck run dumps every "
                         "thread's stack and exits 1")
    args = ap.parse_args()
    faulthandler.dump_traceback_later(args.deadline, exit=True)

    devs = phase_device()
    sys.path.insert(0, REPO)
    from octproz_tpu.cli import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    t0 = time.perf_counter()
    try:
        if args.multi:
            phase_multi()
        else:
            phase_kernels()
            phase_main()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
