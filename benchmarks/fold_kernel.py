"""Hand-written depth/scale kernel against the plain XLA form, on the card.

For each precision rung it times, at the benchmark geometry
(1024 x 512 x 256, 12-bit, ``default_full_config()``):

* the step alone: ``fused_depth_scale`` with the compiled kernel
  (``fold_backend="pallas"``) against ``fold_backend="xla"``;
* ``make_step``: the jitted per-buffer step in steady state (FPN ONCE,
  determined by a first buffer);
* ``StreamingEngine``: host-fed buffers through the upload feeder;

the last two in turns (kernel, plain, plain, kernel).

    python benchmarks/fold_kernel.py [--rungs bf16,high] [--iters 20]
        [--engine-buffers 24] [--blocks 64x128x64x4x3,...]

Prints one JSON object per measurement and needs a GPU (exits 1 without).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Order of the two implementations in the make_step and engine phases.
ORDER = ("pallas", "xla", "xla", "pallas")

RUNGS = {
    "bf16": dict(compute_dtype="bfloat16"),
    "f32": dict(),
    "high": dict(matmul_precision="high"),
    "highest": dict(matmul_precision="highest"),
}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _time(fn, args_ring, iters: int) -> float:
    """Median-free mean ms per call over ``iters`` calls, synced once."""
    import jax

    out = fn(args_ring[0])
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(args_ring[i % len(args_ring)])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rungs", default="bf16,high")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--engine-buffers", type=int, default=24)
    ap.add_argument("--blocks", default="",
                    help="kernel-alone sweep: BMxBNxBKxWARPSxSTAGES,...")
    ap.add_argument("--bscans", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("fold_kernel: no GPU found", file=sys.stderr)
        return 1

    from octproz_tpu import curves as curves_mod
    from octproz_tpu import pipeline
    from octproz_tpu.cli import enable_compilation_cache
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.ops import fold
    from octproz_tpu.pallas import depth_scale as ds
    from octproz_tpu.params import AcqParams, WindowType, default_full_config
    from octproz_tpu.runtime import StreamingEngine

    enable_compilation_cache()
    dev = jax.devices()[0]
    emit({"card": card(), "device_kind": dev.device_kind,
          "jax": jax.__version__, "xla_flags": os.environ.get("XLA_FLAGS", "")})

    acq = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                    bscans_per_buffer=args.bscans, bit_depth=12)
    curve_kw = dict(
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
        window_type=WindowType.HANNING)

    @jax.jit
    def gen(key):
        return jax.random.randint(key, acq.buffer_shape, 0, 4096,
                                  dtype=jnp.int32).astype(jnp.uint16)

    ring = [gen(jax.random.PRNGKey(i)) for i in range(3)]
    jax.block_until_ready(ring)
    lines = acq.ascans_per_buffer

    for rung in args.rungs.split(","):
        base = dataclasses.replace(default_full_config(), **RUNGS[rung])
        cfgs = {b: dataclasses.replace(base, fold_backend=b)
                for b in ("pallas", "xla")}
        curves = curves_mod.make_curves(acq, base, **curve_kw)
        mean = jnp.asarray(np.random.default_rng(1).normal(
            0, 50, (2, acq.output_ascan_length)).astype(np.float32))

        for spec in filter(None, args.blocks.split(",")):
            bm, bn, bk, w, s = (int(v) for v in spec.split("x"))
            prec = fold.effective_precision(base.compute_dtype,
                                            base.matmul_precision)
            a_, b_ = fold.scale_affine(True, acq.output_ascan_length,
                                       base.grayscale_min, base.grayscale_max,
                                       base.addend, base.multiplicator)
            f = jax.jit(lambda raw, bm=bm, bn=bn, bk=bk, w=w, s=s:
                        ds._depth_scale_kernel(
                            raw.reshape(-1, raw.shape[-1]), curves.depth_op_re,
                            curves.depth_op_im, mean, bitshift=False,
                            compute_dtype=base.compute_dtype, precision=prec,
                            log_scaling=True, a=a_, b=b_,
                            output_dtype="float32", interpret=False,
                            block=(bm, bn, bk), num_warps=w, num_stages=s))
            try:
                ms = _time(f, ring, args.iters)
                err = None
            except Exception as e:  # a block shape the card refuses
                ms, err = None, f"{type(e).__name__}: {str(e)[:200]}"
            emit({"phase": "blocks", "rung": rung, "block": spec,
                  "ms_per_buffer": ms, "error": err})

        # -- the step alone --------------------------------------------------
        outs, alone = {}, {}
        for b, cfg in cfgs.items():
            f = jax.jit(lambda raw, cfg=cfg: ds.fused_depth_scale(
                raw, curves.depth_op_re, curves.depth_op_im, mean, acq, cfg))
            t0 = time.perf_counter()
            compiled = f.lower(ring[0]).compile()
            compile_s = time.perf_counter() - t0
            outs[b] = np.asarray(compiled(ring[0]), np.float32)
            alone[b] = _time(compiled, ring, args.iters)
            emit({"phase": "alone", "rung": rung, "impl": b,
                  "ms_per_buffer": alone[b], "compile_s": compile_s,
                  "memory": str(compiled.memory_analysis())})
        a, p = outs["pallas"], outs["xla"]
        fin = np.isfinite(a) & np.isfinite(p)
        emit({"phase": "alone_compare", "rung": rung,
              "max_abs": float(np.abs(a[fin] - p[fin]).max()),
              "finite_mismatch": int((np.isfinite(a) != np.isfinite(p)).sum()),
              "speedup": alone["xla"] / alone["pallas"]})

        # -- make_step and StreamingEngine, in turns: pallas, xla, xla, pallas
        host = [np.asarray(r) for r in ring]
        for b in ORDER:
            cfg = cfgs[b]
            step = pipeline.make_step(acq, cfg)
            state = pipeline.initial_fpn_state(acq)
            _, state = step(ring[0], curves, state)  # FPN determination
            jax.block_until_ready(state)
            holder = {"state": state}

            def run(raw, step=step, holder=holder):
                out, holder["state"] = step(raw, curves, holder["state"])
                return out

            ms = _time(run, ring, args.iters)
            emit({"phase": "make_step", "rung": rung, "impl": b,
                  "ms_per_buffer": ms, "mhz": lines / ms / 1e3})
        for chunk in (1, 4):
            for b in ORDER:
                model = FdOctModel(acq, cfgs[b], **curve_kw)
                model.process_buffer(host[0])  # compile + FPN determination
                if chunk > 1:
                    jax.block_until_ready(model.process_chunk(
                        np.stack([host[0]] * chunk)))

                class Ring:
                    def buffers(self, n=args.engine_buffers):
                        for i in range(n):
                            yield host[i % len(host)]

                eng = StreamingEngine(model, Ring(), upload_prefetch=True,
                                      dispatch_chunk=chunk)
                t0 = time.perf_counter()
                n = eng.run()
                el = time.perf_counter() - t0
                emit({"phase": "engine", "rung": rung, "impl": b,
                      "chunk": chunk, "buffers": n,
                      "ms_per_buffer": el * 1e3 / n,
                      "mhz": n * lines / el / 1e6})
    emit({"card": card()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
