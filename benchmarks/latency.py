"""Per-buffer latency benchmark: the real-time-facing complement of the
throughput headline (bench.py).

The reference is a *live* instrument: each acquired buffer must be
processed before the acquisition double-buffer wraps (the blocking CUDA
event, octproz_project/octproz/src/cuda_code.cu:1416-1420, is its
back-pressure).  The throughput bench amortizes dispatch latency over
chunked scans; this harness measures the opposite regime -- one
dispatch + one sync per buffer, i.e. the worst-case latency a streaming
client sees -- and reports the distribution (p50/p90/p99/max) rather
than the mean, since a real-time system is sized by its tail.

    python benchmarks/latency.py [--n 60] [--platform cpu] [--small]

Prints ONE json line naming the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60, help="timed buffers")
    ap.add_argument("--platform", default=None, choices=[None, "cpu"],
                    help="force a backend (default: session default)")
    ap.add_argument("--small", action="store_true",
                    help="tiny geometry (CI / CPU smoke)")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if args.n < 1:
        ap.error("--n must be >= 1 (zero timed buffers yields no statistics)")

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from octproz_tpu import curves as curves_mod
    from octproz_tpu import pipeline
    from octproz_tpu.cli import enable_compilation_cache
    from octproz_tpu.params import (AcqParams, FpnMode, Interpolation,
                                    ProcConfig, WindowType)

    enable_compilation_cache()

    if args.small:
        acq = AcqParams(samples_per_line=256, ascans_per_bscan=32,
                        bscans_per_buffer=8, bit_depth=12)
    else:
        acq = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                        bscans_per_buffer=256, bit_depth=12)
    cfg = ProcConfig(
        bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
        bscans_for_noise=1, log_scaling=True, fft_via_matmul=True,
        fold_backend=args.backend, compute_dtype=args.compute_dtype)
    curves = curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
        window_type=WindowType.HANNING)
    state = pipeline.initial_fpn_state(acq)
    step = pipeline.make_step(acq, cfg)

    @jax.jit
    def gen(key):
        return jax.random.randint(key, acq.buffer_shape, 0, 4096,
                                  dtype=jnp.int32).astype(jnp.uint16)

    ring = [gen(jax.random.PRNGKey(i)) for i in range(4)]
    jax.block_until_ready(ring)

    # warmup: compile + FPN determination
    out, state = step(ring[0], curves, state)
    jax.block_until_ready(out)

    # Latency: dispatch -> the buffer's result is complete on the device,
    # one block_until_ready per buffer.
    lat_ms = []
    t_start = time.perf_counter()
    for i in range(args.n):
        t0 = time.perf_counter()
        out, state = step(ring[i % len(ring)], curves, state)
        jax.block_until_ready(out)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if time.perf_counter() - t_start > 60.0:
            break
    lat = np.asarray(lat_ms)

    # Companion number: amortized per-buffer device time over a pipelined
    # run (one sync at the end) — the dispatch-latency-free floor the
    # chunked/batch path amortizes toward.
    m = max(8, min(32, args.n))
    t0 = time.perf_counter()
    for i in range(m):
        out, state = step(ring[i % len(ring)], curves, state)
    jax.block_until_ready(out)
    amortized_ms = (time.perf_counter() - t0) * 1e3 / m

    q = lambda p: round(float(np.percentile(lat, p)), 3)
    print(json.dumps({
        "metric": "per_buffer_latency",
        "unit": "ms",
        "n": int(lat.size),
        "p50": q(50), "p90": q(90), "p99": q(99),
        "max": round(float(lat.max()), 3),
        "mean": round(float(lat.mean()), 3),
        "amortized_pipelined_ms": round(amortized_ms, 3),
        "sync": "block_until_ready per buffer",
        "ascans_per_buffer": acq.ascans_per_buffer,
        "fold_backend": args.backend,
        "compute_dtype": args.compute_dtype,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
