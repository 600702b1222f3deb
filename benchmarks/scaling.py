"""Sharded-throughput scaling benchmark (cards and hosts).

Measures steady-state per-buffer throughput of the sharded step
(octproz_tpu.parallel.make_sharded_step) over increasing mesh sizes and
reports scaling efficiency vs linear.

Modes:

* default: 1-D chip sweep over all local devices (1, 2, 4, ... chips).
* ``--hosts N``: simulated multi-host sweep in ONE process -- a
  (host, bscan, ascan) mesh over local/virtual devices, exercising the
  host axis (FPN psum across hosts) without a cluster.
* ``--coordinator HOST:PORT --num-processes N --process-id I``: REAL
  multi-process run (one invocation per host, or one per CPU test
  process).  Each process feeds its local B-scan block
  (feed_from_local) and the reported rate is the global buffer rate.
  CPU example (2 hosts x 2 devices, run in two shells):

      python benchmarks/scaling.py --coordinator localhost:9377 \
          --num-processes 2 --process-id 0 --cpu-devices 2
      python benchmarks/scaling.py --coordinator localhost:9377 \
          --num-processes 2 --process-id 1 --cpu-devices 2

Without hardware, run on a virtual CPU mesh to validate the mechanics:

    python benchmarks/scaling.py --virtual
    python benchmarks/scaling.py --virtual --hosts 2

(virtual devices share host cores, so CPU "scaling" measures partitioning
overhead, not speedup).  Prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(step, raw, curves, state, acq, n_iters, warmup):
    import jax

    for _ in range(max(warmup, 1)):  # >=1: 'out' seeds the ready-barrier
        out, state = step(raw, curves, state)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out, state = step(raw, curves, state)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    rate = n_iters * acq.ascans_per_buffer / dt
    return rate, dt / n_iters


def run_scaling(mesh_builders, acq, cfg, n_iters: int = 20, warmup: int = 2):
    """mesh_builders: list of (label_dict, fn() -> Mesh)."""
    import jax
    import jax.numpy as jnp

    from octproz_tpu import curves as curves_mod, pipeline
    from octproz_tpu.parallel import buffer_pspec, make_sharded_step

    curves = curves_mod.make_curves(
        acq, cfg, resample_coeffs=(0.0, float(acq.samples_per_line - 1), 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    rng = np.random.default_rng(0)
    raw_np = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)

    results = []
    base = None  # (n_devices, rate)
    for label, build in mesh_builders:
        mesh = build()
        n_dev = mesh.devices.size
        step = make_sharded_step(acq, cfg, mesh)
        state = pipeline.initial_fpn_state(acq)
        raw = jax.device_put(
            jnp.asarray(raw_np),
            jax.sharding.NamedSharding(mesh, buffer_pspec(mesh)))
        rate, per_buf = _measure(step, raw, curves, state, acq, n_iters, warmup)
        if base is None:
            base = (n_dev, rate)
        eff = rate / (base[1] * n_dev / base[0])
        rec = dict(label, devices=n_dev, ascans_per_s=round(rate, 1),
                   ms_per_buffer=round(per_buf * 1e3, 2),
                   scaling_efficiency=round(eff, 3))
        results.append(rec)
        print(json.dumps(rec), flush=True)
    return results


def run_distributed(args, acq, cfg):
    """One process of a real multi-host run."""
    from octproz_tpu.parallel import multihost

    multihost.initialize(
        args.coordinator, args.num_processes, args.process_id,
        platform="cpu" if args.cpu_devices else None,
        local_device_count=args.cpu_devices or None)

    import jax

    from octproz_tpu import curves as curves_mod, pipeline
    from octproz_tpu.parallel import (feed_from_local, local_bscan_range,
                                      make_multihost_mesh, make_sharded_step)

    mesh = make_multihost_mesh(n_ascan_shards=args.ascan_shards)
    curves = curves_mod.make_curves(
        acq, cfg, resample_coeffs=(0.0, float(acq.samples_per_line - 1), 10.0, -4.0),
        dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    step = make_sharded_step(acq, cfg, mesh)
    state = pipeline.initial_fpn_state(acq)

    rng = np.random.default_rng(0)
    lo, hi = local_bscan_range(acq, mesh)
    raw_local = rng.integers(0, 4095,
                             size=(hi - lo,) + acq.buffer_shape[1:]
                             ).astype(np.uint16)
    raw = feed_from_local(raw_local, acq, mesh)

    rate, per_buf = _measure(step, raw, curves, state, acq, args.iters, 2)
    rec = {"hosts": jax.process_count(), "process": jax.process_index(),
           "devices": mesh.devices.size,
           "ascans_per_s": round(rate, 1),
           "ms_per_buffer": round(per_buf * 1e3, 2)}
    print(json.dumps(rec), flush=True)
    return rec


def run_traffic_report(acq, cfg, out_path: str) -> dict:
    """Collective-traffic evidence for the sharded step.

    Compiles the sharded step on virtual meshes and tallies the collective
    payload bytes in the optimized HLO (octproz_tpu.parallel.traffic).  The
    partitioned program is what GSPMD emits for our sharding annotations —
    the byte counts are a property of the program, not of the backend
    executing it.  Time on real cards is measured by
    ``chip_smoke.py --multi`` and the sweeps above.
    """
    from octproz_tpu.parallel import make_mesh, make_simulated_multihost_mesh
    from octproz_tpu.parallel import traffic

    report = {
        "workload": {"samples": acq.samples_per_line,
                     "ascans": acq.ascans_per_bscan,
                     "bscans": acq.bscans_per_buffer,
                     "config": "full benchmark chain (cubic k-lin, window, "
                               "dispersion, FPN once, log)"},
        "meshes": {},
    }
    meshes = {
        "bscan8": lambda: make_mesh(8, 1),
        "host2x4": lambda: make_simulated_multihost_mesh(2, 4, 1),
        "bscan4_ascan2": lambda: make_mesh(4, 2),
    }
    for name, build in meshes.items():
        r = traffic.measure_collective_traffic(acq, cfg, build())
        report["meshes"][name] = {"by_op": r["by_op"],
                                  "total_bytes": r["total_bytes"]}
    report["expected_fpn_psum_bytes"] = traffic.expected_fpn_psum_bytes(acq)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def run_gloo_anchor(args, acq, cfg, out_path: str) -> dict:
    """MEASURED 2-process protocol anchor.

    Runs the SAME 2-device global workload twice through the identical
    distributed machinery (run_distributed -> jax.distributed + gloo on
    CPU): (a) one process owning both devices, (b) two OS processes with
    one device each, coordinating over localhost.  The wall-clock ratio
    b/a is a measured lower bound on the distributed-protocol overhead.
    The workers run on the CPU (JAX_PLATFORMS=cpu), so they never open a
    card that another process holds.
    """
    import socket
    import subprocess

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    script = os.path.abspath(__file__)
    geo = ["--samples", str(acq.samples_per_line),
           "--ascans", str(acq.ascans_per_bscan),
           "--bscans", str(acq.bscans_per_buffer),
           "--iters", str(args.iters)]

    def launch(num_processes: int, devices_per_proc: int):
        """Run one coordinated measurement; stderr goes to temp FILES, not
        pipes — draining coordinated workers sequentially over PIPEs can
        deadlock (worker 1 blocks on a full stderr pipe before reaching the
        gloo barrier worker 0 is waiting at)."""
        import tempfile

        port = free_port()
        procs, errs = [], []
        for i in range(num_processes):
            ef = tempfile.TemporaryFile(mode="w+")
            errs.append(ef)
            procs.append(subprocess.Popen(
                [sys.executable, script, "--coordinator",
                 f"127.0.0.1:{port}",
                 "--num-processes", str(num_processes),
                 "--process-id", str(i),
                 "--cpu-devices", str(devices_per_proc)] + geo,
                stdout=subprocess.PIPE, stderr=ef, text=True,
                env=dict(os.environ, JAX_PLATFORMS="cpu")))
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise RuntimeError(
                "gloo anchor worker timed out (coordination stall)")
        finally:
            tails = []
            for ef in errs:
                ef.seek(0)
                tails.append(ef.read()[-500:])
                ef.close()
        for p, tail in zip(procs, tails):
            if p.returncode != 0:
                raise RuntimeError(f"anchor worker failed: {tail}")
        return json.loads(outs[0].strip().splitlines()[-1])

    # ADJACENT pairs with a median-of-pairs ratio: host-load noise moves
    # both runs of a pair together, so the per-pair ratio is robust where
    # a single (one, two) comparison minutes apart is not
    pairs = []
    for _ in range(max(1, getattr(args, "pairs", 3))):
        one = launch(1, 2)   # 1 process x 2 devices — no process boundary
        two = launch(2, 1)   # 2 processes x 1 device — gloo on the path
        pairs.append({"one_process_2dev": one, "two_process_gloo": two,
                      "ratio": round(two["ascans_per_s"]
                                     / one["ascans_per_s"], 3)})
    ratios = sorted(p["ratio"] for p in pairs)
    ratio = ratios[len(ratios) // 2]
    report = {
        "workload": {"samples": acq.samples_per_line,
                     "ascans": acq.ascans_per_bscan,
                     "bscans": acq.bscans_per_buffer, "iters": args.iters},
        "pairs": pairs,
        "measured_protocol_ratio": ratio,
        "note": "measured wall-clock ratio of the identical 2-device "
                "global workload with vs without a real OS-process "
                "boundary (jax.distributed + gloo over localhost, CPU "
                "backend); a measured lower-bound anchor for the "
                "protocol overhead",
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--virtual", action="store_true",
                   help="force an 8-device virtual CPU mesh")
    p.add_argument("--traffic", metavar="OUT_JSON", default=None,
                   help="emit the collective-traffic report (virtual mesh) "
                        "instead of a timing sweep")
    p.add_argument("--gloo-anchor", metavar="OUT_JSON", default=None,
                   help="measured 2-process gloo wall-clock anchor: the "
                        "same 2-device workload with vs without an OS "
                        "process boundary")
    p.add_argument("--pairs", type=int, default=3,
                   help="adjacent measurement pairs for --gloo-anchor "
                        "(median-of-pairs ratio)")
    p.add_argument("--hosts", type=int, default=0,
                   help="simulated multi-host sweep: (host, bscan, ascan) "
                        "meshes with this many hosts")
    p.add_argument("--coordinator", help="HOST:PORT for a real multi-process "
                                         "run (jax.distributed)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="virtual CPU devices per process (distributed mode)")
    p.add_argument("--ascan-shards", type=int, default=1)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--ascans", type=int, default=128)
    p.add_argument("--bscans", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()

    if args.traffic and not args.virtual:
        args.virtual = True  # traffic reports always run on the virtual mesh

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")

    from octproz_tpu.cli import enable_compilation_cache
    from octproz_tpu.params import AcqParams, FpnMode, Interpolation, ProcConfig

    if not args.coordinator:  # distributed workers configure jax first
        enable_compilation_cache()

    acq = AcqParams(samples_per_line=args.samples, ascans_per_bscan=args.ascans,
                    bscans_per_buffer=args.bscans, bit_depth=12)
    cfg = ProcConfig(bitshift=True, resampling=True,
                     interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.ONCE, log_scaling=True,
                     fft_via_matmul=True)

    if args.traffic:
        run_traffic_report(acq, cfg, args.traffic)
        return

    if args.gloo_anchor:
        run_gloo_anchor(args, acq, cfg, args.gloo_anchor)
        return

    if args.coordinator:
        run_distributed(args, acq, cfg)
        return

    import jax

    from octproz_tpu.parallel import make_mesh, make_simulated_multihost_mesh

    n_avail = len(jax.devices())
    if args.hosts:
        per_host = n_avail // args.hosts
        builders = [({"hosts": 1}, lambda ph=per_host: make_mesh(ph, 1))]
        builders += [
            ({"hosts": h},
             lambda h=h, ph=per_host: make_simulated_multihost_mesh(h, ph, 1))
            for h in (2, 4, 8) if h <= args.hosts
        ]
        run_scaling(builders, acq, cfg, n_iters=args.iters)
        return

    mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    builders = [({"mesh": f"{n}x1"}, lambda n=n: make_mesh(n, 1, devices=jax.devices()[:n]))
                for n in mesh_sizes]
    run_scaling(builders, acq, cfg, n_iters=args.iters)


if __name__ == "__main__":
    main()
