"""Headline benchmark: equivalent A-scan rate of the full FD-OCT chain.

Workload mirrors the reference's published benchmark (BASELINE.md): the
1024 x 512 x 256 volume of 12-bit samples, full pipeline — cubic
k-linearization, spectral windowing, numerical dispersion compensation,
fixed-pattern-noise removal (determined once), mirror-artifact truncation
and logarithmic dynamic-range scaling
(performance/v180/performance_v180.md:20-52).

One process, one GPU.  The JSON line it prints holds:

* ``value`` — the headline: steady-state DEVICE-RESIDENT rate of the spec
  (raw buffers pre-staged in device memory, as the streaming runtime's
  upload feeder keeps the feed ahead of compute; see runtime.py);
* ``e2e`` / ``e2e_packed12`` — host-fed end-to-end rates measured by the
  StreamingEngine itself: every raw buffer crosses host->device inside the
  timed region, as in the reference's live counter (cudaMemcpyAsync per
  buffer, cuda_code.cu:1400-1406; processing.cpp:193-207);
* ``ladder`` — rate, FPN-off float64-oracle PSNR and golden PSNR of the
  bfloat16 and highest (5-product) rungs, each labelled with whether its
  golden PSNR is inside the 50.6 dB acquisition quantization-noise bound;
* ``in_bound`` — the headline and a second run of the "high" rung as one
  {rate, fidelity} object (the worse run is the claim);
* ``card`` — the card's name and power limit (nvidia-smi).

Every rate passes its rung's oracle-PSNR gate first.  A spec that fails
(gate, compile or run) ends the benchmark with a non-zero exit; no other
formulation is substituted for it.

    python bench.py                       # headline + annexes
    OCTPROZ_BENCH_SPEC=pallas:1:bfloat16 OCTPROZ_BENCH_NO_ANNEX=1 python bench.py

Baseline: 3.40 MHz A-scans/s — reference v1.8.0 on a GTX 1080 without live
3D view (README.md:48-53), the headline number of the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MHZ = 3.40

#: Acquisition quantization-noise SNR bound (dB) the in-bound row's oracle
#: PSNR must clear (display-domain PSNR between the float64 oracle on
#: 12-bit codes and on the analog interferogram).
IN_BOUND_SNR_DB = 50.6
#: BASELINE.json rate target for the in-bound row (MHz A-scans/s).
IN_BOUND_TARGET_MHZ = 10.0

#: Per-rung fidelity gates (dB, FPN-off float64-oracle PSNR).  The
#: bfloat16 and single-pass float32 rungs keep 8 and 10 mantissa bits of
#: their GEMM operands, so their gate is a catastrophic-bug detector; the
#: split rungs must prove their grade.
ORACLE_GATE_DB = {"default": 20.0, "high": 50.0, "highest": 80.0}

#: The headline: the "high" rung, whose full-chain output stays inside
#: the 50.6 dB bound (a rate outside it is never headlined).
DEFAULT_SPEC = "mega:16:float32:high"


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _fold_flops_per_buffer(acq) -> int:
    """FLOP model of the folded-GEMM formulation (ops/fold.py): two
    (lines x n_in) x (n_in, half) GEMMs per buffer (planar re/im)."""
    lines = acq.ascans_per_buffer
    return 4 * lines * acq.samples_per_line * acq.output_ascan_length


def _bench_acq():
    from octproz_tpu.params import AcqParams

    return AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                     bscans_per_buffer=256, buffers_per_volume=1, bit_depth=12)


_CURVE_KW = dict(resample_coeffs=(0.0, 1023.0, 20.0, -10.0),
                 dispersion_coeffs=(0.0, 0.0, 10.0, 0.0))


def oracle_psnr(cfg) -> float:
    """PSNR (dB) of one processed buffer ON THIS DEVICE vs the float64 NumPy
    oracle, with FPN OFF: its minimum-variance argmin is a discrete choice
    that near-tied segment variances flip under any numeric perturbation,
    so it is excluded from the precision measurement
    (tests/test_pallas.py::test_precision_ladder_vs_float64_oracle is the
    same instrument)."""
    import jax.numpy as jnp

    from octproz_tpu import curves as curves_mod
    from octproz_tpu import pipeline
    from octproz_tpu.params import AcqParams, FpnMode, WindowType

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import oracle

    acq = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                    bscans_per_buffer=8, buffers_per_volume=1, bit_depth=12)
    cfg = dataclasses.replace(cfg, fpn_mode=FpnMode.OFF,
                              output_dtype="float32")
    curves = curves_mod.make_curves(acq, cfg, window_type=WindowType.HANNING,
                                    **_CURVE_KW)
    raw = np.random.default_rng(7).integers(
        0, 4096, size=acq.buffer_shape).astype(np.uint16)
    if cfg.bitshift:
        raw = raw << 4
    want, _ = oracle.full_pipeline(
        raw, acq.bit_depth, bitshift=cfg.bitshift,
        resample_curve=np.asarray(curves.resample_curve),
        interpolation=cfg.interpolation.value,
        window=np.asarray(curves.window), phase=np.asarray(curves.phase),
        log_scaling=cfg.log_scaling, gmin=cfg.grayscale_min,
        gmax=cfg.grayscale_max, addend=cfg.addend, coeff=cfg.multiplicator,
        fast=True)
    step = pipeline.make_step(acq, cfg)
    got, _ = step(jnp.asarray(raw), curves, pipeline.initial_fpn_state(acq))
    ref = np.clip(np.asarray(want, np.float64), 0, 1)
    g = np.clip(np.asarray(got, np.float64), 0, 1)
    mse = float(np.mean((g - ref) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-30)))


def golden_psnr(cfg) -> float:
    """Golden-pair PSNR of this config on THIS device vs the float64 oracle
    output (tests/data/golden_pair_*): the full chain, FPN included."""
    import jax.numpy as jnp

    from octproz_tpu import curves as curves_mod
    from octproz_tpu import pipeline
    from octproz_tpu.params import AcqParams, FpnMode, Interpolation, WindowType
    from octproz_tpu.utils.fidelity import compare_volumes, load_volume

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data")
    with open(os.path.join(data, "golden_pair.json")) as f:
        meta = json.load(f)
    acq = AcqParams(samples_per_line=meta["samples"],
                    ascans_per_bscan=meta["ascans"],
                    bscans_per_buffer=meta["bscans"],
                    bit_depth=meta["bit_depth"])
    cfg = dataclasses.replace(
        cfg, interpolation=Interpolation(meta["interpolation"]),
        fpn_mode=FpnMode(meta["fpn_mode"]),
        bscans_for_noise=meta["bscans_for_noise"],
        grayscale_min=meta["grayscale_min"],
        grayscale_max=meta["grayscale_max"])
    curves = curves_mod.make_curves(
        acq, cfg, resample_coeffs=tuple(meta["resample_coeffs"]),
        dispersion_coeffs=tuple(meta["dispersion_coeffs"]),
        window_type=WindowType(meta["window_type"]))
    raw = np.fromfile(os.path.join(data, "golden_pair_input.raw"),
                      np.uint16).reshape(acq.buffer_shape)
    ref = load_volume(os.path.join(data, "golden_pair_ref.raw"),
                      tuple(meta["ref_shape"]))
    step = pipeline.make_step(acq, cfg)
    got, _ = step(jnp.asarray(raw), curves, pipeline.initial_fpn_state(acq))
    return float(compare_volumes(np.asarray(got), ref).psnr_db)


def _run(cfg, n_iters: int = 40, chunk: int = 1,
         strategy: str = "scan") -> float:
    """Device-resident rate (MHz A-scans/s) of ``cfg``: ``chunk`` buffers
    per dispatch, as a lax.scan of per-buffer steps or, with
    ``strategy="batch"``, as one fold step on the flattened line axis
    (FdOctModel.process_chunk)."""
    import jax
    import jax.numpy as jnp

    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.params import WindowType

    acq = _bench_acq()
    model = FdOctModel(acq, cfg, window_type=WindowType.HANNING, **_CURVE_KW)

    # Distinct raw buffers generated on the device.  The ring is as deep as
    # the dispatch chunk: with repeated buffers inside one jitted chunk XLA
    # could dedupe identical GEMMs and overstate a real stream.
    @jax.jit
    def gen(key):
        return jax.random.randint(key, acq.buffer_shape, 0, 4096,
                                  dtype=jnp.int32).astype(jnp.uint16)

    stack = jax.jit(jax.vmap(gen))(
        jax.random.split(jax.random.PRNGKey(0), max(chunk, 2)))
    model.process_buffer(stack[0])  # compile + FPN determination

    def dispatch(i):
        if chunk > 1:
            return model.process_chunk(stack, strategy=strategy)
        return model.process_buffer(stack[i % 2])

    jax.block_until_ready(dispatch(0))  # warmup compile

    done = 0
    t0 = time.perf_counter()
    while done < n_iters:
        out = dispatch(done)
        done += chunk
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0
    return done * acq.ascans_per_buffer / elapsed / 1e6


def _run_e2e(cfg, time_budget_s: float = 60.0, max_iters: int = 512,
             chunk: int = 8, acq=None, wire: str = "uint16") -> dict:
    """END-TO-END throughput, measured BY THE STREAMING ENGINE ITSELF:
    every raw buffer crosses host->device inside the timed region, matching
    what the reference's live counter measures (a cudaMemcpyAsync of every
    buffer from the acquisition ring, cuda_code.cu:1400-1406, counted by
    processing.cpp:193-207).

    A host ring of distinct numpy buffers (the reference's VirtualOCTSystem
    cycles <= 2 RAM buffers the same way, virtualoctsystem.cpp:163-224)
    feeds ``StreamingEngine`` with its pipelined-H2D upload thread
    (runtime._DeviceFeeder): the upload of buffer i+1 overlaps the compute
    of buffer i.

    Returns {e2e_mhz, h2d_gbps, h2d_ceiling_mhz, ceiling_fraction,
    upload_only_mhz, ...}.  ``ceiling_fraction`` is e2e vs the rate the
    measured H2D bandwidth alone would allow.
    """
    import jax

    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.params import WindowType
    from octproz_tpu.runtime import StreamingEngine, _DeviceFeeder, _Prefetcher

    acq = acq or _bench_acq()
    model = FdOctModel(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
        window_type=WindowType.HANNING)

    rng = np.random.default_rng(0)
    ring = [rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
            for _ in range(3)]
    if wire == "packed12":
        # packed-12 wire format: 1.5 bytes/sample crosses the link, the
        # unpack runs on device (model.put_packed_buffer)
        from octproz_tpu import native

        ring = [native.pack_uint12(b.reshape(-1)) for b in ring]
    wire_bytes = ring[0].nbytes

    # H2D bandwidth of a lone upload: median of 6
    times = []
    for i in range(6):
        t0 = time.perf_counter()
        jax.block_until_ready(jax.device_put(ring[i % len(ring)]))
        times.append(time.perf_counter() - t0)
    h2d_s = sorted(times)[len(times) // 2]
    h2d_gbps = wire_bytes / h2d_s / 1e9
    ceiling_mhz = acq.ascans_per_buffer / h2d_s / 1e6

    class _HostRing:
        """Zero-cost replay source: cycles pre-generated buffers."""

        def buffers(self):
            for i in range(max_iters):
                yield ring[i % len(ring)]

    # upload-only rate THROUGH THE SAME feeder machinery (no compute)
    pre = _Prefetcher(_HostRing(), 2)
    feeder0 = _DeviceFeeder(pre, model, depth=2, wire_format=wire)
    pre.start()
    feeder0.start()
    n_up = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min(30.0, time_budget_s / 3):
        item = feeder0.get(poll=0.1)
        if item is None:
            break
        jax.block_until_ready(item[1])
        n_up += 1
    upload_only_elapsed = time.perf_counter() - t0
    feeder0.stop()
    pre.stop()
    upload_only_mhz = (n_up * acq.ascans_per_buffer / upload_only_elapsed
                       / 1e6)

    # warmup compiles OUTSIDE the timed region: per-buffer step (FPN
    # determination) and, for chunked dispatch, the chunk executable
    dev0 = (model.put_packed_buffer(ring[0]) if wire == "packed12"
            else ring[0])
    model.process_buffer(dev0)
    if chunk > 1:
        import jax.numpy as jnp

        stack0 = (jnp.stack([model.put_packed_buffer(ring[0])] * chunk)
                  if wire == "packed12" else np.stack([ring[0]] * chunk))
        jax.block_until_ready(model.process_chunk(stack0))

    windows = []
    eng = StreamingEngine(model, _HostRing(), upload_prefetch=True,
                          prefetch_depth=2, dispatch_chunk=chunk,
                          chunk_strategy="auto", metrics_window_s=5.0,
                          wire_format=wire,
                          on_metrics=lambda s: windows.append(
                              s.ascans_per_s / 1e6))

    # hard budget watchdog: with chunked dispatch the meter only ticks at
    # flush, so the stop must not depend on a window closing
    import threading

    watchdog = threading.Timer(time_budget_s, eng.stop)
    watchdog.daemon = True
    t0 = time.perf_counter()
    watchdog.start()
    try:
        done = eng.run(max_buffers=max_iters)
    finally:
        watchdog.cancel()
    elapsed = time.perf_counter() - t0
    ended_by = ("budget" if elapsed >= time_budget_s
                else "source_exhausted" if done >= max_iters else "early")

    e2e_mhz = done * acq.ascans_per_buffer / elapsed / 1e6
    window = eng.meter.last  # the engine's own 5 s info-box instrument
    return {
        "e2e_mhz": e2e_mhz,
        "engine_window_mhz": (window.ascans_per_s / 1e6 if window else None),
        "h2d_gbps": h2d_gbps,
        "h2d_ceiling_mhz": ceiling_mhz,
        "ceiling_fraction": e2e_mhz / ceiling_mhz if ceiling_mhz else None,
        "upload_only_mhz": upload_only_mhz,
        "upload_only_buffers": n_up,
        "vs_upload_only": (e2e_mhz / upload_only_mhz
                           if upload_only_mhz else None),
        "buffer_mb": acq.bytes_per_buffer / 1e6,
        "wire": wire,
        "wire_mb": wire_bytes / 1e6,
        "buffers": done,
        "chunk": chunk,
        "ended_by": ended_by,
        "elapsed_s": elapsed,
        "windows_mhz": windows,
        "measured_by": "StreamingEngine + ThroughputMeter",
    }


def parse_spec(spec: str):
    """``<fold_backend|mega>[:<chunk>[:<compute_dtype>[:<precision>[:<output_dtype>]]]]``
    -> (cfg, chunk, strategy).  "mega" runs each chunk as one fold step on
    the flattened line axis (strategy "batch") with fold_backend="pallas"."""
    from octproz_tpu.models.presets import benchmark_config

    parts = spec.split(":") + [""] * 5
    backend = parts[0]
    chunk = int(parts[1]) if parts[1] else 1
    cfg = dataclasses.replace(
        benchmark_config(),
        fold_backend="pallas" if backend == "mega" else backend,
        compute_dtype=parts[2] or "float32",
        matmul_precision=parts[3] or "default",
        output_dtype=parts[4] or "float32")
    return cfg, chunk, "batch" if backend == "mega" else "scan"


def measure(spec: str) -> dict:
    """Gate ``spec`` on its rung's oracle PSNR, then time it."""
    cfg, chunk, strategy = parse_spec(spec)
    rung = cfg.matmul_precision if cfg.compute_dtype == "float32" \
        else "default"
    psnr_db = oracle_psnr(cfg)
    if psnr_db < ORACLE_GATE_DB[rung]:
        raise SystemExit(
            f"bench: {spec} failed the fidelity gate: {psnr_db:.1f} dB "
            f"oracle PSNR (rung '{rung}' needs >= {ORACLE_GATE_DB[rung]})")
    rate_mhz = _run(cfg, n_iters=32 * chunk if chunk > 1 else 40,
                    chunk=chunk, strategy=strategy)
    acq = _bench_acq()
    buffers_per_s = rate_mhz * 1e6 / acq.ascans_per_buffer
    golden_db = golden_psnr(cfg)
    return {
        "spec": spec,
        "value": rate_mhz,
        "ms_per_buffer": 1e3 / buffers_per_s,
        "tflops": buffers_per_s * _fold_flops_per_buffer(acq) / 1e12,
        "oracle_psnr_db": psnr_db,
        "golden_psnr_db": golden_db,
        "golden_within_bound": golden_db >= IN_BOUND_SNR_DB,
    }


def main() -> int:
    import jax

    from octproz_tpu.cli import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found {dev.platform}", file=sys.stderr)
        return 1
    enable_compilation_cache()

    spec = os.environ.get("OCTPROZ_BENCH_SPEC", DEFAULT_SPEC)
    head = measure(spec)
    record = {
        "metric": "equivalent_ascan_rate",
        "value": head["value"],
        "unit": "MHz",
        "vs_baseline": head["value"] / BASELINE_MHZ,
        **{k: v for k, v in head.items() if k != "value"},
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    if not os.environ.get("OCTPROZ_BENCH_NO_ANNEX"):
        cfg, chunk, _ = parse_spec(spec)
        record["e2e"] = _run_e2e(cfg, chunk=max(chunk, 4))
        record["e2e_packed12"] = _run_e2e(cfg, chunk=max(chunk, 4),
                                          wire="packed12")
        record["ladder"] = [measure(s) for s in ("mega:16:bfloat16",
                                                 "mega:16:float32:highest")]
        runs = [head, measure(spec)]
        worst = min(runs, key=lambda r: r["value"])
        record["in_bound"] = {
            "spec": worst["spec"],
            "runs_mhz": [r["value"] for r in runs],
            "value": worst["value"],
            "unit": "MHz",
            "target_mhz": IN_BOUND_TARGET_MHZ,
            "snr_bound_db": IN_BOUND_SNR_DB,
            "oracle_psnr_db": worst["oracle_psnr_db"],
            "golden_psnr_db": worst["golden_psnr_db"],
            "golden_within_bound": worst["golden_within_bound"],
            "vs_baseline": worst["value"] / BASELINE_MHZ,
            "meets_target": (worst["value"] >= IN_BOUND_TARGET_MHZ
                             and worst["oracle_psnr_db"] >= IN_BOUND_SNR_DB),
        }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
