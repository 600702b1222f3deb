"""Benchmark-harness smoke tests: the CPU entry points must stay runnable
(bench.py and chip_smoke.py measure on the card; these harnesses are the
manual profiling surface, reference analog: the published performance
protocol, performance/v180/performance_v180.md:55-60)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_latency_harness_cpu_small():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "latency.py"),
         "--platform", "cpu", "--small", "--n", "5"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "per_buffer_latency"
    assert rec["n"] == 5 and rec["p50"] > 0
    assert rec["platform"] == "cpu"


def test_gloo_anchor_measured_ratio():
    """The 2-process gloo anchor: the same 2-device workload with vs
    without an OS-process boundary yields a MEASURED protocol ratio."""
    out_json = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            "gloo_anchor_test.json")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "scaling.py"),
         "--gloo-anchor", out_json, "--samples", "256", "--ascans", "32",
         "--bscans", "8", "--iters", "6", "--pairs", "1"],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-800:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    pair = rec["pairs"][0]
    assert pair["one_process_2dev"]["devices"] == 2
    assert pair["two_process_gloo"]["hosts"] == 2
    # structural sanity only: wall-clock ratios on a loaded shared CPU are
    # arbitrarily noisy (the artifact run uses median-of-3 adjacent pairs)
    assert rec["measured_protocol_ratio"] > 0
    assert "measured" in rec["note"]


def test_e2e_harness_engine_measured_cpu_small():
    """bench._run_e2e drives the real StreamingEngine (pipelined-H2D
    feeder + chunked dispatch) and reports engine-measured rates plus the
    link-implied ceiling."""
    code = r"""
import json, sys
sys.path.insert(0, %r)
import jax; jax.config.update("jax_platforms", "cpu")
import bench
from octproz_tpu.params import AcqParams, FpnMode, Interpolation, ProcConfig

acq = AcqParams(samples_per_line=256, ascans_per_bscan=32,
                bscans_per_buffer=4, buffers_per_volume=1, bit_depth=12)
cfg = ProcConfig(bitshift=True, resampling=True,
                 interpolation=Interpolation.CUBIC, windowing=True,
                 dispersion=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=1,
                 log_scaling=True, fft_via_matmul=True)
r = bench._run_e2e(cfg, time_budget_s=10.0, max_iters=12, chunk=4, acq=acq)
print(json.dumps(r))
""" % REPO
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["buffers"] == 12
    assert rec["e2e_mhz"] > 0 and rec["h2d_gbps"] > 0
    assert rec["h2d_ceiling_mhz"] > 0 and rec["ceiling_fraction"] > 0
    assert rec["measured_by"] == "StreamingEngine + ThroughputMeter"


def test_bench_and_chip_smoke_refuse_without_a_gpu():
    """No CPU fallback: without a GPU both exit non-zero and print no
    result line."""
    for script in ("bench.py", "chip_smoke.py"):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, script)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode != 0, script
        assert '"ok"' not in out.stdout and '"value"' not in out.stdout


def test_bench_parse_spec():
    sys.path.insert(0, REPO)
    import bench

    cfg, chunk, strategy = bench.parse_spec("mega:16:bfloat16")
    assert (chunk, strategy) == (16, "batch")
    assert cfg.fold_backend == "pallas" and cfg.compute_dtype == "bfloat16"
    cfg, chunk, strategy = bench.parse_spec("xla:1:float32:high:bfloat16")
    assert (chunk, strategy, cfg.fold_backend) == (1, "scan", "xla")
    assert cfg.matmul_precision == "high" and cfg.output_dtype == "bfloat16"


def test_main_path_imports_no_plotting_libraries():
    """The card's machine has no PIL or matplotlib: the main path (CLI,
    model, runtime, kernel, chip_smoke's imports) must import them only
    lazily, for PNG and plot export."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import chip_smoke, bench\n"
            "import octproz_tpu.cli, octproz_tpu.viz, octproz_tpu.runtime\n"
            "import octproz_tpu.models.fdoct, octproz_tpu.pallas.depth_scale\n"
            "print('PIL' in sys.modules, 'matplotlib' in sys.modules)" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.split() == ["False", "False"]
