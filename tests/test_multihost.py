"""Multi-host layer tests.

Two tiers:

1. Simulated host axis (this process, 8 virtual CPU devices): a
   (host, bscan, ascan) mesh exists and the host-spanning FPN psum runs, but
   all "hosts" are local.  Fast parity checks of the mesh/axis plumbing.
2. Real multi-process (2 OS processes x 2 CPU devices, jax.distributed with
   gloo collectives): tests/_multihost_worker.py feeds per-host B-scan
   blocks, runs the sharded step, and asserts per-shard parity with the
   single-device pipeline -- the BASELINE "distributed communication
   backend" requirement (SURVEY.md section 5) exercised end to end.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from octproz_tpu import curves as curves_mod
from octproz_tpu import pipeline
from octproz_tpu.params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType
from octproz_tpu.parallel import (
    buffer_pspec,
    feed_from_local,
    local_block,
    local_bscan_range,
    make_sharded_step,
    make_simulated_multihost_mesh,
)

ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=64,
                bscans_per_buffer=16, bit_depth=12)


def _raw(rng, acq=ACQ):
    return rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16)


def _curves(cfg, acq=ACQ):
    return curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 14.0, -9.0),
        dispersion_coeffs=(0.0, 2.0, -13.0, 7.0),
        window_type=WindowType.HANNING,
    )


FULL_CFG = ProcConfig(
    bitshift=True,
    background_removal=True, rolling_average_window=16,
    resampling=True, interpolation=Interpolation.CUBIC,
    windowing=True, dispersion=True,
    fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
    log_scaling=True,
    bscan_flip=True, sinusoidal_correction=True,
    post_background_removal=True,
)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (2, 1, 4)])
def test_simulated_host_axis_parity(rng, mesh_shape):
    """(host, bscan, ascan) mesh output == single-device pipeline."""
    raw = _raw(rng)
    curves = _curves(FULL_CFG)
    state0 = pipeline.initial_fpn_state(ACQ)

    ref, _ = pipeline.make_step(ACQ, FULL_CFG)(jnp.asarray(raw), curves, state0)

    mesh = make_simulated_multihost_mesh(*mesh_shape)
    step = make_sharded_step(ACQ, FULL_CFG, mesh)
    got, _ = step(jnp.asarray(raw), curves, state0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_fused_scale_inside_sharded_step(rng, kernel_interpret):
    """The depth/scale kernel runs INSIDE shard_map (steady state) and
    matches the single-device pipeline across the FPN determination
    boundary (lax.cond with the psum in the unfused branch)."""
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC,
                     windowing=True, dispersion=True,
                     fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
                     log_scaling=True, fft_via_matmul=True,
                     matmul_precision="high")
    curves = _curves(cfg)
    mesh = make_simulated_multihost_mesh(2, 2, 2)
    step = make_sharded_step(ACQ, cfg, mesh)
    ref_step = pipeline.make_step(ACQ, cfg)

    state_s = pipeline.initial_fpn_state(ACQ)
    state_r = pipeline.initial_fpn_state(ACQ)
    for _ in range(3):  # buffer 0: determination (unfused); 1-2: kernel
        raw = jnp.asarray(_raw(rng))
        got, state_s = step(raw, curves, state_s)
        ref, state_r = ref_step(raw, curves, state_r)
        a, b = np.asarray(got), np.asarray(ref)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(state_s.mean_line),
                               np.asarray(state_r.mean_line),
                               rtol=1e-4, atol=1e-5)


def test_buffer_pspec_and_feed_simulated():
    mesh = make_simulated_multihost_mesh(2, 2, 2)
    assert buffer_pspec(mesh) == jax.sharding.PartitionSpec(
        ("host", "bscan"), "ascan", None)
    lo, hi = local_bscan_range(ACQ, mesh)
    assert (lo, hi) == (0, ACQ.bscans_per_buffer)  # single process feeds all
    raw = np.zeros(ACQ.buffer_shape, np.uint16)
    arr = feed_from_local(raw, ACQ, mesh)
    assert arr.shape == ACQ.buffer_shape
    assert len(arr.sharding.device_set) == 8
    block, start = local_block(arr)
    assert start == 0 and block.shape == ACQ.buffer_shape


def test_local_block_reassembles_sharded_output(rng):
    mesh = make_simulated_multihost_mesh(2, 2, 2)
    vals = rng.normal(size=ACQ.processed_buffer_shape).astype(np.float32)
    arr = jax.device_put(
        vals, jax.sharding.NamedSharding(mesh, buffer_pspec(mesh)))
    block, start = local_block(arr)
    np.testing.assert_array_equal(block, vals[start:start + block.shape[0]])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster_parity():
    """REAL multi-process run: 2 OS processes x 2 CPU devices each,
    jax.distributed + gloo, per-host feed, per-host fetch, FPN psum over
    DCN.  Each worker asserts parity with the single-device pipeline."""
    port = _free_port()
    env = dict(os.environ)
    # the workers configure their own device counts; drop the conftest's
    # 8-virtual-device flag and any preset platform
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(flags)
    env["OCT_MH_PORT"] = str(port)
    env["OCT_MH_NPROCS"] = "2"

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_multihost_worker.py")
    procs = []
    for pid in range(2):
        penv = dict(env, OCT_MH_PROC=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n<< TIMEOUT >>"
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"multihost worker {pid}: parity OK" in out
