"""Worker process for the multi-host parity test (tests/test_multihost.py).

Each OS process is one "host" of a gloo-backed CPU cluster: it initializes
jax.distributed, feeds ONLY its local B-scan block of every buffer
(feed_from_local), runs the sharded step over the (host, bscan, ascan) mesh,
fetches only its addressable output shards (local_block), and asserts parity
against the single-device pipeline computed locally from the same seeded
volume.  Exit code 0 == parity held on this host.

Run via env: OCT_MH_PORT, OCT_MH_PROC, OCT_MH_NPROCS.  Runs on the CPU, so
it never opens a card that another process holds.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main() -> None:
    port = os.environ["OCT_MH_PORT"]
    pid = int(os.environ["OCT_MH_PROC"])
    nprocs = int(os.environ["OCT_MH_NPROCS"])

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from octproz_tpu.parallel import multihost

    multihost.initialize(f"localhost:{port}", nprocs, pid,
                         platform="cpu", local_device_count=2)

    import jax
    import jax.numpy as jnp

    from octproz_tpu import curves as curves_mod
    from octproz_tpu import pipeline
    from octproz_tpu.params import (AcqParams, FpnMode, Interpolation,
                                    ProcConfig, WindowType)
    from octproz_tpu.parallel import (feed_from_local, local_block,
                                      local_bscan_range, make_multihost_mesh,
                                      make_sharded_step)

    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs

    acq = AcqParams(samples_per_line=128, ascans_per_bscan=32,
                    bscans_per_buffer=8, bit_depth=12)
    cfg = ProcConfig(
        bitshift=True,
        resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True,
        fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
        log_scaling=True,
        bscan_flip=True, sinusoidal_correction=True,
        fft_via_matmul=True,
    )
    curves = curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 14.0, -9.0),
        dispersion_coeffs=(0.0, 2.0, -13.0, 7.0),
        window_type=WindowType.HANNING,
    )

    # 2 devices/host split over the A-scan axis -> mesh (hosts, 1, 2):
    # exercises the DCN host axis AND intra-host fast-axis sharding (the
    # GSPMD boundary exchange for flip + sinusoidal correction).
    mesh = make_multihost_mesh(n_ascan_shards=2)
    assert mesh.shape["host"] == nprocs
    step = make_sharded_step(acq, cfg, mesh)
    state = pipeline.initial_fpn_state(acq)

    ref_step = pipeline.make_step(acq, cfg)
    ref_state = pipeline.initial_fpn_state(acq)

    rng = np.random.default_rng(7)  # same seed on every host: shared volume
    lo, hi = local_bscan_range(acq, mesh)
    assert (hi - lo) * nprocs == acq.bscans_per_buffer

    for _ in range(3):  # buffer 0 determines FPN; 1-2 reuse it
        raw = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)
        global_raw = feed_from_local(raw[lo:hi], acq, mesh)
        out, state = step(global_raw, curves, state)

        ref, ref_state = ref_step(jnp.asarray(raw), curves, ref_state)
        ref = np.asarray(ref)

        block, start = local_block(out)
        np.testing.assert_allclose(
            block, ref[start:start + block.shape[0]], rtol=2e-4, atol=2e-4)

    got_mean = np.asarray(state.mean_line.addressable_shards[0].data)
    np.testing.assert_allclose(got_mean, np.asarray(ref_state.mean_line),
                               rtol=1e-4, atol=1e-5)
    assert bool(np.asarray(state.determined.addressable_shards[0].data))

    # --- end-to-end: the streaming runtime on the multi-host mesh ---------
    # each host streams its OWN local-block source; the engine commits local
    # blocks as shards (model.put_buffer) and fetches only local output
    # shards (model.fetch).
    from octproz_tpu.models.fdoct import FdOctModel
    from octproz_tpu.runtime import StreamingEngine

    model = FdOctModel(
        acq, cfg, mesh=mesh,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 14.0, -9.0),
        dispersion_coeffs=(0.0, 2.0, -13.0, 7.0))
    assert model.is_multihost

    class LocalBlockSource:
        """Per-host acquisition: yields this host's B-scan block of the same
        seeded volume every host generates."""

        def __init__(self, acq):
            self.acq = acq

        def buffers(self):
            r = np.random.default_rng(7)
            for _ in range(3):
                raw = r.integers(0, 4095,
                                 size=acq.buffer_shape).astype(np.uint16)
                yield raw[lo:hi]

    got = []
    eng = StreamingEngine(model, LocalBlockSource(acq), stream_to_host=True,
                          on_processed=lambda b, nr: got.append(b))
    n = eng.run()
    assert n == 3, n
    assert got and got[0].shape[0] == hi - lo

    # --- packed-12 wire across real processes ----------------------------
    # each host commits ONLY its own B-scan block's wire bytes
    # (feed_wire_from_local); the shard-local unpack must reproduce the
    # exact sample values (line-local packing -> zero collectives).
    from octproz_tpu import native
    from octproz_tpu.ops.convert import unpack_uint12_rows
    from octproz_tpu.parallel.multihost import feed_wire_from_local

    pacq = AcqParams(samples_per_line=256, ascans_per_bscan=8,
                     bscans_per_buffer=8, bit_depth=12)
    raw_p = np.random.default_rng(11).integers(
        0, 4095, size=pacq.buffer_shape).astype(np.uint16)
    plo, phi = local_bscan_range(pacq, mesh)
    wire_local = native.pack_uint12(raw_p[plo:phi].reshape(-1))
    arr = feed_wire_from_local(wire_local, pacq, mesh, per_line=True)
    unpacked = jax.jit(unpack_uint12_rows)(arr)
    block_p, start_p = local_block(unpacked)
    np.testing.assert_array_equal(block_p, raw_p[start_p:start_p
                                                 + block_p.shape[0]])
    print(f"multihost worker {pid}: parity OK", flush=True)


if __name__ == "__main__":
    main()
