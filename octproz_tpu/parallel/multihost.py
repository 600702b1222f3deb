"""Multi-host distributed layer: host mesh axis, per-host acquisition feeds.

The reference has NO distributed layer at all (SURVEY.md section 5
"Distributed communication backend": single process, single GPU; its
concurrency is 8 CUDA streams, cuda_code.cu:42,1396).  This module is the
scale-out the BASELINE requires as a first-class component:

* :func:`initialize` — ``jax.distributed`` wiring (coordinator + process
  rank), with a CPU convenience path (gloo collectives, N virtual local
  devices) used by the multi-process tests and by single-machine bring-up.
* :func:`make_multihost_mesh` — a (host, bscan, ascan) mesh whose leading
  axis is the process axis: row ``p`` holds exactly the devices of
  process ``p``, so AXIS_BSCAN/AXIS_ASCAN collectives stay within a host
  (NVLink) and only the host-axis reductions (the FPN psum) cross hosts.
* :func:`local_bscan_range` / :func:`feed_from_local` — per-host data
  feeding: each host's acquisition source produces only its own contiguous
  block of B-scans and commits it with
  ``jax.make_array_from_process_local_data`` — raw samples never cross hosts
  (the whole pipeline is B-scan-local except the FPN statistics reduction).
* :func:`local_block` — the inverse, for the D2H side: assemble this
  process's addressable output shards into one contiguous host block (the
  per-host analog of the reference's GPU->host streaming fetch,
  cuda_code.cu:1357-1386).

The sharded step itself is mesh-shape agnostic: ``make_sharded_step``
(octproz_tpu.parallel.sharding) detects the host axis and extends the FPN
``psum`` over it, so single-host and multi-host execution share one code
path and one set of numerics.

Per-buffer unit of work being distributed: the reference's hot loop
``octCudaPipeline`` (cuda_code.cu:1389-1605), one contiguous B-scan block
per host per buffer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

from ..params import AcqParams
from .sharding import AXIS_ASCAN, AXIS_BSCAN, AXIS_HOST, buffer_pspec


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Bring up ``jax.distributed`` for this process.

    Call once per process before any other JAX use, with all three
    arguments: nothing in a plain GPU or CPU cluster tells JAX of them.  ``platform="cpu"`` configures the CPU backend
    for multi-process use: ``local_device_count`` virtual devices per process
    and gloo cross-process collectives.
    """
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        if local_device_count is not None:
            jax.config.update("jax_num_cpu_devices", int(local_device_count))
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_multihost_mesh(
    n_ascan_shards: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """(host, bscan, ascan) mesh over all processes' devices, host-major.

    Row ``p`` of the mesh holds exactly the devices owned by process ``p``
    (sorted by process index, then device id), so:

    * each host feeds/fetches only its own mesh row (local shards),
    * AXIS_BSCAN / AXIS_ASCAN collectives stay within a host (NVLink),
    * only host-axis reductions (FPN statistics psum) cross hosts.

    ``n_ascan_shards`` splits each host's devices between the B-scan and
    A-scan axes (devices_per_host must be divisible by it).
    """
    devices = list(devices if devices is not None else jax.devices())
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    n_hosts = len(by_proc)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(f"unequal devices per process: "
                         f"{ {p: len(v) for p, v in by_proc.items()} }")
    per_host = counts.pop()
    if per_host % n_ascan_shards:
        raise ValueError(f"{per_host} devices/host not divisible by "
                         f"n_ascan_shards={n_ascan_shards}")
    rows = [sorted(by_proc[p], key=lambda d: d.id)
            for p in sorted(by_proc)]
    arr = np.asarray(rows).reshape(
        n_hosts, per_host // n_ascan_shards, n_ascan_shards)
    return Mesh(arr, (AXIS_HOST, AXIS_BSCAN, AXIS_ASCAN))


def make_simulated_multihost_mesh(
    n_hosts: int,
    n_bscan_shards: Optional[int] = None,
    n_ascan_shards: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Single-process (host, bscan, ascan) mesh over local/virtual devices.

    For tests and dry runs without a real multi-process cluster: the host
    axis exists (so the host-spanning psum and host-major layout compile and
    execute) but all "hosts" live in this process.  ``dryrun_multichip`` and
    ``benchmarks/scaling.py --hosts`` use this.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_bscan_shards is None:
        n_bscan_shards = len(devices) // (n_hosts * n_ascan_shards)
    n = n_hosts * n_bscan_shards * n_ascan_shards
    if n > len(devices):
        raise ValueError(f"mesh {n_hosts}x{n_bscan_shards}x{n_ascan_shards} "
                         f"needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(n_hosts, n_bscan_shards,
                                          n_ascan_shards)
    return Mesh(arr, (AXIS_HOST, AXIS_BSCAN, AXIS_ASCAN))


def local_bscan_range(acq: AcqParams, mesh: Mesh,
                      process_index: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) B-scan range of the buffer that THIS process feeds.

    With the host-major mesh layout, process ``p`` owns the contiguous
    B-scan block ``p * B/n_hosts .. (p+1) * B/n_hosts`` of every buffer.
    On a single-process (simulated) host-axis mesh the one process feeds
    everything.
    """
    if AXIS_HOST not in mesh.axis_names or jax.process_count() == 1:
        return 0, acq.bscans_per_buffer
    n_hosts = mesh.shape[AXIS_HOST]
    shards0 = n_hosts * mesh.shape[AXIS_BSCAN]
    if acq.bscans_per_buffer % shards0:
        raise ValueError(f"bscans_per_buffer={acq.bscans_per_buffer} not "
                         f"divisible by {shards0} B-scan shards")
    per_host = acq.bscans_per_buffer // n_hosts
    p = jax.process_index() if process_index is None else process_index
    return p * per_host, (p + 1) * per_host


def feed_from_local(raw_local: np.ndarray, acq: AcqParams,
                    mesh: Mesh) -> jax.Array:
    """Commit this host's raw B-scan block as its shard of the global buffer.

    ``raw_local``: uint (bscans_per_buffer / n_hosts, ascans, samples) — the
    block :func:`local_bscan_range` assigns to this process.  Returns the
    GLOBAL (bscans, ascans, samples) array, sharded per ``buffer_pspec`` —
    no raw data crosses hosts.
    """
    sharding = NamedSharding(mesh, buffer_pspec(mesh))
    global_shape = acq.buffer_shape
    start, stop = local_bscan_range(acq, mesh)
    want = (stop - start,) + tuple(global_shape[1:])
    if tuple(raw_local.shape) != want:
        raise ValueError(f"local block shape {tuple(raw_local.shape)} != "
                         f"this host's shard {want}")
    if jax.process_count() == 1:
        # simulated host axis: every shard is addressable locally
        return jax.device_put(raw_local, sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(raw_local), global_shape)


def feed_wire_from_local(wire_local: np.ndarray, acq: AcqParams,
                         mesh: Mesh, per_line: bool = True) -> jax.Array:
    """Commit this host's packed-12 WIRE bytes as its shard of the global
    wire buffer — the packed analog of :func:`feed_from_local` (packing is
    line-local, so a B-scan block's wire bytes are self-contained).

    ``per_line=True``: global shape (bscans, ascans, 1.5*samples) under
    ``buffer_pspec``.  ``per_line=False`` (line length not 256-sample
    aligned): global shape (bscans, bytes_per_bscan) under
    ``wire_bscan_pspec`` — see models/fdoct._put_packed_mesh.
    ``wire_local`` is this host's flat (or shaped) local B-scan block.
    """
    from .sharding import wire_bscan_pspec

    bpl = acq.samples_per_line * 3 // 2
    start, stop = local_bscan_range(acq, mesh)
    if per_line:
        sharding = NamedSharding(mesh, buffer_pspec(mesh))
        local_shape = (stop - start, acq.ascans_per_bscan, bpl)
    else:
        sharding = NamedSharding(mesh, wire_bscan_pspec(mesh))
        local_shape = (stop - start, acq.ascans_per_bscan * bpl)
    global_shape = (acq.bscans_per_buffer,) + local_shape[1:]
    wire_local = np.asarray(wire_local, np.uint8).reshape(local_shape)
    if jax.process_count() == 1:
        return jax.device_put(wire_local, sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(wire_local), global_shape)


def local_block(arr: jax.Array) -> Tuple[np.ndarray, int]:
    """Assemble this process's addressable shards of a dim0-sharded global
    array into one contiguous host block.

    Returns (block, dim0_start): the per-host D2H fetch — each host fetches
    only its own output B-scans, nothing crosses hosts.
    """
    shards = sorted(arr.addressable_shards,
                    key=lambda s: tuple(sl.start or 0 for sl in s.index))
    starts0 = [s.index[0].start or 0 for s in shards]
    stops0 = [s.index[0].stop if s.index[0].stop is not None
              else arr.shape[0] for s in shards]
    lo, hi = min(starts0), max(stops0)
    block = np.empty((hi - lo,) + tuple(arr.shape[1:]), arr.dtype)
    for s in shards:
        idx = list(s.index)
        d0 = slice((idx[0].start or 0) - lo,
                   (idx[0].stop if idx[0].stop is not None
                    else arr.shape[0]) - lo)
        block[(d0,) + tuple(idx[1:])] = np.asarray(s.data)
    return block, lo


def fetch(arr: jax.Array) -> np.ndarray:
    """D2H fetch that works for both single-host (fully addressable) and
    multi-host arrays: full array when addressable, else this host's block."""
    if arr.is_fully_addressable:
        return np.asarray(arr)
    return local_block(arr)[0]
