"""Sharded per-buffer processing over a device mesh.

The reference application is strictly single-GPU (SURVEY.md section 2.3); its
intra-device concurrency is 8 rotating CUDA streams + a batched cuFFT plan
(octproz_project/octproz/src/cuda_code.cu:42,1140,1396).  This
scale-out re-expresses the same workload over a ``jax.sharding.Mesh`` with up
to three axes:

* ``AXIS_HOST`` ("host parallelism", across the inter-host network): present on multi-host meshes built
  by :mod:`octproz_tpu.parallel.multihost` — each host (process) feeds its
  own contiguous block of B-scans from its local acquisition stream and owns
  the devices of one mesh row.  Combined with AXIS_BSCAN into the leading
  B-scan sharding, host-major.
* ``AXIS_BSCAN`` ("volume parallelism", analog of data parallelism): B-scan
  blocks of a buffer are distributed across devices.  Every per-A-scan stage
  (decode, DC removal, resample matmul, window/phase, IFFT, scaling) is
  embarrassingly parallel along this axis.
* ``AXIS_ASCAN`` ("fast-axis parallelism", analog of sequence parallelism):
  the A-scans *within* each B-scan are split across devices — useful for
  streaming configurations with few B-scans per buffer.  Cross-shard
  interactions along this axis are the sinusoidal scan correction (resampling
  *between* A-scans, cuda_code.cu:491-514) and the bidirectional B-scan flip
  (A-scan order reversal, cuda_code.cu:787-807).

Cross-device communication (the part the reference has no equivalent of):

* **Fixed-pattern-noise statistics** (cuda_code.cu:523-565) reduce over the
  first ``bscans_for_noise`` B-scans, which span shards on all axes.  Each
  shard computes per-segment complex sums and power sums for *its* lines via
  a one-hot segment-membership matmul, and the partial sums are combined
  with an explicit ``lax.psum`` over every mesh axis inside ``shard_map`` —
  NVLink within a host row, the inter-host network across hosts.  The
  minimum-variance selection then runs replicated.
* **Geometric postprocessing** (B-scan flip, sinusoidal correction, post
  background) runs *outside* ``shard_map`` on the GSPMD-partitioned global
  array.  On the production B-scan-axis mesh the fast axis is unsharded and
  both stages partition to pure local compute — zero collective bytes
  (measured; tests/test_traffic.py pins it).  On AXIS_ASCAN-sharded meshes
  they are genuinely non-local (the acos curve is a global fast-axis remap,
  the flip reverses the sharded axis) and XLA inserts an all-gather /
  mirror collective-permute — static per configuration, tallied per config
  by ``parallel.traffic``.

Steady-state hot path: when the config allows it (fold path, FPN off/once)
the shard body runs the SAME ``fused_depth_scale`` step as the single-card
pipeline — decode + folded GEMM + FPN subtraction + dynamic-range scaling in
one kernel on a GPU — so the sharded path has the single-card memory
traffic profile.  The
FPN-determination buffer takes the unfused branch (with the psum) via
``lax.cond`` on the replicated ``determined`` flag; all devices take the
same branch, so the collective stays uniform across the mesh.

Test strategy: tests/test_sharding.py runs this on an 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``) and asserts bit-parity with
the single-device pipeline; tests/test_multihost.py repeats it across real
OS processes over a gloo-backed 2-host CPU cluster.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import AcqParams, Curves, FPN_SEGMENTS, FpnMode, FpnState, ProcConfig
from .. import pipeline as _pipeline
from ..ops import fpn as _fpn
from ..ops import postprocess as _postprocess

AXIS_HOST = "host"
AXIS_BSCAN = "bscan"
AXIS_ASCAN = "ascan"


def make_mesh(
    n_bscan_shards: Optional[int] = None,
    n_ascan_shards: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (bscan, ascan) mesh.

    Defaults to all local devices on the B-scan axis — the production layout
    for volume streaming (one buffer's B-scan blocks spread over the slice).
    Multi-host meshes (leading host axis across hosts) are built by
    :func:`octproz_tpu.parallel.multihost.make_multihost_mesh`.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_bscan_shards is None:
        n_bscan_shards = len(devices) // n_ascan_shards
    n = n_bscan_shards * n_ascan_shards
    if n > len(devices):
        raise ValueError(f"mesh {n_bscan_shards}x{n_ascan_shards} needs {n} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(n_bscan_shards, n_ascan_shards)
    return Mesh(dev_array, (AXIS_BSCAN, AXIS_ASCAN))


def buffer_pspec(mesh: Mesh) -> P:
    """PartitionSpec of a raw/processed buffer on this mesh: B-scans over
    (host-major) leading axes, A-scans over the fast axis."""
    if AXIS_HOST in mesh.axis_names:
        return P((AXIS_HOST, AXIS_BSCAN), AXIS_ASCAN, None)
    return P(AXIS_BSCAN, AXIS_ASCAN, None)


def wire_bscan_pspec(mesh: Mesh) -> P:
    """PartitionSpec of a B-scan-granular packed wire buffer
    ((bscans, bytes_per_bscan)): B-scan axes sharded, byte axis whole —
    the fallback wire layout when line lengths aren't 256-sample aligned
    (models/fdoct._put_packed_mesh)."""
    if AXIS_HOST in mesh.axis_names:
        return P((AXIS_HOST, AXIS_BSCAN), None)
    return P(AXIS_BSCAN, None)


def _mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


# ---------------------------------------------------------------------------
# Sharded fixed-pattern-noise statistics
# ---------------------------------------------------------------------------

def _sharded_fpn_mean_line(z_re_local: jnp.ndarray, z_im_local: jnp.ndarray,
                           acq: AcqParams, cfg: ProcConfig,
                           axes: Tuple[str, ...], n_bscan_shards: int
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Minimum-variance mean line from psum-combined per-shard statistics.

    z_re/im_local: float32 (B_loc, A_loc, depth) — this shard's block
    (planar re/im, no complex arrays).  Numerics match getMinimumVarianceMean
    (cuda_code.cu:523-565): the first ``n_noise = bscans_for_noise *
    ascans_per_bscan`` *global* lines are split into FPN_SEGMENTS segments of
    ``n_noise // FPN_SEGMENTS`` consecutive lines; per depth index the mean
    of the minimum-variance segment wins.  Returns (mean_re, mean_im).

    The psum spans every mesh axis in ``axes`` — NVLink within a host, the network
    across hosts on multi-host meshes.
    """
    segs = FPN_SEGMENTS
    b_loc, a_loc, depth = z_re_local.shape
    ib = lax.axis_index(AXIS_BSCAN)
    if AXIS_HOST in axes:
        ib = lax.axis_index(AXIS_HOST) * n_bscan_shards + ib
    ia = lax.axis_index(AXIS_ASCAN)

    # Global (buffer-order) line index of every local line: lines are B-scan
    # major, A-scan minor — the reference's flat buffer order.
    b_glob = ib * b_loc + jnp.arange(b_loc, dtype=jnp.int32)
    a_glob = ia * a_loc + jnp.arange(a_loc, dtype=jnp.int32)
    g = (b_glob[:, None] * jnp.int32(acq.ascans_per_bscan) + a_glob[None, :]).reshape(-1)

    n_noise = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
    if n_noise < segs:
        # same contract as ops/fpn.py:44 — with empty segments the zero
        # variance would win the argmin and silently disable FPN
        raise ValueError(
            f"fixed-pattern-noise determination needs at least {segs} "
            f"A-scans (have {n_noise}: bscans_for_noise="
            f"{cfg.bscans_for_noise} x {acq.ascans_per_bscan} A-scans/B-scan)")
    seg_width = max(n_noise // segs, 1)

    seg_id = g // jnp.int32(seg_width)
    valid = g < jnp.int32(segs * seg_width)
    onehot = ((seg_id[None, :] == jnp.arange(segs, dtype=jnp.int32)[:, None])
              & valid[None, :]).astype(jnp.float32)          # (segs, L_loc)

    lre = z_re_local.reshape(-1, depth)                       # (L_loc, depth)
    lim = z_im_local.reshape(-1, depth)
    # HIGHEST: the statistics must be float32 sums like the single-device
    # reduction; at DEFAULT precision a GPU runs this matmul in TF32, whose
    # 10-bit mantissa shifts the mean line by ~1e-3 relative
    dot = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)
    sum_re = dot(onehot, lre)
    sum_im = dot(onehot, lim)
    sum_sq = dot(onehot, lre ** 2 + lim ** 2)                 # (segs, depth)

    sum_re, sum_im, sum_sq = lax.psum((sum_re, sum_im, sum_sq), axes)

    return _fpn.select_min_variance_mean_planar(sum_re, sum_im, sum_sq, seg_width)


# ---------------------------------------------------------------------------
# Sharded step
# ---------------------------------------------------------------------------

def _core_local(raw_local: jnp.ndarray, curves: Curves, fpn_state: FpnState,
                acq: AcqParams, cfg: ProcConfig,
                axes: Tuple[str, ...], n_bscan_shards: int
                ) -> Tuple[jnp.ndarray, FpnState]:
    """Per-shard slice of the pipeline: decode .. log scaling (shard_map body).

    Mirrors pipeline.process_buffer's structure: the steady-state path is the
    fold step (GEMM + FPN subtraction + scaling, pallas/depth_scale.py) when
    the config allows it; FPN determination runs the unfused branch with the
    psum-combined statistics.  The ``lax.cond`` predicate (``determined``) is
    replicated across the mesh, so every device takes the same branch and the
    collective inside the unfused branch stays uniform.
    """
    half = acq.output_ascan_length

    # output_dtype discipline (mirrors pipeline.process_buffer:146-170):
    # the narrow is a STORAGE decision.  While geometric post-stages still
    # consume the magnitude (they run on the global array in
    # sharded_process_buffer), both cond branches must return float32; only
    # without post-stages may the kernel store / the branch narrow to bf16.
    has_post = (cfg.bscan_flip or cfg.sinusoidal_correction
                or cfg.post_background_removal)
    narrow_here = cfg.output_dtype == "bfloat16" and not has_post
    kcfg = (dataclasses.replace(cfg, output_dtype="float32")
            if cfg.output_dtype == "bfloat16" and has_post else cfg)

    def unfused(state):
        if cfg.fft_via_matmul:
            from ..ops.fold import depth_transform
            z_re, z_im = depth_transform(raw_local, curves.depth_op_re,
                                         curves.depth_op_im, acq, cfg)
        else:
            spectra = _pipeline.prep_spectra(raw_local, curves, acq, cfg)
            z_half = _pipeline.transform_to_depth(spectra, half)
            z_re, z_im = z_half.real, z_half.imag

        if cfg.fpn_mode != FpnMode.OFF:
            computed = FpnState.pack(*_sharded_fpn_mean_line(
                z_re, z_im, acq, cfg, axes, n_bscan_shards))
            if cfg.fpn_mode == FpnMode.CONTINUOUS:
                mean_line = computed
            else:  # ONCE (cuda_code.cu:1521-1524)
                mean_line = jnp.where(state.determined, state.mean_line,
                                      computed)
            state = FpnState(mean_line=mean_line,
                             determined=jnp.ones((), jnp.bool_))
            z_re = z_re - mean_line[0]
            z_im = z_im - mean_line[1]

        scale = (_postprocess.scale_log_planar if cfg.log_scaling
                 else _postprocess.scale_lin_planar)
        mag = scale(z_re, z_im, half, cfg.grayscale_min, cfg.grayscale_max,
                    cfg.addend, cfg.multiplicator)
        if narrow_here:
            mag = mag.astype(jnp.bfloat16)
        return mag, state

    fusable = (cfg.fft_via_matmul
               and cfg.fpn_mode in (FpnMode.OFF, FpnMode.ONCE))
    if not fusable:
        return unfused(fpn_state)

    from ..pallas.depth_scale import fused_depth_scale

    def fused(state):
        # OFF ignores any carried state — subtract zeros (see pipeline.py)
        mean = (jnp.zeros_like(state.mean_line)
                if cfg.fpn_mode == FpnMode.OFF else state.mean_line)
        mag = fused_depth_scale(raw_local, curves.depth_op_re,
                                curves.depth_op_im, mean, acq, kcfg)
        return mag, state

    if cfg.fpn_mode == FpnMode.OFF:
        return fused(fpn_state)
    return lax.cond(fpn_state.determined, fused, unfused, fpn_state)


def sharded_process_buffer(
    raw: jnp.ndarray,
    curves: Curves,
    fpn_state: FpnState,
    acq: AcqParams,
    cfg: ProcConfig,
    mesh: Mesh,
) -> Tuple[jnp.ndarray, FpnState]:
    """Sharded analog of pipeline.process_buffer.

    raw: uint (bscans, ascans, samples), sharded per :func:`buffer_pspec`.
    Returns (float32 (bscans, ascans, samples//2) with the same sharding,
    replicated FpnState).
    """
    axes = _mesh_axes(mesh)
    core = functools.partial(_core_local, acq=acq, cfg=cfg, axes=axes,
                             n_bscan_shards=mesh.shape[AXIS_BSCAN])
    spec = buffer_pspec(mesh)
    mag, fpn_state = jax.shard_map(
        core,
        mesh=mesh,
        in_specs=(spec, P(), P()),
        out_specs=(spec, P()),
        check_vma=False,
    )(raw, curves, fpn_state)

    # Geometric postprocessing on the global (GSPMD-partitioned) array: the
    # A-scan-axis reversal and the static sinusoidal gather cross shard
    # boundaries on AXIS_ASCAN; XLA partitions them and inserts the boundary
    # exchange collectives.
    mag = lax.with_sharding_constraint(mag, NamedSharding(mesh, spec))
    mag = _pipeline.postprocess_volume(mag, curves, cfg)
    if cfg.output_dtype == "bfloat16" and mag.dtype != jnp.bfloat16:
        # post-stage arithmetic ran in float32; narrow as the last step
        # (same contract as pipeline.process_buffer)
        mag = mag.astype(jnp.bfloat16)
    return mag, fpn_state


@functools.lru_cache(maxsize=32)
def make_sharded_step(acq: AcqParams, cfg: ProcConfig, mesh: Mesh,
                      donate_raw: bool = False):
    """Jit-compiled sharded per-buffer step for a static (acq, cfg, mesh).

    Works for single-host (bscan, ascan) meshes and multi-host
    (host, bscan, ascan) meshes alike.  Returns
    ``step(raw, curves, fpn_state) -> (processed, fpn_state)`` with
    committed input/output shardings: raw and the processed volume block-
    sharded per :func:`buffer_pspec`, curves and FPN state replicated.
    """
    sharded = NamedSharding(mesh, buffer_pspec(mesh))
    replicated = NamedSharding(mesh, P())

    from ..curves import consumed_fields

    used = consumed_fields(cfg)

    @functools.partial(
        jax.jit,
        in_shardings=(sharded, replicated, replicated),
        out_shardings=(sharded, replicated),
        donate_argnums=(0,) if donate_raw else (),
    )
    def inner(raw, used_vals, fpn_state):
        cv = Curves(**dict(zip(used, used_vals)))
        return sharded_process_buffer(raw, cv, fpn_state, acq=acq, cfg=cfg,
                                      mesh=mesh)

    def step(raw, curves: Curves, fpn_state):
        return inner(raw, tuple(getattr(curves, f) for f in used), fpn_state)

    return step
