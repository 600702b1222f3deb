"""FdOctModel -- the flagship stateful wrapper around the functional pipeline.

Plays the role of the reference's (OctAlgorithmParameters singleton +
Processing controller) pair (octproz_project/octproz/src/
octalgorithmparameters.h:46, processing.h:83): holds acquisition geometry,
the static processing configuration, the current LUTs, and the carried FPN
state, and exposes buffer/volume-level processing.  All compute goes through
the jitted functional step (octproz_tpu.pipeline); this class only manages
state and curve rebuilding (the analog of the reference's dirty-flag driven
LUT uploads, cuda_code.cu:1432-1445 -- here a curve change is just a new
traced array, no recompilation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import curves as curves_mod
from .. import pipeline
from ..params import AcqParams, Curves, FpnState, ProcConfig, WindowType


class FdOctModel:
    def __init__(
        self,
        acq: AcqParams,
        cfg: ProcConfig,
        resample_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        dispersion_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        window_type: WindowType = WindowType.HANNING,
        window_center: float = 0.5,
        window_fill_factor: float = 1.0,
        custom_resample_curve: Optional[np.ndarray] = None,
        post_background: Optional[np.ndarray] = None,
        mesh=None,
        preflight: bool = True,
    ):
        self.acq = acq
        self.cfg = cfg
        if preflight:
            # refuse clearly before compile when the config cannot fit in
            # device memory (cuda_code.cu:975-1015 analog); skipped when the
            # backend does not report memory (CPU)
            import os as _os

            if not _os.environ.get("OCTPROZ_TPU_NO_PREFLIGHT"):
                from ..utils.memory import preflight_check

                preflight_check(acq, cfg)
        self._curve_kwargs = dict(
            resample_coeffs=tuple(resample_coeffs),
            dispersion_coeffs=tuple(dispersion_coeffs),
            window_type=window_type,
            window_center=window_center,
            window_fill_factor=window_fill_factor,
            custom_resample_curve=custom_resample_curve,
            post_background=post_background,
        )
        self.curves: Curves = curves_mod.make_curves(acq, cfg, **self._curve_kwargs)
        self.fpn_state: FpnState = pipeline.initial_fpn_state(acq)
        self.mesh = mesh
        self._batch_promoted = False  # see _batch_ready
        self._step = self._build_step()
        # One-shot published snapshot (cfg, curves, step): the hot path
        # reads this single attribute so a live set_config/_rebuild_curves
        # from another thread can never pair an old executable with new
        # curves (the control surface's "atomic under the GIL" contract).
        self._exec = (self.cfg, self.curves, self._step)

    def _build_step(self):
        if self.mesh is not None:
            # multi-chip: shard the per-buffer step over the device mesh
            # (B-scan blocks across devices; see parallel/sharding.py).
            # Works for (bscan, ascan) meshes and multi-host
            # (host, bscan, ascan) meshes alike.
            from ..parallel import make_sharded_step

            return make_sharded_step(self.acq, self.cfg, self.mesh)
        return pipeline.make_step(self.acq, self.cfg)

    @property
    def is_multihost(self) -> bool:
        import jax as _jax

        from ..parallel import AXIS_HOST

        return (self.mesh is not None
                and AXIS_HOST in self.mesh.axis_names
                and _jax.process_count() > 1)

    def put_buffer(self, raw) -> jax.Array:
        """Commit a host raw buffer to the device(s) with the right sharding.

        Single device: plain transfer.  Mesh: device_put with the buffer
        PartitionSpec (B-scan blocks over devices).  Multi-host mesh: ``raw``
        is THIS process's local B-scan block (see
        parallel.multihost.local_bscan_range) and is committed as its shard
        of the global buffer — raw data never crosses hosts.
        """
        if self.mesh is None:
            return jnp.asarray(raw)
        from ..parallel import buffer_pspec, feed_from_local

        if self.is_multihost:
            return feed_from_local(np.asarray(raw), self.acq, self.mesh)
        return jax.device_put(
            jnp.asarray(raw),
            jax.sharding.NamedSharding(self.mesh, buffer_pspec(self.mesh)))

    def put_packed_buffer(self, packed) -> jax.Array:
        """Upload a packed-12-bit wire buffer (1.5 bytes/sample) and unpack
        on device -> uint16 (bscans, ascans, samples).

        The H2D link bounds a host-fed stream; the packed wire format cuts
        the per-buffer bytes by 25 % vs the 12-in-16 container
        (ops.convert.unpack_uint12_device — the UINT12_PACKED capability
        the reference never implements, octalgorithmparameters.h:69).

        On a mesh the wire bytes are shaped (bscans, ascans, 1.5*samples)
        and committed with the SAME B-scan/A-scan sharding as the uint16
        container; packing is line-local, so the sharded unpack
        (ops.convert.unpack_uint12_rows) needs zero cross-device
        communication — the 25 % link saving applies per feeding host
        exactly where it matters most (feeding more chips)."""
        if self.acq.bit_depth != 12:
            raise ValueError("packed-12 wire format needs bit_depth=12")
        if self.mesh is not None:
            return self._put_packed_mesh(packed)
        if not hasattr(self, "_unpack_jit"):
            from ..ops import convert as _convert

            acq = self.acq
            self._unpack_jit = jax.jit(
                lambda p: _convert.unpack_uint12_device(
                    p, acq.samples_per_buffer).reshape(acq.buffer_shape))
        return self._unpack_jit(jnp.asarray(np.asarray(packed, np.uint8)))

    def _put_packed_mesh(self, packed) -> jax.Array:
        """Sharded packed-12 feed: wire bytes cross the link sharded on
        B-scan boundaries and unpack shard-locally on the mesh.

        Two granularities (the row unpack consumes 384-byte rows = 256
        samples, ops.convert.unpack_uint12_rows):

        * per-LINE (samples_per_line % 256 == 0): the wire is
          (bscans, ascans, 1.5*samples) under the full buffer sharding —
          zero collectives even with the A-scan axis sharded.
        * per-B-SCAN fallback (whole-B-scan bytes are row-aligned —
          covers e.g. the figshare 1664-sample geometry): the wire is
          (bscans, ascans*1.5*samples) sharded on the B-scan axes only;
          after the shard-local unpack, GSPMD reshards onto the full
          buffer spec (a collective ONLY when the mesh has an A-scan
          axis > 1).
        """
        acq = self.acq
        per_line = acq.samples_per_line % 256 == 0
        bscan_bytes = acq.ascans_per_bscan * acq.samples_per_line * 3 // 2
        if not per_line and bscan_bytes % 384:
            raise ValueError(
                f"packed-12 on a mesh needs samples_per_line "
                f"({acq.samples_per_line}) or a whole B-scan's samples "
                f"({acq.ascans_per_bscan * acq.samples_per_line}) to be a "
                f"multiple of 256 (384-byte unpack rows)")
        bpl = acq.samples_per_line * 3 // 2
        from ..parallel import buffer_pspec, wire_bscan_pspec

        buf_sharding = jax.sharding.NamedSharding(self.mesh,
                                                  buffer_pspec(self.mesh))
        key = "_unpack_mesh_jit" if per_line else "_unpack_mesh_bscan_jit"
        if not hasattr(self, key):
            from ..ops.convert import unpack_uint12_rows

            if per_line:
                fn = unpack_uint12_rows
            else:
                def fn(p):  # (bscans, ascans*bpl) -> (bscans, a, samples)
                    flat = unpack_uint12_rows(p)
                    return flat.reshape(acq.bscans_per_buffer,
                                        acq.ascans_per_bscan,
                                        acq.samples_per_line)
            setattr(self, key, jax.jit(fn, out_shardings=buf_sharding))
        wire = np.asarray(packed, np.uint8)
        wire_shape = ((acq.bscans_per_buffer, acq.ascans_per_bscan, bpl)
                      if per_line
                      else (acq.bscans_per_buffer, bscan_bytes))
        if self.is_multihost:
            from ..parallel import multihost as _mh

            arr = _mh.feed_wire_from_local(wire, acq, self.mesh,
                                           per_line=per_line)
        else:
            spec = (buffer_pspec(self.mesh) if per_line
                    else wire_bscan_pspec(self.mesh))
            arr = jax.device_put(
                jnp.asarray(wire.reshape(wire_shape)),
                jax.sharding.NamedSharding(self.mesh, spec))
        return getattr(self, key)(arr)

    def fetch(self, arr) -> np.ndarray:
        """D2H fetch of a processed buffer: the full array on a single host,
        this process's contiguous B-scan block on a multi-host mesh (the
        per-host analog of the GPU->host streaming fetch,
        cuda_code.cu:1357-1386)."""
        from ..parallel import multihost as _mh

        return _mh.fetch(arr)

    # -- live re-tuning (reference: sidebar edits -> updateResampleCurve etc.,
    #    octalgorithmparameters.cpp:141-249) ---------------------------------
    def set_klin_coeffs(self, c0: float, c1: float, c2: float, c3: float) -> None:
        self._curve_kwargs["resample_coeffs"] = (c0, c1, c2, c3)
        self._curve_kwargs["custom_resample_curve"] = None
        self._rebuild_curves()

    def set_dispersion_coeffs(self, d0: float, d1: float, d2: float, d3: float) -> None:
        self._curve_kwargs["dispersion_coeffs"] = (d0, d1, d2, d3)
        self._rebuild_curves()

    def set_window(self, window_type: WindowType, center: float = 0.5,
                   fill_factor: float = 1.0) -> None:
        self._curve_kwargs.update(window_type=window_type, window_center=center,
                                  window_fill_factor=fill_factor)
        self._rebuild_curves()

    def set_custom_resample_curve(self, curve: np.ndarray) -> None:
        self._curve_kwargs["custom_resample_curve"] = np.asarray(curve, np.float32)
        self._rebuild_curves()

    def set_post_background(self, background: np.ndarray) -> None:
        self.curves = dataclasses.replace(
            self.curves, post_background=jnp.asarray(background, jnp.float32))
        self._exec = (self.cfg, self.curves, self._step)

    def redetermine_fpn(self) -> None:
        """Reference: redetermineFixedPatternNoise request (cuda_code.cu:1521)."""
        self.fpn_state = pipeline.initial_fpn_state(self.acq)
        self._batch_promoted = False

    def set_config(self, **changes) -> None:
        """Replace static ProcConfig fields mid-stream (grayscale range,
        FPN mode, scaling, ...).  These are trace-time constants, so this
        swaps in a different compiled executable (cached per config) — the
        analog of the reference switching its fused-kernel dispatch
        (cuda_code.cu:1448-1511).  Curve-only re-tuning (set_klin_coeffs
        etc.) stays recompile-free."""
        self.cfg = dataclasses.replace(self.cfg, **changes)
        self._batch_promoted = False
        # consumed curve set may change with the cfg; publish only once the
        # matching executable exists (a reader must never see new curves
        # with the old step)
        self._rebuild_curves(publish=False)
        self._step = self._build_step()
        self._exec = (self.cfg, self.curves, self._step)

    def _rebuild_curves(self, publish: bool = True) -> None:
        post_bg = self.curves.post_background
        self.curves = curves_mod.make_curves(self.acq, self.cfg, **self._curve_kwargs)
        if post_bg is not None:
            self.curves = dataclasses.replace(self.curves, post_background=post_bg)
        if publish:
            self._exec = (self.cfg, self.curves, self._step)

    # -- processing ----------------------------------------------------------
    def process_buffer(self, raw) -> jax.Array:
        """raw uint (bscans, ascans, samples) -> float32 processed half-volume.

        Updates the carried FPN state (async dispatch; no host sync).  On a
        multi-host mesh, pass this process's LOCAL B-scan block (the rest of
        the buffer is fed by the other hosts)."""
        if not isinstance(raw, jax.Array):
            raw = self.put_buffer(raw)
        _, curves, step = self._exec  # consistent (curves, step) pair
        processed, self.fpn_state = step(raw, curves, self.fpn_state)
        return processed

    def process_chunk(self, raw_stack, strategy: str = "auto") -> jax.Array:
        """Throughput mode: a STACK of raw buffers (k, bscans, ascans,
        samples) processed by ONE device dispatch.  Amortizes per-dispatch
        latency; adds k buffers of latency.

        strategy:
          * "scan"  — pipeline.make_scan_step: lax.scan threading the FPN
            state buffer-to-buffer exactly like repeated process_buffer
            calls.  Always available.
          * "batch" — the whole stack runs as ONE fold step
            (pallas/depth_scale.fused_depth_scale) on the flattened line
            axis — no lax.scan, no per-buffer slice feeding the kernel.
            Equal to scan after FPN determination
            (tests/test_pallas.py::test_fused_scale_batch_matches_scan).
            Requires the fold path and a constant FPN mean line (mode OFF,
            or ONCE with the state already determined).
          * "auto"  — "batch" whenever its conditions hold, else "scan".
        """
        if self.mesh is not None:
            raise ValueError("process_chunk is single-device throughput "
                             "mode; on a mesh use process_buffer per buffer")
        raw_stack = jnp.asarray(raw_stack)
        if strategy not in ("auto", "scan", "batch"):
            raise ValueError("strategy must be 'auto', 'scan' or 'batch'")
        if strategy != "scan" and self._batch_ready():
            return self._batch_chunk(raw_stack)
        if strategy == "batch":
            raise ValueError(
                "strategy='batch' needs fft_via_matmul + FPN OFF (or ONCE "
                "already determined); use 'auto' to fall back to scan")
        cfg, curves, _ = self._exec  # consistent (cfg, curves) pair
        step = pipeline.make_scan_step(self.acq, cfg)
        out, self.fpn_state = step(raw_stack, curves, self.fpn_state)
        return out

    def _batch_ready(self) -> bool:
        from ..params import FpnMode

        cfg = self.cfg
        fusable = (cfg.fft_via_matmul
                   and cfg.fpn_mode in (FpnMode.OFF, FpnMode.ONCE))
        if not fusable:
            return False
        if cfg.fpn_mode == FpnMode.ONCE:
            # the device_get is a host sync, so the promotion is CACHED:
            # once determined the state stays determined until
            # redetermine_fpn()/set_config() reset it (which also reset
            # the cache)
            if not self._batch_promoted:
                self._batch_promoted = bool(
                    jax.device_get(self.fpn_state.determined))
            return self._batch_promoted
        return True

    def _batch_chunk(self, raw_stack) -> jax.Array:
        """One fold step over the whole stack; FPN state is unchanged (the
        mean line is a constant input in this regime)."""
        import dataclasses as _dc

        from ..params import FpnMode
        from ..pallas.depth_scale import fused_depth_scale

        cfg, curves, _ = self._exec  # consistent (cfg, curves) pair
        has_post = (cfg.bscan_flip or cfg.sinusoidal_correction
                    or cfg.post_background_removal)
        kcfg = (_dc.replace(cfg, output_dtype="float32")
                if has_post and cfg.output_dtype == "bfloat16" else cfg)
        mean = (jnp.zeros_like(self.fpn_state.mean_line)
                if cfg.fpn_mode == FpnMode.OFF else self.fpn_state.mean_line)
        mag = fused_depth_scale(raw_stack, curves.depth_op_re,
                                curves.depth_op_im, mean,
                                self.acq, kcfg)
        if has_post:
            mag = jax.vmap(
                lambda m: pipeline.postprocess_volume(m, curves, cfg))(mag)
        if cfg.output_dtype == "bfloat16" and mag.dtype != jnp.bfloat16:
            mag = mag.astype(jnp.bfloat16)
        return mag

    def process_volume(self, raw_volume) -> jax.Array:
        """raw uint (buffers, bscans, ascans, samples) or a single buffer ->
        float32 (total_bscans, ascans, samples//2)."""
        raw_volume = jnp.asarray(raw_volume)
        if raw_volume.ndim == 3:
            return self.process_buffer(raw_volume)
        outs = [self.process_buffer(raw_volume[i]) for i in range(raw_volume.shape[0])]
        return jnp.concatenate(outs, axis=0)
