"""Collective-traffic accounting for the sharded step.

Scaling over devices rests on the steady state moving ~zero bytes between
devices: every
per-A-scan stage is embarrassingly parallel along the B-scan/A-scan mesh
axes, the only cross-device interactions being the fixed-pattern-noise
statistics psum (reference reduction spans shards, cuda_code.cu:523-565)
during determination and the <=2-A-scan sinusoidal-correction halo at
fast-axis shard edges (cuda_code.cu:491-514).  Rather than assert that,
this module PROVES it per configuration: it compiles the sharded step and
tallies every collective in the optimized HLO with its payload bytes.

Used by tests/test_traffic.py (regression-pins the byte counts) and
benchmarks/scaling.py --traffic (emits the measured traffic).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..params import AcqParams, Curves, ProcConfig
from .. import curves as curves_mod
from .. import pipeline as _pipeline
from . import sharding as _sharding

#: HLO collective opcodes that move payload across devices.  `all-reduce`
#: covers psum; `collective-permute` is the GSPMD halo exchange;
#: start/done pairs (async collectives) are folded into one entry.
_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all", "ragged-all-to-all")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_txt: str) -> int:
    """Payload bytes of an HLO result type, summing tuple elements."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_txt):
        if dtype not in _DTYPE_BYTES:
            continue  # token[] / opaque etc.
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collectives_in_hlo(hlo_text: str) -> List[Dict]:
    """Every cross-device collective in an optimized HLO module, with the
    per-device payload bytes of its result shape.

    Async collectives are counted at the ``-done`` site: a ``-start``'s
    result type is a tuple that also aliases the operand buffers, so
    counting there would roughly double the payload."""
    out = []
    starts_without_done = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[^ ]+)\s+"
                     r"([\w\-]+)\(", line)
        if not m:
            continue
        shape_txt, op = m.groups()
        base = op.removesuffix("-start").removesuffix("-done")
        if base not in _COLLECTIVE_OPS:
            continue
        if op.endswith("-start"):
            starts_without_done[base] = starts_without_done.get(base, 0) + 1
            continue
        if op.endswith("-done"):
            starts_without_done[base] = starts_without_done.get(base, 0) - 1
        out.append({"op": base, "bytes": _shape_bytes(shape_txt),
                    "hlo": line[:160]})
    # a -start with no matching -done would otherwise be silently dropped
    for base, n in starts_without_done.items():
        if n > 0:
            out.append({"op": base, "bytes": 0,
                        "hlo": f"<{n} {base}-start without -done: payload "
                               f"uncounted>"})
    return out


def sharded_step_hlo(acq: AcqParams, cfg: ProcConfig, mesh,
                     determined: bool) -> str:
    """Optimized HLO of the sharded per-buffer step on ``mesh``.

    ``determined`` selects the FPN phase: False = determination buffer
    (the psum lives here), True = steady state.  Because the fused/unfused
    branches sit under one ``lax.cond``, both phases share one executable —
    the *phase* is encoded in the traced value of ``fpn_state.determined``,
    so the HLO is the same; the split is still useful for the analytic
    model below.
    """
    cv = curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0))
    used = curves_mod.consumed_fields(cfg)
    used_vals = tuple(getattr(cv, f) for f in used)
    state = _pipeline.initial_fpn_state(acq)
    if determined:
        state = dataclasses_replace_state(state)
    sharded = NamedSharding(mesh, _sharding.buffer_pspec(mesh))
    replicated = NamedSharding(mesh, P())

    def inner(raw, used_vals, fpn_state):
        cv = Curves(**dict(zip(used, used_vals)))
        return _sharding.sharded_process_buffer(raw, cv, fpn_state, acq=acq,
                                                cfg=cfg, mesh=mesh)

    raw = jnp.zeros(acq.buffer_shape, acq.raw_dtype)
    lowered = jax.jit(inner,
                      in_shardings=(sharded, replicated, replicated),
                      out_shardings=(sharded, replicated)).lower(
                          raw, used_vals, state)
    return lowered.compile().as_text()


def dataclasses_replace_state(state):
    from ..params import FpnState

    return FpnState(mean_line=state.mean_line,
                    determined=jnp.ones((), jnp.bool_))


def measure_collective_traffic(acq: AcqParams, cfg: ProcConfig,
                               mesh) -> Dict:
    """Compile the sharded step on ``mesh`` and tally its collectives.

    Returns {"collectives": [...], "total_bytes": N, "by_op": {...}}.
    ``total_bytes`` is the per-device payload of ONE step execution —
    collectives under the FPN ``lax.cond`` only actually move bytes on the
    determination buffer, so this is the worst-case (determination) cost
    and the steady state is bounded above by the non-cond collectives.
    """
    text = sharded_step_hlo(acq, cfg, mesh, determined=False)
    cols = collectives_in_hlo(text)
    by_op: Dict[str, int] = {}
    for c in cols:
        by_op[c["op"]] = by_op.get(c["op"], 0) + c["bytes"]
    return {"collectives": cols,
            "by_op": by_op,
            "total_bytes": sum(c["bytes"] for c in cols)}


# ---------------------------------------------------------------------------
# Analytic model
# ---------------------------------------------------------------------------

def expected_fpn_psum_bytes(acq: AcqParams) -> int:
    """The determination-phase psum payload: per segment and depth bin,
    three float32 partial sums (re, im, |z|^2) — 9 x depth x 3 x 4 B
    (cuda_code.cu:523-565 reduced across shards)."""
    from ..params import FPN_SEGMENTS

    return FPN_SEGMENTS * acq.output_ascan_length * 3 * 4


def expected_fast_axis_bytes(acq: AcqParams, cfg: ProcConfig,
                             n_ascan_shards: int) -> Optional[int]:
    """Fast-axis (A-scan-sharded) meshes pay real traffic for the geometric
    post-stages: the sinusoidal acos curve is a GLOBAL remap of the A-scan
    axis (max |n(k) - k| ~ 0.1-0.2 A for typical lengths, NOT a small
    halo), and the bidirectional flip reverses the sharded axis outright.
    XLA partitions these as an all-gather of the fast axis / a mirror
    collective-permute of the local block.  We do not model these
    analytically — tests/test_traffic.py pins the measured bytes — and the
    production layout for post-stage configs is B-scan-axis sharding,
    where both stages are provably local (measured: zero bytes beyond the
    FPN psum).  Returns None to signal "measure, don't model"."""
    if n_ascan_shards <= 1 or not (cfg.sinusoidal_correction or
                                   cfg.bscan_flip):
        return 0
    return None
