"""octproz_tpu -- an FD-OCT processing framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
application OCTproZ (C++/CUDA/Qt, see SURVEY.md), but an idiomatic JAX
architecture: functional jitted pipeline, matmul k-linearization folded with
the inverse DFT into one GEMM, shard_map sharding over device meshes.
"""

from .params import (  # noqa: F401
    AcqParams,
    Curves,
    DisplayFunction,
    FpnMode,
    FpnState,
    Interpolation,
    ProcConfig,
    WindowType,
    default_full_config,
)
from . import curves, ops, pipeline  # noqa: F401
from .pipeline import initial_fpn_state, make_scan_step, make_step, process_buffer  # noqa: F401

__version__ = "0.1.0"
