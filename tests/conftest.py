"""Test environment: run on the CPU with 8 virtual devices, so the sharded
(shard_map) paths are exercised without accelerator hardware.

``JAX_PLATFORMS`` defaults to ``cpu``; tests marked ``gpu`` need a card and
run where it is set otherwise (``JAX_PLATFORMS=cuda pytest -m gpu tests/``).
Must run before the first `import jax` anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Where a GPU would run pallas/depth_scale's compiled kernel, run it in
    the Pallas interpreter instead of the plain XLA form, so a CPU test of a
    pipeline path exercises the kernel.  Jitted step caches are cleared on
    both sides so no executable crosses the boundary."""
    from octproz_tpu import pipeline
    from octproz_tpu.pallas import depth_scale
    from octproz_tpu.parallel import sharding

    real = depth_scale.implementation

    def implementation(platform, cfg, bit_depth, interpret=False):
        on_gpu = real("gpu", cfg, bit_depth)
        return "interpret" if on_gpu == "kernel" else on_gpu

    caches = (pipeline.make_step, pipeline.make_scan_step,
              sharding.make_sharded_step)
    for c in caches:
        c.cache_clear()
    monkeypatch.setattr(depth_scale, "implementation", implementation)
    yield
    for c in caches:
        c.cache_clear()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]
