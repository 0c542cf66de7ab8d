"""Test configuration: CPU jax with 8 virtual devices by default, so tests
are fast/deterministic and sharding tests exercise real multi-device paths
without accelerators (SURVEY.md section 4: distributed tests without a
cluster).

jax_platforms is set through jax.config as well as the environment, in case
something imported jax before this file ran (config beats the env var and
is valid until backends initialize). XLA_FLAGS is read lazily at backend
init.

Tests marked `gpu` need the compiled GPU kernel; they take the `gpu_device`
fixture, which skips them where JAX has no GPU. On a GPU machine:
    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
chip_smoke.py makes the same checks on the card at full size.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


import gc

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skipped elsewhere"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the compiled kernel has no CPU backend")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    The full suite compiles hundreds of distinct XLA CPU programs in one
    process; with all of them held live, LLVM JIT compilation started
    segfaulting near the end of the run (reproduced 3x at ~80%, always
    inside backend_compile_and_load; any single module passes alone).
    Clearing the pjit executable cache per module bounds live code size.
    The per-module lru_cache'd step factories recompile on next use, which
    costs a few seconds per module and nothing in correctness."""
    yield
    jax.clear_caches()
    gc.collect()
