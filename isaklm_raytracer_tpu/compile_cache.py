"""Where JAX keeps its persistent compilation cache.

The entry points (cli.render, bench.py, chip_smoke.py) call `enable()`
before their first compilation. Where JAX_COMPILATION_CACHE_DIR is set, JAX
already reads it and nothing is set here; otherwise the cache goes to a
fixed `.jax_cache/` at the checkout root (git-ignored). The path is part of
the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ=os.environ) -> str:
    """The directory the cache lives in under `environ`."""
    return environ.get(ENV_VAR) or os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable(environ=os.environ) -> str:
    """Point JAX's persistent compilation cache at `cache_dir(environ)`."""
    import jax

    path = cache_dir(environ)
    if not environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
