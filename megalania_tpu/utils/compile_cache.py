"""JAX's persistent compilation cache, placed from outside or in the checkout.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
else is set here.  Otherwise the cache lives at a fixed directory inside
the checkout (listed in .gitignore): its path is part of the cache key, so
a directory that moved would never hit.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
