"""Persistent XLA compile cache shared by the CLI, bench.py and
chip_smoke.py.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory in code.  Otherwise the cache lives at the fixed
``<repo>/.jax_cache`` (listed in .gitignore): the path is part of the
cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compile cache; returns its directory."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache
