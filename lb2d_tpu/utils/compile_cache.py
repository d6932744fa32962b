"""Persistent XLA compilation cache for the repo's entry points.

A cold process compiles every step it runs; ``chip_smoke.py`` and
``bench.py`` call :func:`configure_compile_cache` first so that a later
process on the same machine finds those executables again.
"""

from __future__ import annotations

import os

import jax

__all__ = ["configure_compile_cache", "CHECKOUT_CACHE_DIR"]

# <checkout>/.jax_cache (listed in .gitignore). The path is part of the
# cache's key, so it is fixed rather than per-run.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

# The step compiles worth keeping take about a second; JAX's default
# threshold would drop them.
MIN_COMPILE_SECS = 0.5


def configure_compile_cache() -> str:
    """Turn on the persistent cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache lives in
    :data:`CHECKOUT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    return env or CHECKOUT_CACHE_DIR
