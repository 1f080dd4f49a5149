"""Persistent XLA compilation cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module leaves the directory alone.  Otherwise the cache lives at a fixed
``.jax_cache`` inside the checkout: the directory is part of the cache key,
so a path that moved between runs would never hit.  Call before the first
jit.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_DIR", "cache_dir", "enable_persistent_cache"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The compile cache directory: the environment's, else the checkout's."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point jax at the on-disk compilation cache; returns the cache dir."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir()
