"""Persistent JAX compilation cache for the CLI, bench and smoke entry points.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is set
here.  Otherwise the cache lives at one fixed path inside the checkout,
``<repo>/.jax_cache`` (git-ignored): the path is part of the cache key,
so a directory that moved would never hit.  Enabled by the entry points,
not on package import, so library users keep full control; an existing
``jax_compilation_cache_dir`` setting wins, and
``POASTA_TPU_NO_COMPILE_CACHE=1`` opts out.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir_for(environ) -> "str | None":
    """Directory this module configures: None when the environment
    already decides (``JAX_COMPILATION_CACHE_DIR``) or opts out."""
    if environ.get("POASTA_TPU_NO_COMPILE_CACHE"):
        return None
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def enable_persistent_cache() -> None:
    import jax

    cache_dir = cache_dir_for(os.environ)
    if cache_dir is None or jax.config.jax_compilation_cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
