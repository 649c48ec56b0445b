"""Persistent XLA compilation cache.

Compiling the global-grid pipeline takes seconds to minutes; with the
persistent cache, repeat runs of any driver skip it.  The directory is
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself), else
a fixed ``.jax_cache`` directory at the root of the checkout — fixed, because
the path is part of the cache key.  Call :func:`enable` before building
jitted functions (safe to call any number of times, and after jax is
initialized).
"""
from __future__ import annotations

import os

#: the checkout-local default (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_enabled = False


def cache_dir() -> str:
    """The directory :func:`enable` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent compilation cache; returns the directory."""
    global _enabled
    import jax
    path = cache_dir()
    if not _enabled:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        _enabled = True
    return path
