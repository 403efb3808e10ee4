"""Persistent JAX compilation cache.

A fresh process compiles the full pipeline before its first result; with
the persistent cache a repeat CLI or benchmark invocation loads the
executables instead.  Called by the CLI and bench entry points (a library
should not mutate global JAX config on import).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
other directory is set here.  Otherwise the cache lives at a fixed,
git-ignored path inside the checkout (``.jax_cache``): the directory is
part of what makes a cached entry found again, so it must not move.
"""

from __future__ import annotations

import os
import pathlib

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def enable_compilation_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
