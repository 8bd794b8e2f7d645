"""JAX's persistent compilation cache for the scripts and the CLI.

A full-width valuation compiles for tens of seconds; the cache lets the next
process skip that.  ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX
itself and wins.  Otherwise the cache lives at a fixed directory inside the
checkout (``.jax_cache``, git-ignored): the path is part of the cache key, so
a directory that moved would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
