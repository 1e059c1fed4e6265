"""Persistent XLA compile cache for the entry-point scripts.

The library never calls this on import; `chip_smoke.py`, `bench.py` and the
scripts under `scripts/` call it before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other path. Otherwise the cache is the fixed `.jax_cache/` at the
    repo root, so that every process of the repo hits the same entries.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
