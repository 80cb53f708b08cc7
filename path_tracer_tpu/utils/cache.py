"""Where the program keeps what it builds at run time.

Everything lives under one fixed directory inside the checkout, ``.cache/``
(listed in ``.gitignore``): the XLA compile cache (unless
``JAX_COMPILATION_CACHE_DIR`` names another), the native BVH library and the
generated showcase textures. A fixed path matters for the compile cache: the
path is part of what makes a cache entry hit again.
"""
from __future__ import annotations

import os
from pathlib import Path

CACHE_ROOT = Path(__file__).resolve().parents[2] / ".cache"


def cache_dir(name: str) -> Path:
    """``.cache/<name>`` inside the checkout, created on first use."""
    d = CACHE_ROOT / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets no other directory; otherwise the cache goes to ``.cache/xla``.
    Entries are kept from half a second of compile time up.
    """
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    d = str(cache_dir("xla"))
    jax.config.update("jax_compilation_cache_dir", d)
    return d
