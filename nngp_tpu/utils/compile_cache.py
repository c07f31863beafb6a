"""Placement of JAX's persistent compilation cache.

The cycle program of a large problem takes minutes to compile, so every
script of this repository keeps compiled programs on disk.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
overrides it.  Otherwise the cache goes to one fixed directory inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): a fixed path,
since the path is part of the cache key and a directory that moves never
hits.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
