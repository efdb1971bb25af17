"""Where JAX keeps compiled programs between processes.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to `.jax_cache/` at the root of the
checkout: a fixed path, because the path is part of each entry's key, and
one that .gitignore lists.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory. Call
    before the first compilation."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
