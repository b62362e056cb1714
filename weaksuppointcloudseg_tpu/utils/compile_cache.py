"""Where JAX keeps its persistent compilation cache.

The cache key includes the directory, so a cache that moves never hits:
the path must be fixed. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
already reads it and nothing is set here. Otherwise the cache goes to
``.jax_cache`` at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def init_compile_cache() -> str:
    """Enable the persistent compilation cache; return its directory.

    Call before the first compilation of the process.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
