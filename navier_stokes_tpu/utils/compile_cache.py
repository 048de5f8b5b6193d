"""Placement of JAX's persistent compilation cache.

The cache key includes its directory, so the directory must not move
between runs: it is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
reads the variable itself, and nothing here overrides it), and otherwise
one fixed directory inside the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
