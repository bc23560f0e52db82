"""Persistent XLA compilation cache, shared by every entry point.

A first compile of the control step at full width takes tens of seconds;
the cache lets later processes on the same machine skip it. The cache is
keyed by its directory, so the directory is fixed: where
``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it and nothing else
is set here; otherwise the cache lives at ``.jax_cache/`` in the checkout
(listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on for this process; returns its path."""
    path = os.environ.get(ENV)
    if not path:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
