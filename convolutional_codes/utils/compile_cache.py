"""Persistent compilation cache placement for the entry points."""

from __future__ import annotations

import os

import jax

#: the checkout: the directory that holds the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, and nothing is set here); otherwise keep the cache at the fixed
    path ``<checkout>/.jax_cache``, so every process of this checkout finds
    what an earlier one compiled.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
