"""Persistent XLA compilation cache for the entry-point scripts.

The library itself sets no global JAX configuration; ``chip_smoke.py``,
``bench.py`` and the example CLIs call :func:`enable_compile_cache`
once, before their first compile.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the fixed
    ``<checkout>/.jax_cache``. The path is part of the cache key, so it
    must not move between runs."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory. When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
