"""Persistent XLA compilation cache location.

Entry points (chip_smoke.py, bench.py, the sweep harness) call
``setup_compile_cache()`` before their first compile. The cache key
includes the directory, so it is a fixed path: ``$JAX_COMPILATION_CACHE_DIR``
when that variable is set (JAX reads it itself and nothing is set in code),
otherwise ``<checkout>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir(environ=None) -> str:
    """The directory the cache uses for this environment."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it."""
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
