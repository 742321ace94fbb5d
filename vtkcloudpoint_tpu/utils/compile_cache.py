"""Where JAX keeps its persistent compilation cache.

JAX_COMPILATION_CACHE_DIR, when set, names the directory as it is.
Otherwise the cache lives at a fixed path inside the checkout,
``<repo>/.jax_cache`` (listed in .gitignore): the path is part of what a
cache entry is found by, so it must not move between runs.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
