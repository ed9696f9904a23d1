"""Placement of JAX's persistent compilation cache for the repo's scripts.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing is
configured here. Otherwise the cache goes to ``<checkout>/.jax_cache``: a
fixed path, because the path is part of the cache key and a directory that
moves (a temp, PID- or time-based one) never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

__all__ = ["compile_cache_dir", "enable_compile_cache"]


def compile_cache_dir(checkout: str) -> str:
    """The cache directory a script run from ``checkout`` uses."""
    return os.environ.get(ENV_VAR) or os.path.join(
        os.path.abspath(checkout), ".jax_cache"
    )


def enable_compile_cache(checkout: str) -> str:
    """Point JAX's persistent cache at ``compile_cache_dir(checkout)``."""
    path = compile_cache_dir(checkout)
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
