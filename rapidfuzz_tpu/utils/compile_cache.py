"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise ``.jax_cache`` at
the root of the checkout (gitignored).  The path is part of the cache key,
so it stays fixed rather than following the working directory.
"""

from __future__ import annotations

import os

#: the checkout this package was imported from
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(ROOT, ".jax_cache"))


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    (before the first compile) and return the path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
