"""Where JAX keeps its persistent compilation cache.

Entry points (``fdoct`` / ``cli.main``, ``bench.py``, ``chip_smoke.py``)
call :func:`enable_compile_cache` once before they compile anything;
importing the package sets nothing.
"""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout's cache directory (listed in .gitignore).  A fixed path:
#: a later process finds the cache only where the earlier one left it.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it by itself
    and no path is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
