"""One place that points JAX's persistent compilation cache for the
repository's entry points (chip_smoke.py, bench*.py, tools/*).

Importing the library sets nothing; each entry point calls
:func:`enable_compile_cache` once, before its first compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> Path:
    """The checkout this package was imported from (two levels above this
    file), wherever the checkout has been moved or copied."""
    return Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point the compile cache at ``$JAX_COMPILATION_CACHE_DIR`` when it is
    set (JAX reads that variable itself, so nothing else is set), else at
    ``<checkout>/.jax_cache``. Returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = str(checkout_root() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
