"""JAX persistent compilation cache location, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is: JAX reads it
itself and nothing is set in code. Otherwise the cache lives at
``<checkout>/.jax_cache`` — a fixed path (the cache key depends on it), inside
the checkout, listed in ``.gitignore``.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
