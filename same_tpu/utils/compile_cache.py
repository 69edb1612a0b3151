"""Where the scripts that solve keep JAX's persistent compile cache.

The fused tearing loop takes tens of seconds to compile per shape bucket, so
``bench.py``, ``chip_smoke.py`` and the example scripts call
:func:`enable_compile_cache` before their first solve. ``import same_tpu``
sets no cache.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Select the persistent compile-cache directory and return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is: JAX reads it
    itself, and nothing else is set. Otherwise the cache lives in the fixed
    ``<checkout>/.jax_cache`` (git-ignored), so every run of this checkout
    finds the programs earlier runs compiled.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
