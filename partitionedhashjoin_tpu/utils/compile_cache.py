"""Persistent XLA compilation cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing here
sets another directory.  Otherwise every entry point (CLI, SQL shell,
benchmarks, chip_smoke.py) shares the fixed ``<repo>/.jax_cache``: the
cache path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from typing import Optional

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at ``DEFAULT_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set.  Returns the directory this call
    set, or None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
