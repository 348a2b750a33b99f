"""utils/compile_cache.py: one persistent compile-cache location."""

import jax

from partitionedhashjoin_tpu.utils import compile_cache


def test_env_var_decides_when_set(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_repo_cache_dir_when_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
