"""The package's persistent compile cache setting."""

import os

import jax

import numbskull_jax


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_cache_dir_is_left_alone(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    package sets no other directory."""
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert numbskull_jax.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        _restore(prev)


def test_default_cache_dir_is_fixed_in_checkout(monkeypatch):
    """Unset, the cache goes to <checkout>/.jax_cache on every call: no
    temporary, per-process or per-run path."""
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        numbskull_jax.__file__)))
    want = os.path.join(checkout, ".jax_cache")
    try:
        assert numbskull_jax.configure_compile_cache() == want
        assert numbskull_jax.configure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        _restore(prev)
