"""The entry scripts' compile-cache helper: JAX_COMPILATION_CACHE_DIR wins
and nothing is set in code; otherwise a fixed <repo>/.jax_cache."""

import os

import jax

from arnoldimethod_jax import compile_cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_var_set_sets_nothing(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == {}


def test_env_var_unset_uses_repo_cache(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    pkg = os.path.dirname(os.path.abspath(compile_cache.__file__))
    assert path == os.path.join(os.path.dirname(pkg), ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0
