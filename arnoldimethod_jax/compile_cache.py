"""Persistent XLA compilation cache for the repository's entry scripts.

`enable_compile_cache()` is called by chip_smoke.py, bench.py and
__graft_entry__.py — never at library import, so importing the package
changes no JAX setting.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache lives at `<repo>/.jax_cache`
    (listed in .gitignore): a fixed path, because the path is part of the
    cache key, and every program is cached however fast it compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
