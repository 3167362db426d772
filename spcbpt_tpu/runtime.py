"""Runtime/process setup helpers."""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def setup() -> None:
    """Enable JAX's persistent compilation cache (render steps take tens of
    seconds to compile). JAX_COMPILATION_CACHE_DIR names its directory when
    set, and JAX reads it itself; otherwise the cache is <repo>/.jax_cache,
    a fixed path so that later runs find it."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
