"""Persistent XLA compilation cache wiring.

The 2048^2 device setup and solve programs take minutes to compile
cold. JAX's persistent compilation cache keys executables by (HLO,
compile options, backend version), so repeated bench and smoke runs
reuse them. Call :func:`enable_persistent_cache` before the first jit
compilation.

Location: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself;
nothing else is set in code), otherwise the fixed ``<repo>/.jax_cache``
(gitignored). The path is part of the cache's key, so it must not move
between runs.
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Point JAX's compilation cache at :func:`cache_dir` and cache
    every program; returns the directory in use."""
    import jax

    d = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", d)
    # Cache everything: the programs that matter are multi-second
    # compiles, and tiny helper jits are cheap to store.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return d
