"""Where the persistent compilation cache lands: JAX_COMPILATION_CACHE_DIR
when set, else the fixed <repo>/.jax_cache."""

import os
import subprocess
import sys

from qmg_tpu import cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compiles one program whose HLO no other code produces, and prints the
# directory the cache was pointed at.
_PROBE = """
import jax, jax.numpy as jnp
from qmg_tpu.cache import enable_persistent_cache
print(enable_persistent_cache())
print(jax.jit(lambda x: jnp.cos(x) * {tag} + 7.25)(jnp.ones(13)).sum())
"""


def _run_probe(env, tag):
    env = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE.format(tag=tag)],
                         cwd=_REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout.splitlines()[0]


def _entries(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_cache_honours_env_dir(tmp_path):
    before = _entries(cache.DEFAULT_CACHE_DIR)
    used = _run_probe(dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(
        tmp_path)), tag=3.5)
    assert used == str(tmp_path)
    assert any(f.startswith("jit__lambda") for f in os.listdir(tmp_path))
    assert _entries(cache.DEFAULT_CACHE_DIR) == before


def test_cache_defaults_to_repo_dir():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    before = _entries(cache.DEFAULT_CACHE_DIR)
    used = _run_probe(env, tag=os.getpid() + 0.5)
    assert used == os.path.join(_REPO, ".jax_cache")
    assert any(f.startswith("jit__lambda")
               for f in _entries(cache.DEFAULT_CACHE_DIR) - before)
