"""Test configuration: CPU backend with a virtual 8-device mesh and fp64.

Numerics parity with the reference is at double precision; sharding tests
use a virtual CPU mesh (the driver separately dry-runs the multi-chip path
via __graft_entry__.dryrun_multichip).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate_timeout" not in flags:
    # The 8 virtual devices are in-process threads sharing this host's
    # (often single) core; XLA's collective rendezvous watchdog aborts
    # the PROCESS when participants don't all arrive within 40 s, which
    # a big compile or a competing process can trigger at large lattices
    # (observed: fatal collective-permute rendezvous at 4096^2). Warn
    # late, terminate much later - correctness never depends on it.
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags

import jax

# Also through the config API, in case jax was imported before this file.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE_CFGS = "/root/reference/tests/common_cfgs_u1"

# Build the native heatbath library (qmg_tpu/native/libqmgnative.so) so
# the suite exercises the C++ fast path + bit-exact std-stream
# continuation rather than silently taking the ~350x-slower NumPy
# fallback. Cheap no-op when already built (make
# checks the timestamp); failures fall back to the NumPy path, and
# test_rng's native leg will report the skip.
import subprocess  # noqa: E402

_native_dir = os.path.join(os.path.dirname(__file__), "..", "qmg_tpu",
                           "native")
try:
    subprocess.run(["make", "-C", _native_dir], check=False, timeout=120,
                   capture_output=True)
except Exception:
    pass


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches_per_module():
    # XLA's CPU compiler has been observed to SEGFAULT on large modules
    # late in a long suite run (first seen on the sharded SPMD compiles
    # at ~120 accumulated executables, then on the adaptive-setup
    # compiles at ~95 once the suite grew). Dropping the jit caches at
    # every module boundary bounds the accumulated executable count and
    # reliably avoids it; within-module caching (where compiles are
    # actually shared) is unaffected.
    jax.clear_caches()
    yield


@pytest.fixture
def cfg_dir():
    if not os.path.isdir(REFERENCE_CFGS):
        pytest.skip("shipped gauge-config fixtures not available")
    return REFERENCE_CFGS
