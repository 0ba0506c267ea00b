"""4096^2 on the virtual 8-device mesh through the mesh-sharded path
(fine c64 vector 268 MB; the setup working set at production nvec is
tens of GB).

The scaling proof: mesh-sharded channels-first device setup +
mesh-sharded planes solve at 4096^2 on >= 4 virtual CPU devices —
correctness (finite state, residual contraction) + compile (the SPMD
partitioner accepts the shardings). On real cards each shard of a
4096^2 lattice on a 2x2 mesh is a 2048^2 plane.

Reference scale anchor: the largest config the reference ships is
128^2 (/root/reference/tests/common_cfgs_u1); its MPI decomposition
story is the cshift halo contract (/root/reference/cshift/cshift_2d.h:
39-42). Here domain decomposition is shard_map + ppermute on the fine
level with the coarse levels replicated (SURVEY.md §2.10).

Slim knobs keep the single-core CI host within budget (calibrated:
1024^2 at nullvec_max_iter=4 / 14 outers costs 471 s on 1 core, so
4096^2 needs ~16x less work per phase): nullvec_max_iter=2, 6 solve
outers, contraction oracle instead of a convergence race. The shapes —
which are what the SPMD compile and the memory story depend on — are
full-size.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qmg_tpu import parallel, u1
from qmg_tpu.lattice import Lattice2D
from qmg_tpu.linalg import norm2sq
from qmg_tpu.operators import Wilson2D
from qmg_tpu.rng import QMGRandom
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.setup_planes import gauss_seed_planes, make_kcycle_setup_planes
from qmg_tpu.tpu_compat import (from_planes, host_to_planes,
                                make_planes_solver, shard_planes_state)

MASS = -0.05
L = 4096


@pytest.mark.slow
def test_4096_mesh_setup_and_solve():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jax.clear_caches()
    mesh = parallel.make_mesh(8)

    # 4096 -> 512 -> 64: aggressive 8x8 blocking keeps depth 3 while the
    # coarse levels stay far below the shard grid (replicated crossover).
    lat = Lattice2D(L, L, 2)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, x_block=8, y_block=8,
                       nullvec_max_iter=2, nullvec_tol=0.0,
                       coarsest_direct=False)
    rng = QMGRandom(1337)
    gauge = u1.gauss_gauge_u1(lat, rng, beta=6.0)  # numpy, host-side
    gauge_p = host_to_planes(gauge)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))

    # Mesh-sharded channels-first device setup (the production >=2048^2
    # path) at the device-facing c64 precision.
    setup_s = make_kcycle_setup_planes(lat, cfg, MASS, dtype=jnp.complex64,
                                       mesh=mesh, channels_first=True)
    state = setup_s(gauge_p, *seeds)
    assert not state["clover0"].sharding.is_fully_replicated, (
        "fine clover must shard over the lattice mesh")
    for k in sorted(state):
        arr = np.asarray(jax.device_get(state[k]))
        assert np.all(np.isfinite(arr)), f"setup state {k} not finite"

    # Mesh-sharded planes solve driven by that state. Weak 2-iteration
    # null vectors still precondition; the oracle is residual
    # contraction + finiteness, not a convergence race.
    op = Wilson2D(lat, MASS, jnp.asarray(gauge, jnp.complex64),
                  dtype=jnp.complex64)
    mg_struct = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(1),
                                       structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=5e-3, max_iter=6,
                               restart_freq=6, mesh=mesh)
    b = np.asarray(rng.gaussian_cv(lat))
    stp, bp = shard_planes_state(state, mesh, host_to_planes(b))
    x_p, iters, rsq = jax.jit(sp)(stp, bp)

    x = from_planes(x_p)
    bj = jnp.asarray(b, jnp.complex64)
    true_res = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
    assert np.isfinite(true_res)
    assert true_res < 0.5, (
        f"4096^2 mesh solve did not contract: true resid {true_res:.3e} "
        f"after {int(iters)} outers (reported rsq {float(rsq):.3e})")
    print(f"[qmg_tpu] 4096^2 mesh: setup finite ({len(state)} arrays), "
          f"solve {int(iters)} outers, true resid {true_res:.3e}")
