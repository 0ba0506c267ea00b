"""Sharded Dslash (shard_map + ppermute halo exchange) vs single-device
apply, on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D, Staggered2D
from qmg_tpu.stencil import apply_M
from qmg_tpu.shard_dslash import make_sharded_dslash
from qmg_tpu import u1, parallel
from qmg_tpu.rng import QMGRandom


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches():
    # The sharded SPMD compiles here are the largest modules in the
    # suite; XLA's CPU compiler has been observed to segfault on them
    # late in a long session (~120 tests of accumulated executables).
    # Dropping the jit caches before this module reliably avoids it.
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return parallel.make_mesh(8)


@pytest.mark.parametrize("kind", ["wilson", "staggered"])
def test_sharded_matches_single(mesh, kind):
    rng = QMGRandom(1337)
    if kind == "wilson":
        lat = Lattice2D(32, 32, 2)
        g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
        op = Wilson2D(lat, -0.07, g)
    else:
        lat = Lattice2D(32, 32, 1)
        g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
        op = Staggered2D(lat, 0.1, g)
    x = jnp.asarray(rng.gaussian_cv(lat))
    expect = np.asarray(apply_M(op.coeffs, x))

    apply_sharded = jax.jit(make_sharded_dslash(op.coeffs, mesh))
    xs = parallel.shard_field(x, mesh)
    got = np.asarray(apply_sharded(xs))
    np.testing.assert_allclose(got, expect, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_wilson_on_four_devices(shape):
    """The four-card mesh shapes: a y-slab (4, 1) decomposition and the
    (2, 2) grid parallel.make_mesh picks for four devices."""
    mesh4 = parallel.make_mesh(4, shape=shape)
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(5)
    op = Wilson2D(lat, -0.06, u1.gauss_gauge_u1(lat, rng, beta=6.0))
    x = jnp.asarray(rng.gaussian_cv(lat))
    expect = np.asarray(apply_M(op.coeffs, x))
    got = np.asarray(jax.jit(make_sharded_dslash(op.coeffs, mesh4))(
        parallel.shard_field(x, mesh4)))
    np.testing.assert_allclose(got, expect, atol=1e-12)


def test_sharded_rejects_bad_tiling(mesh):
    lat = Lattice2D(12, 12, 1)  # Xh=6 does not tile the x axis
    g = u1.unit_gauge_u1(lat)
    op = Staggered2D(lat, 0.1, g)
    with pytest.raises(ValueError, match="tile the mesh|Y_loc"):
        make_sharded_dslash(op.coeffs, mesh)


def test_sharded_solver_end_to_end(mesh):
    """A full CG solve over the sharded operator (reductions become
    all-reduces under jit)."""
    from qmg_tpu import solvers
    from qmg_tpu.linalg import norm2sq
    lat = Lattice2D(32, 32, 1)
    rng = QMGRandom(2)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    from qmg_tpu.operators import GaugedLaplace2D
    op = GaugedLaplace2D(lat, 0.01, g)
    apply_sharded = make_sharded_dslash(op.coeffs, mesh)
    b = parallel.shard_field(jnp.asarray(rng.gaussian_cv(lat)), mesh)
    res = jax.jit(lambda b: solvers.cg(apply_sharded, b, max_iter=2000,
                                       tol=1e-10))(b)
    assert bool(res.converged)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-9


def test_validate_mg_sharding_and_crossover(mesh):
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    op = Wilson2D(lat, 0.1, u1.unit_gauge_u1(lat))
    cfg = KCycleConfig(n_refine=2, coarse_dof=2, free_null_vectors=True)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    parallel.validate_mg_sharding(mg, mesh)  # 32x32 / (4,2) mesh: fine ok
    # 8x8 level: Xh=4 tiles mx=2, but Y_loc = 8/4 = 2 is even -> still ok;
    # 2x2 level: Y=2 does not tile my=4 -> crossover at level 2.
    assert parallel.replication_crossover(mg, mesh) == 2
    with pytest.raises(ValueError, match="does not tile"):
        parallel.validate_mg_sharding(mg, mesh, level=2)


def test_replicate_coarse_levels_preserves_solve(mesh):
    """Explicit gather-to-replicated crossover: replicating the coarse
    levels changes placements only, not the trajectory."""
    jax.clear_caches()  # big SPMD compile: see _clear_jit_caches
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                       nullvec_tol=1e-3)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat))
    ref = mg.solve(b, tol=1e-8, max_iter=100, track=False)

    op.coeffs = parallel.shard_coeffs(op.coeffs, mesh)
    op.apply_override = make_sharded_dslash(op.coeffs, mesh)
    try:
        parallel.replicate_coarse_levels(mg, mesh)
        res = mg.solve(parallel.shard_field(b, mesh), tol=1e-8,
                       max_iter=100, track=False)
    finally:
        op.apply_override = None
    assert int(res.iters) == int(ref.iters)
    from qmg_tpu.linalg import norm2sq
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-7


def test_dryrun_multichip_contract():
    """dryrun_multichip(8) through the self-provisioning SUBPROCESS
    path (what runs when the caller's process is not pinned to a
    virtual CPU mesh). The subprocess also
    keeps the heaviest sharded compile out of this long-lived test
    process: XLA's CPU compiler can segfault on the big SPMD K-cycle
    module late in a full-suite session (reproduced at ~120 tests in),
    while a fresh process compiles it fine."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as gmod
    gmod.dryrun_multichip(8, force_subprocess=True)


def test_mg_solve_with_sharded_fine_dslash(mesh):
    """Full K-cycle solve with the fine-level Dslash routed through the
    explicit shard_map+ppermute apply (apply_override hook); coarse
    levels and transfers ride XLA auto-sharding."""
    jax.clear_caches()  # big SPMD compile: see _clear_jit_caches
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.linalg import norm2sq

    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    g = u1.unit_gauge_u1(lat)
    op = Wilson2D(lat, 0.1, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=2, free_null_vectors=True)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat))
    ref = mg.solve(b, tol=1e-8, max_iter=200, track=False)

    op.apply_override = make_sharded_dslash(op.coeffs, mesh)
    try:
        bs = parallel.shard_field(b, mesh)
        res = mg.solve(bs, tol=1e-8, max_iter=200, track=False)
    finally:
        op.apply_override = None
    assert int(res.iters) == int(ref.iters)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-7
