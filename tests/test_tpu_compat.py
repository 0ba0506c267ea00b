"""Real-plane jit boundaries (tpu_compat): roundtrips and the whole-MG
planes solver (backend-agnostic; exercised here on CPU)."""

import numpy as np
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.tpu_compat import (to_planes, from_planes, host_to_planes,
                                make_planes_solver)
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq


def test_planes_roundtrip():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    p = host_to_planes(z, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(from_planes(jnp.asarray(p))), z)
    zz = jnp.asarray(z)
    np.testing.assert_allclose(np.asarray(from_planes(to_planes(zz))), z)


def test_planes_mg_solver_matches_complex_path():
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                       nullvec_tol=5e-4)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat))

    ref = mg.solve(b, tol=1e-8, max_iter=200, restart_freq=32, track=False)

    solve_planes, state = make_planes_solver(mg, tol=1e-8, max_iter=200,
                                             restart_freq=32)
    solve_jit = jax.jit(solve_planes)
    x_p, iters, res_sq = solve_jit(state, host_to_planes(
        np.asarray(b), dtype=np.float64))
    x = from_planes(x_p)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(x)) / norm2sq(b)))
    assert resid < 1e-7
    # Note: planes state decodes to the same values, so iteration counts
    # match the complex path exactly.
    assert int(iters) == int(ref.iters)
    # The complex hierarchy is restored untouched after tracing.
    res2 = mg.solve(b, tol=1e-8, max_iter=200, restart_freq=32,
                    track=False)
    assert int(res2.iters) == int(ref.iters)


def test_planes_solver_schur_outer():
    """outer_type=RIGHT_SCHUR (n19 config) through the planes boundary:
    prepare/reconstruct run inside the jit, full-space x comes back."""
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu.stencil import StencilType
    ST = StencilType.RIGHT_SCHUR
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = jnp.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0), jnp.complex64)
    op = Wilson2D(lat, -0.05, g, dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=150,
                       nullvec_tol=5e-4, fine_stencil_app=ST,
                       coarsest_stencil_app=ST,
                       precond_coarsen_rbjacobi=True, build_extra=2)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = np.asarray(rng.gaussian_cv(lat))
    sp, st = make_planes_solver(mg, tol=1e-5, max_iter=40, outer_type=ST)
    x_p, iters, res_sq = sp(st, host_to_planes(b))
    x = from_planes(x_p)
    from qmg_tpu.linalg import norm2sq
    bj = jnp.asarray(b, jnp.complex64)
    resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
    assert resid < 1e-4, f"resid {resid}"


def test_planes_solver_gather_coarse_apply():
    """coarse_apply='gather': static-neighbor-table coarse applies give
    the identical trajectory to the jnp formulation."""
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = jnp.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0), jnp.complex64)
    op = Wilson2D(lat, -0.05, g, dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=2, free_null_vectors=True,
                       inner_max_iter=2, coarsest_max_iter=4,
                       n_pre_smooth=1, n_post_smooth=1)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = np.asarray(rng.gaussian_cv(lat))
    sp0, st0 = make_planes_solver(mg, tol=1e-4, max_iter=40,
                                  coarse_apply="jnp")
    x0_p, it0, _ = sp0(st0, host_to_planes(b))
    sp1, st1 = make_planes_solver(mg, tol=1e-4, max_iter=40,
                                  coarse_apply="gather")
    x1_p, it1, _ = sp1(st1, host_to_planes(b))
    assert int(it0) == int(it1)
    np.testing.assert_allclose(np.asarray(x1_p), np.asarray(x0_p),
                               atol=1e-5)


def test_planes_solver_on_mesh():
    """Whole planes solve sharded over the virtual 8-device mesh: the
    fine Dslash goes through shard_map + ppermute, state/rhs planes are
    mesh-placed, and the trajectory matches the unsharded planes solve
    iteration-for-iteration."""
    import jax
    from qmg_tpu import parallel
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu.tpu_compat import shard_planes_state
    if len(jax.devices()) < 8:
        import pytest as _pytest
        _pytest.skip("needs 8 virtual devices")
    jax.clear_caches()  # big SPMD compile: see test_sharded_dslash.py
    mesh = parallel.make_mesh(8)
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    g = jnp.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0), jnp.complex64)
    op = Wilson2D(lat, -0.05, g, dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                       nullvec_tol=1e-3, inner_max_iter=2,
                       coarsest_max_iter=4, n_pre_smooth=1,
                       n_post_smooth=1)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = np.asarray(rng.gaussian_cv(lat))
    b_p = host_to_planes(b)

    sp0, st0 = make_planes_solver(mg, tol=1e-4, max_iter=40)
    x0_p, it0, _ = jax.jit(sp0)(st0, b_p)

    spm, stm = make_planes_solver(mg, tol=1e-4, max_iter=40, mesh=mesh)
    stm_placed, b_placed = shard_planes_state(stm, mesh, b_p)
    xm_p, itm, _ = jax.jit(spm)(stm_placed, b_placed)

    assert int(itm) == int(it0)
    np.testing.assert_allclose(np.asarray(xm_p), np.asarray(x0_p),
                               atol=2e-5)
