"""Multi-RHS (batched) planes solver (tpu_compat.make_batched_planes_solver).

Throughput mode: the whole MG K-cycle vmaps over a leading
rhs axis. XLA's while_loop batching masks carry updates per lane, so
each rhs must follow EXACTLY its own single-rhs trajectory - same
iteration count, same solution - while sharing one device program.
(The reference streams one solve per source: n15 wilson_goldstone.cpp.)
"""

import numpy as np
import jax
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.tpu_compat import (make_planes_solver,
                                make_batched_planes_solver,
                                host_to_planes, from_planes)
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 32
NRHS = 3


def _problem():
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = Wilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=150,
                       nullvec_tol=5e-4, coarsest_direct=True)
    mg = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(7))
    # Distinct rhs: a gaussian, a point source, and a wall-ish source so
    # the lanes converge at different iteration counts.
    rhs = [np.asarray(rng.gaussian_cv(lat), np.complex64)]
    pt = np.zeros(lat.cv_shape(), np.complex64)
    pt[0, 0, 0, 0] = 1.0
    rhs.append(pt)
    wall = np.zeros(lat.cv_shape(), np.complex64)
    wall[:, 0, :, :] = 1.0
    rhs.append(wall)
    return lat, op, mg, rhs


def test_batched_matches_sequential():
    lat, op, mg, rhs = _problem()
    tol = 1e-5
    sp, state = make_planes_solver(mg, tol=tol, max_iter=200,
                                   restart_freq=32)
    sp_jit = jax.jit(sp)
    seq = [sp_jit(state, host_to_planes(b)) for b in rhs]

    bsolve, bstate = make_batched_planes_solver(mg, tol=tol, max_iter=200,
                                                restart_freq=32)
    B_p = jnp.stack([host_to_planes(b) for b in rhs])
    X_p, iters, res_sq = jax.jit(bsolve)(bstate, B_p)
    assert X_p.shape[0] == NRHS

    its = np.asarray(iters)
    assert len(set(int(i) for i in its)) >= 2, (
        "test rhs should converge at different counts")
    for k, b in enumerate(rhs):
        # Per-lane trajectory == the single-rhs trajectory (batched
        # einsum reduction orders can flip the c64 stopping test by 1).
        assert abs(int(its[k]) - int(seq[k][1])) <= 1, k
        x = from_planes(X_p[k]).astype(jnp.complex64)
        bj = jnp.asarray(b)
        resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
        assert resid < 10 * tol, (k, resid)
        # Frozen-lane check: the batched solution matches the
        # single-rhs solution, not an over-iterated one.
        xs = from_planes(seq[k][0]).astype(jnp.complex64)
        d = float(jnp.sqrt(norm2sq(x - xs) / norm2sq(xs)))
        assert d < 1e-2, (k, d)


def test_fixed_schedule_batched_solver():
    """Fixed-schedule mode: with inner_fixed_iters + direct coarsest +
    fixed outer trips, NO loop in the program has a data-dependent
    stopping test, so the vmapped solve batches with no per-lane
    masking. Oracle: the fixed-schedule batched solve still converges
    (true residuals below tol x margin) and reports the achieved
    residual honestly."""
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = Wilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=150,
                       nullvec_tol=5e-4, coarsest_direct=True,
                       inner_fixed_iters=4)
    mg = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(7))
    assert mg.get_level_solve(1).fixed_trips

    from qmg_tpu.tpu_compat import make_fixed_batched_planes_solver
    bsolve, state = make_fixed_batched_planes_solver(
        mg, outer_iters=16, tol=1e-5, restart_freq=16)
    B_p = jnp.stack([host_to_planes(
        np.asarray(rng.gaussian_cv(lat), np.complex64)) for _ in range(3)])
    X_p, iters, res_sq = jax.jit(bsolve)(state, B_p)
    assert np.all(np.asarray(iters) == 16)  # fixed trips, by construction
    for k in range(3):
        x = from_planes(X_p[k]).astype(jnp.complex64)
        b = from_planes(B_p[k]).astype(jnp.complex64)
        resid = float(jnp.sqrt(norm2sq(b - op.apply_M(x)) / norm2sq(b)))
        assert resid < 1e-4, (k, resid)


def test_fixed_schedule_requires_direct_coarsest():
    import pytest
    from qmg_tpu.tpu_compat import make_fixed_batched_planes_solver
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = Wilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, nullvec_max_iter=100,
                       nullvec_tol=5e-4, coarsest_direct=False,
                       inner_fixed_iters=4)
    mg = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(7))
    with pytest.raises(ValueError, match="direct coarsest"):
        make_fixed_batched_planes_solver(mg, outer_iters=8)


def test_calibrated_batched_solver():
    """make_calibrated_batched_planes_solver: one masked probe solve
    picks the fixed outer trip count; every rhs then meets the target
    tolerance without >1 decade overshoot."""
    from qmg_tpu.tpu_compat import make_calibrated_batched_planes_solver
    lat, op, mg, rhs = _problem()
    tol = 1e-5
    probe = host_to_planes(np.asarray(rhs[0]))
    solve, state, outer = make_calibrated_batched_planes_solver(
        mg, probe, tol=tol, max_iter=200, restart_freq=32)
    # Gaussian lanes only (same distribution as the probe - the
    # calibration contract is per-source-ensemble).
    rng2 = QMGRandom(99)
    lanes = [np.asarray(rng2.gaussian_cv(lat), np.complex64)
             for _ in range(3)]
    B_p = jnp.stack([host_to_planes(b) for b in lanes])
    X_p, iters, res_sq = jax.jit(solve)(state, B_p)
    assert np.all(np.asarray(iters) == outer)
    bsq = np.array([float(norm2sq(jnp.asarray(b))) for b in lanes])
    rel = np.asarray(res_sq, np.float64) / (tol ** 2 * bsq)
    assert np.max(rel) <= 1.0, rel       # tolerance met on every lane
    assert np.max(rel) >= 1e-2, rel      # no >1 decade overshoot
    # True residual agrees (the fixed-trip solver is a real solve).
    for k, b in enumerate(lanes):
        x = np.asarray(from_planes(X_p[k]))
        r = b - np.asarray(op.apply_M(jnp.asarray(x)))
        true_rel = np.linalg.norm(r) / np.linalg.norm(b)
        assert true_rel < 2 * tol, true_rel
