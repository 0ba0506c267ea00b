"""K-cycle end-to-end (reference tests n09 + n13).

n09: geometric K-cycle on the free operator via StatefulMultigridMG,
re-solving with progressively fewer levels (pop_level).

n13 (flagship): Wilson K-cycle on an interacting U(1) config with
BiCGstab(l)-generated null vectors and chiral doubling, outer FGCR to
1e-10, restart 32, 4x4 blocking, coarse_nc 8, 2+2 MinRes(0.85) smooths.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.stateful import DSLASH_KRYLOV, DSLASH_PRESMOOTH
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq


def _solve_and_check(mg, lat0, rng, tol=1e-10, max_outer=120):
    b = jnp.asarray(rng.gaussian_cv(lat0))
    res = mg.solve(b, tol=tol, max_iter=1000, restart_freq=32)
    assert bool(res.converged), f"K-cycle failed; iters={int(res.iters)}"
    assert int(res.iters) < max_outer
    ax = mg.get_stencil(0).apply_M(res.x)
    resid = float(jnp.sqrt(norm2sq(b - ax) / norm2sq(b)))
    assert resid < tol * 10
    return int(res.iters)


def test_free_wilson_kcycle_pop_levels():
    """n09-style: free Wilson (unit gauge), exact per-spin constant null
    vectors, solve at 3 then 2 levels via pop_level."""
    lat0 = Lattice2D(16, 16, 2)
    g = u1.unit_gauge_u1(lat0)
    op = Wilson2D(lat0, 0.1, g)
    cfg = KCycleConfig(n_refine=2, coarse_dof=2, free_null_vectors=True,
                       x_block=4, y_block=4)
    rng = QMGRandom(1337)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    assert mg.get_num_levels() == 3
    _solve_and_check(mg, lat0, rng)
    mg.pop_level()
    assert mg.get_num_levels() == 2
    _solve_and_check(mg, lat0, rng)


@pytest.mark.slow
def test_wilson_kcycle_interacting(cfg_dir):
    """n13 flagship at 32^2, beta=6.0, m=-0.06, 2 refinement levels."""
    lat0 = Lattice2D(32, 32, 2)
    g = u1.read_gauge_u1(lat0,
                         os.path.join(cfg_dir, "l32t32b60_heatbath.dat"))
    op = Wilson2D(lat0, -0.06, g)
    cfg = KCycleConfig(n_refine=2, coarse_dof=8)
    rng = QMGRandom(1337)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    iters = _solve_and_check(mg, lat0, rng, tol=1e-10, max_outer=60)
    # The MG solve must do real work on the coarse levels.
    assert mg.get_tracker_count(DSLASH_KRYLOV, 1) > 0
    assert mg.get_tracker_count(DSLASH_PRESMOOTH, 0) > 0
    assert mg.get_iterations_count(1) > 0
    avg = mg.query_average_iterations()
    assert avg[0] == iters
    print(f"[QMG-TEST] n13 32^2 m=-0.06: outer iters={iters}, "
          f"avg coarse/fine={avg[1]:.1f}")


# Deterministic outer-iteration pins on the shipped heatbath configs.
# Seeds are fixed (QMGRandom(1337), mirroring the reference's
# mt19937(1337u) anchor, n13:64), so iteration counts are exact and serve
# as the de-facto regression metric (SURVEY.md section 4). Recorded on
# CPU fp64; +-1 tolerance absorbs BLAS reduction-order jitter across
# machines. Includes the reference's recommended operating point
# (64^2, m=-0.075, n13:40,80-82) and the BASELINE.md 128^2-to-1e-10
# target. Table duplicated in PARITY.md.
ITER_PINS = {
    (32, -0.06, 2): 18,
    (64, -0.075, 2): 19,
    (128, -0.075, 3): 20,
    (256, -0.06, 3): 20,
}

# Plaquette of the largest shipped fixture (l256t256b60_heatbath.dat),
# recorded from u1.read_gauge_u1 on CPU fp64; guards the reader's
# site/link ordering at the 256^2 scale.
PLAQ_256 = 0.9209619275266874


def _pinned_kcycle(cfg_dir, L, mass, n_refine):
    lat0 = Lattice2D(L, L, 2)
    g = u1.read_gauge_u1(lat0,
                         os.path.join(cfg_dir, f"l{L}t{L}b60_heatbath.dat"))
    op = Wilson2D(lat0, mass, g)
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8)
    rng = QMGRandom(1337)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat0))
    res = mg.solve(b, tol=1e-10, max_iter=1000, restart_freq=32,
                   track=False)
    assert bool(res.converged)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-9
    want = ITER_PINS[(L, mass, n_refine)]
    got = int(res.iters)
    assert abs(got - want) <= 1, (
        f"n13 {L}^2 m={mass} n_refine={n_refine}: outer iters {got} "
        f"diverged from pinned {want}")
    print(f"[QMG-TEST] n13 {L}^2 m={mass}: {got} iters (pin {want})")


@pytest.mark.slow
def test_iter_pin_32sq(cfg_dir):
    _pinned_kcycle(cfg_dir, 32, -0.06, 2)


@pytest.mark.slow
def test_iter_pin_64sq_operating_point(cfg_dir):
    """The reference's recommended operating point (n13:40,80-82)."""
    _pinned_kcycle(cfg_dir, 64, -0.075, 2)


@pytest.mark.slow
def test_iter_pin_128sq_to_1e10(cfg_dir):
    """BASELINE.md rebuild target: 128^2 U(1) Wilson K-cycle to 1e-10."""
    _pinned_kcycle(cfg_dir, 128, -0.075, 3)


def test_wilson_kcycle_beats_unpreconditioned(cfg_dir):
    """MG iteration count must be far below plain GCR's."""
    from qmg_tpu import solvers
    lat0 = Lattice2D(32, 32, 2)
    g = u1.read_gauge_u1(lat0,
                         os.path.join(cfg_dir, "l32t32b60_heatbath.dat"))
    op = Wilson2D(lat0, -0.06, g)
    rng = QMGRandom(1337)
    cfg = KCycleConfig(n_refine=1, coarse_dof=8)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat0))
    res_mg = mg.solve(b, tol=1e-8, max_iter=500, restart_freq=32)
    res_gcr = solvers.gcr_restart(op.get_apply_function(), b, max_iter=500,
                                  tol=1e-8, restart_freq=32)
    assert bool(res_mg.converged)
    assert int(res_mg.iters) * 3 < int(res_gcr.iters) or \
        not bool(res_gcr.converged)


@pytest.mark.slow
def test_iter_pin_256sq(cfg_dir):
    """The reference's LARGEST shipped fixture (l256t256b60_heatbath.dat)
    enters the regression ladder: plaquette check +
    pinned outer iteration count."""
    lat0 = Lattice2D(256, 256, 2)
    g = u1.read_gauge_u1(lat0,
                         os.path.join(cfg_dir, "l256t256b60_heatbath.dat"))
    # Plaquette of the shipped beta=6 config (recorded from read; guards
    # the reader's ordering on the largest lattice).
    plaq = float(np.real(np.asarray(u1.get_plaquette_u1(g, lat0))))
    assert abs(plaq - PLAQ_256) < 1e-6, plaq
    _pinned_kcycle(cfg_dir, 256, -0.06, 3)


def test_kcycle_outer_trajectory_dense_oracle():
    """External trajectory anchor for the iteration pins: the 18/19/20
    outer-FGCR pins elsewhere in this file are
    internal regression anchors; here the SOLVER PLUMBING itself is
    verified against dense linear algebra, independent of any pinned
    count. At 16^2 on an interacting gauss gauge, the fine Wilson
    operator is densified (eig.densify — probe columns, the contract of
    /root/reference/tests/n13_wilson_kcycle/wilson_kcycle.cpp:104-106,
    459-462) and, for EVERY outer iteration k of the MG-preconditioned
    FGCR:

      * the solver's reported res_sq must equal the TRUE residual
        ||b - A_dense x_k||^2 computed with numpy dense algebra
        (residual honesty, not self-consistency);
      * the residual norms must be non-increasing (the GCR minimization
        property);

    and the converged solution must match the dense ground truth
    x* = solve(A_dense, b)."""
    from qmg_tpu.eig import densify

    lat0 = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = jnp.asarray(u1.gauss_gauge_u1(lat0, rng, beta=6.0))
    op = Wilson2D(lat0, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4, x_block=4, y_block=4)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)

    n = lat0.size_cv
    a_dense = densify(op.get_apply_function(), lat0.cv_shape(),
                      dtype=jnp.complex128)
    # The densified matrix must BE the operator: check on a random field.
    v = np.asarray(rng.gaussian_cv(lat0))
    av_stencil = np.asarray(op.apply_M(jnp.asarray(v))).reshape(n)
    av_dense = a_dense @ v.reshape(n)
    assert np.max(np.abs(av_stencil - av_dense)) < 1e-12 * np.max(
        np.abs(av_dense))

    b = np.asarray(rng.gaussian_cv(lat0))
    x_star = np.linalg.solve(a_dense, b.reshape(n))
    b_norm = float(np.linalg.norm(b.reshape(n)))

    # Converge once to learn the iteration count, then replay every
    # prefix (FGCR trajectories are prefix-stable: each iteration
    # depends only on the current residual and the stored directions).
    # max_iter only feeds the while_loop predicate (k < max_iter), so it
    # can be a TRACED argument: one compile serves every prefix replay.
    import jax
    from qmg_tpu import solvers
    from qmg_tpu.stateful import _zero_carry

    matvec = mg.get_stencil(0).get_apply_function()
    precond = mg.make_preconditioner(0)

    @jax.jit
    def solve_k(b_dev, k):
        res, _ = solvers.gcr_var_precond_restart(
            matvec, b_dev, precond, max_iter=k, tol=1e-10,
            restart_freq=32, precond_carry=_zero_carry(2))
        return res

    full = solve_k(jnp.asarray(b), jnp.int32(100))
    assert bool(full.converged)
    k_conv = int(full.iters)
    assert 2 < k_conv < 40

    prev_true = np.inf
    for k in range(1, k_conv + 1):
        res = solve_k(jnp.asarray(b), jnp.int32(k))
        x_k = np.asarray(res.x).reshape(n)
        true_res = float(np.linalg.norm(b.reshape(n) - a_dense @ x_k))
        reported = float(np.sqrt(float(np.real(np.asarray(res.res_sq)))))
        # fp64 recursion drift over <40 iterations is far below 1e-10
        # relative; any plumbing error (wrong residual update, wrong
        # projection) shows up orders of magnitude above this bound.
        assert abs(reported - true_res) <= 1e-10 * b_norm + 1e-8 * true_res, (
            f"iter {k}: reported residual {reported:.6e} != dense true "
            f"residual {true_res:.6e}")
        assert true_res <= prev_true * (1 + 1e-12), (
            f"iter {k}: GCR residual increased {prev_true:.6e} -> "
            f"{true_res:.6e}")
        prev_true = true_res

    # Converged solution against the dense ground truth (residual
    # 1e-10 through a mildly conditioned operator).
    x_full = np.asarray(full.x).reshape(n)
    err = float(np.linalg.norm(x_full - x_star)
                / np.linalg.norm(x_star))
    assert err < 1e-6, f"solution error vs dense ground truth: {err:.3e}"
    print(f"[QMG-TEST] dense-oracle trajectory: {k_conv} outer iters, "
          f"every reported residual == dense true residual, final "
          f"solution error {err:.3e}")
