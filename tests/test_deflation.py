"""Coarsest-level deflation (reference stateful_multigrid.h:613-696 +
the deflation projection in mg_preconditioner :895-908).

The coarsest solve runs CGNR (MDAGGER_M) with the lowest/highest
eigenpairs of the normal op projected out as the initial guess; the
deflated K-cycle must converge in no more iterations than undeflated.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.stencil import StencilType
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 16


def _make(deflate: bool):
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4,
                       coarsest_stencil_app=StencilType.MDAGGER_M,
                       nullvec_max_iter=150, nullvec_tol=5e-4)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    mg.coarsest_solve.deflate = deflate
    if deflate:
        mg.deflate_coarsest(num_low=4, num_high=2)
        assert mg.coarsest_evecs.shape[0] == 6
    b = jnp.asarray(rng.gaussian_cv(lat0))
    return op, mg, b


def test_deflated_normal_coarsest_solve():
    op, mg, b = _make(deflate=True)
    res = mg.solve(b, tol=1e-9, max_iter=300, restart_freq=32)
    assert bool(res.converged)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-8
    op2, mg2, b2 = _make(deflate=False)
    res2 = mg2.solve(b2, tol=1e-9, max_iter=300, restart_freq=32)
    assert bool(res2.converged)
    assert int(res.iters) <= int(res2.iters) + 2


def test_deflate_requires_normal_op():
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=2, free_null_vectors=True)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    with pytest.raises(ValueError, match="normal op"):
        mg.deflate_coarsest(2, 0)


def test_normal_shift():
    """CoarsestSolveMG.normal_shift adds shift*I to the coarsest normal op
    (reference shift_function, stateful_multigrid.h:715-729)."""
    op, mg, b = _make(deflate=False)
    mg.coarsest_solve.normal_shift = 0.05
    res = mg.solve(b, tol=1e-9, max_iter=300, restart_freq=32)
    # A shifted (inexact) coarsest solve still preconditions: converges.
    assert bool(res.converged)


def test_deflation_crosses_planes_boundary():
    """the deflation projection must run inside the
    device-facing planes solve (c64, on the CPU here), not just the
    eager path. Oracle: the planes solve with deflation state converges
    with a true residual matching the eager deflated solve, and the
    state dict actually carries the eigenpairs."""
    import jax
    from qmg_tpu.tpu_compat import (make_planes_solver, host_to_planes,
                                    from_planes)
    op, mg, b = _make(deflate=True)
    sp, st = make_planes_solver(mg, tol=1e-7, max_iter=300, restart_freq=32)
    assert "cevals" in st and "cevecs" in st
    assert st["cevecs"].shape[0] == 6
    b_p = host_to_planes(np.asarray(b, np.complex64))
    x_p, iters, _ = jax.jit(sp)(st, b_p)
    x = from_planes(x_p).astype(b.dtype)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(x)) / norm2sq(b)))
    assert resid < 1e-5
    # The projection must have been traced in (live, not dead weight):
    # NaN eigenvalues poison the deflation initial guess, so the solve
    # can only stay finite if the deflation path is dead. (NaN, not a
    # tiny magnitude: 1e-20-scale corruption makes the stagnating run
    # grind f32 DENORMAL arithmetic, which XLA:CPU's forced-multi-device
    # threads run without flush-to-zero - a 27 s run became 40+ min
    # under the 8-virtual-device test env.)
    st_bad = dict(st)
    st_bad["cevals"] = st["cevals"] * np.float32(np.nan)
    _, iters_bad, rsq_bad = jax.jit(sp)(st_bad, b_p)
    assert not np.isfinite(float(rsq_bad))


def test_device_setup_deflation_stage():
    """setup_planes deflation stage (deflate_low/deflate_high): the
    coarsest normal op is densified ON DEVICE and its extreme eigenpairs
    join the state dict. Oracle: each (lambda, v) in the state is an
    exact eigenpair of the coarsest normal operator RECONSTRUCTED FROM
    THE SAME STATE (matched matrix - no cross-build chaos), the
    eigenvalues are the true lowest-4/highest-2 of that matrix, and the
    deflated planes solve converges."""
    import jax
    from qmg_tpu.setup_planes import (make_kcycle_setup_planes,
                                      gauss_seed_planes)
    from qmg_tpu.tpu_compat import (make_planes_solver, host_to_planes,
                                    from_planes)
    from qmg_tpu.stencil import Stencil2D, make_coeffs
    from qmg_tpu.operators.coarse import CoarseOperator2D

    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = np.asarray(u1.gauss_gauge_u1(lat0, rng, beta=6.0)).astype(
        np.complex64)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4,
                       coarsest_stencil_app=StencilType.MDAGGER_M,
                       nullvec_max_iter=150, nullvec_tol=5e-4)
    setup_fn = make_kcycle_setup_planes(lat0, cfg, -0.05,
                                        deflate_low=4, deflate_high=2)
    seeds = gauss_seed_planes(lat0, cfg, QMGRandom(99))
    state = setup_fn(host_to_planes(g), *seeds)
    assert state["cevecs"].shape[0] == 6

    # Reconstruct the coarsest stencil from the state's own planes.
    clat = Lattice2D(L // 4, L // 4, 4)
    sh = np.asarray(from_planes(state["shifts1"]))
    st = CoarseOperator2D.__new__(CoarseOperator2D)
    Stencil2D.__init__(st, make_coeffs(
        clat, clover=from_planes(state["clover1"]).astype(jnp.complex64),
        hopping=from_planes(state["hopping1"]).astype(jnp.complex64),
        shift=complex(sh[0]), eo_shift=complex(sh[1]),
        dof_shift=complex(sh[2]), dtype=jnp.complex64))
    st.is_chiral = True
    mv = st.get_apply_function(StencilType.MDAGGER_M)

    evals = np.asarray(from_planes(state["cevals"]))
    evecs = from_planes(state["cevecs"]).astype(jnp.complex64)
    for i in range(6):
        v = evecs[i]
        r = mv(v) - jnp.asarray(evals[i], jnp.complex64) * v
        assert float(jnp.sqrt(norm2sq(r))) < 5e-4, i

    # True extreme eigenvalues of the same matrix (dense oracle).
    from qmg_tpu import eig
    dense_vals, _ = eig.dense_eigensystem(mv, clat.cv_shape(),
                                          dtype=jnp.complex64)
    order = np.argsort(dense_vals.real)
    want = np.concatenate([dense_vals[order[:4]], dense_vals[order[-2:]]])
    np.testing.assert_allclose(np.sort(evals.real),
                               np.sort(want.real), rtol=2e-3)

    # Functional: the deflated planes solve converges on this state.
    op = Wilson2D(lat0, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    mg_struct = build_kcycle_hierarchy(lat0, op, cfg, QMGRandom(1),
                                       structure_only=True)
    mg_struct.coarsest_solve.deflate = True
    mg_struct.coarsest_evals = from_planes(state["cevals"])
    mg_struct.coarsest_evecs = from_planes(state["cevecs"])
    sp, _ = make_planes_solver(mg_struct, tol=1e-6, max_iter=300,
                               restart_freq=32)
    b = np.asarray(rng.gaussian_cv(lat0), np.complex64)
    x_p, iters, _ = jax.jit(sp)(state, host_to_planes(b))
    x = from_planes(x_p).astype(jnp.complex64)
    bj = jnp.asarray(b)
    resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
    assert resid < 1e-4


def test_deflation_checkpoint_roundtrip(tmp_path):
    """Deflation eigenpairs survive save_hierarchy/load_hierarchy
   ."""
    from qmg_tpu import checkpoint
    op, mg, b = _make(deflate=True)
    path = str(tmp_path / "defl.npz")
    checkpoint.save_hierarchy(mg, path)
    mg2 = checkpoint.load_hierarchy(path, op)
    assert mg2.coarsest_evecs is not None
    np.testing.assert_allclose(np.asarray(mg2.coarsest_evals),
                               np.asarray(mg.coarsest_evals), rtol=0)
    np.testing.assert_allclose(np.asarray(mg2.coarsest_evecs),
                               np.asarray(mg.coarsest_evecs), rtol=0)
    mg2.coarsest_solve.deflate = True
    res = mg2.solve(b, tol=1e-9, max_iter=300, restart_freq=32)
    assert bool(res.converged)
