"""Schur-everywhere K-cycle with rbjacobi coarsening (reference test n19,
tests/n19_wilson_kcycle_precond/wilson_kcycle_precond.cpp).

Every level solves QMG_MATVEC_RIGHT_SCHUR; null vectors are generated
against the rbjacobi operator with restarted GCR (:237); coarse levels
Galerkin-coarsen the RBJACOBI stencil and pre-build their own rbjacobi
form (:171, :290); the outer solve runs on the Schur-prepared system and
reconstructs (:360-383).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.operators.coarse import CoarseOperator2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.stencil import StencilType
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 16


def test_schur_kcycle_end_to_end():
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    op.build_rbjacobi_stencil()  # reference n19:155

    cfg = KCycleConfig(
        n_refine=1, coarse_dof=8,
        fine_stencil_app=StencilType.RIGHT_SCHUR,
        coarsest_stencil_app=StencilType.RIGHT_SCHUR,
        nullvec_stype=StencilType.RIGHT_JACOBI,
        nullvec_solver="gcr_restart",
        precond_coarsen_rbjacobi=True,
        build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)

    b = jnp.asarray(rng.gaussian_cv(lat0))
    # Outer solve on the Schur-prepared system (reference :360-369).
    b_prep = op.prepare_M(b, StencilType.RIGHT_SCHUR)
    res = mg.solve(b_prep, tol=1e-10, max_iter=400, restart_freq=32,
                   outer_type=StencilType.RIGHT_SCHUR)
    assert bool(res.converged), f"iters={int(res.iters)}"
    x = op.reconstruct_M(res.x, b, StencilType.RIGHT_SCHUR)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(x)) / norm2sq(b)))
    assert resid < 1e-9, f"check tolerance {resid}"
    assert int(res.iters) < 60


def test_schur_kcycle_direct_coarsest():
    """Direct (dense-inverse) coarsest under a RIGHT_SCHUR coarsest app.

    prepare_direct_coarsest densifies on the Schur even half-space
    (solve_size_shape) - the exact coarsest must precondition at least
    as well as the tol-0.2 iterative one, and the reconstruction must
    hit the same outer contract. This is what lets the n19
    configuration use the one-matmul coarsest (and the fixed-schedule
    batched path) on the device.
    """
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    op.build_rbjacobi_stencil()

    cfg = KCycleConfig(
        n_refine=1, coarse_dof=8,
        fine_stencil_app=StencilType.RIGHT_SCHUR,
        coarsest_stencil_app=StencilType.RIGHT_SCHUR,
        nullvec_stype=StencilType.RIGHT_JACOBI,
        nullvec_solver="gcr_restart",
        precond_coarsen_rbjacobi=True,
        build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    mg_it = build_kcycle_hierarchy(lat0, op, cfg, QMGRandom(1337))
    import dataclasses
    cfg_d = dataclasses.replace(cfg, coarsest_direct=True)
    mg_dir = build_kcycle_hierarchy(lat0, op, cfg_d, QMGRandom(1337))
    assert mg_dir.coarsest_dinv is not None
    # The dense inverse lives on the even half-space.
    half = mg_dir.get_stencil(1).solve_size_shape(StencilType.RIGHT_SCHUR)
    n_half = int(np.prod(half))
    assert mg_dir.coarsest_dinv.shape == (n_half, n_half)

    b = jnp.asarray(rng.gaussian_cv(lat0))
    b_prep = op.prepare_M(b, StencilType.RIGHT_SCHUR)
    res_it = mg_it.solve(b_prep, tol=1e-10, max_iter=400, restart_freq=32,
                         outer_type=StencilType.RIGHT_SCHUR)
    res = mg_dir.solve(b_prep, tol=1e-10, max_iter=400, restart_freq=32,
                       outer_type=StencilType.RIGHT_SCHUR)
    assert bool(res.converged), f"iters={int(res.iters)}"
    # Exact coarsest preconditions at least as well (allow +1 for
    # stopping-test roundoff).
    assert int(res.iters) <= int(res_it.iters) + 1
    x = op.reconstruct_M(res.x, b, StencilType.RIGHT_SCHUR)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(x)) / norm2sq(b)))
    assert resid < 1e-9, f"check tolerance {resid}"


def test_schur_coarse_op_consistency():
    """The coarsened-rbjacobi operator must equal R (A B^{-1}) P."""
    lat0 = Lattice2D(L, L, 2)
    lat1 = Lattice2D(4, 4, 4)
    rng = QMGRandom(7)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    from qmg_tpu.transfer import TransferMG, DoublingType
    nv = jnp.stack([jnp.asarray(rng.gaussian_cv(lat0)) for _ in range(4)])
    t = TransferMG(lat0, lat1, nv, do_block_ortho=True,
                   doubling=DoublingType.PROJECTION)
    coarse = CoarseOperator2D(lat1, op, t, is_chiral=True,
                              use_rbjacobi=True,
                              build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    xc = jnp.asarray(rng.gaussian_cv(lat1))
    built = coarse.apply_M(xc)
    emulated = t.restrict_f2c(
        op.apply_M(t.prolong_c2f(xc), StencilType.RIGHT_JACOBI))
    err = float(jnp.sqrt(norm2sq(built - emulated) / norm2sq(emulated)))
    assert err < 1e-11
    # rbjacobi coarsening transfers zero shift (rbj op has none).
    assert complex(coarse.coeffs.shift) == 0.0


def test_coarse_nc8_rbjacobi_qr_inverse():
    """SURVEY hard part #3: the batched per-site QR inverse must hold at
    coarse nc=8 - B B^{-1} = I per site, and the coarse rbjacobi op
    equals M B^{-1} densified."""
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu import linalg
    from qmg_tpu.stencil import mass_pattern

    lat0 = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=8, nullvec_max_iter=150,
                       nullvec_tol=5e-4)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    coarse = mg.get_stencil(1)
    assert coarse.lat.nc == 8
    rbj = coarse.build_rbjacobi_stencil()
    b_mat = mass_pattern(coarse.coeffs) + coarse.coeffs.clover
    ident = linalg.site_matmul(b_mat, rbj.cinv)
    eye = linalg.identity_like(b_mat)
    assert float(jnp.max(jnp.abs(ident - eye))) < 1e-10
    # rbj apply == M(B^{-1} x).
    xc = jnp.asarray(rng.gaussian_cv(coarse.lat))
    got = coarse.apply_M(xc, StencilType.RIGHT_JACOBI)
    expect = coarse.apply_M(linalg.site_matvec(rbj.cinv, xc))
    assert float(jnp.max(jnp.abs(got - expect))) < 1e-10


def test_schur_fused_apply_matches_sequential():
    """The precomposed 9-point Schur apply (build_rbj_schur_fused) is
    exactly the sequential two-half-hopping apply (apply_rbj_schur), on
    both the fine Wilson rbjacobi and an nc=8 Galerkin coarse rbjacobi."""
    from qmg_tpu.stencil import (apply_rbj_schur, build_rbj_schur_fused,
                                 apply_rbj_schur_fused)
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat0, rng, beta=6.0)
    op = Wilson2D(lat0, -0.05, g)
    cfg = KCycleConfig(
        n_refine=1, coarse_dof=8,
        fine_stencil_app=StencilType.RIGHT_SCHUR,
        coarsest_stencil_app=StencilType.RIGHT_SCHUR,
        nullvec_stype=StencilType.RIGHT_JACOBI,
        nullvec_solver="gcr_restart",
        precond_coarsen_rbjacobi=True,
        build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    for lvl in range(mg.get_num_levels()):
        st = mg.get_stencil(lvl)
        rbj = st.build_rbjacobi_stencil()
        lat = st.lat
        xr = np.random.default_rng(lvl).standard_normal(
            (lat.y_len, lat.xh, lat.nc))
        xi = np.random.default_rng(lvl + 9).standard_normal(
            (lat.y_len, lat.xh, lat.nc))
        x = jnp.asarray(xr + 1j * xi)
        seq = apply_rbj_schur(rbj, x)
        fused = build_rbj_schur_fused(rbj)
        got = apply_rbj_schur_fused(fused, x)
        np.testing.assert_allclose(np.asarray(got), np.asarray(seq),
                                   rtol=1e-11, atol=1e-11)
        # And the dispatcher routes through the fused path.
        via_dispatch = st.apply_M(x, StencilType.RIGHT_SCHUR)
        np.testing.assert_allclose(np.asarray(via_dispatch),
                                   np.asarray(seq), rtol=1e-11,
                                   atol=1e-11)
