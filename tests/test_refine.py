"""Mixed-precision iterative refinement to the fp64 1e-10 contract.

The reference's flagship solve is FGCR to tol 1e-10 at double precision
(tests/n13_wilson_kcycle/wilson_kcycle.cpp:104-106); the planes solver
computes in complex64. refine.refine_solve wraps the c64 MG planes solve
in a host-fp64 defect-correction loop - these tests run the c64 inner
solve on CPU (the same numerics the device executes) and check the TRUE fp64
residual.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.tpu_compat import make_refined_planes_solver
from qmg_tpu.refine import HostStencil, host_apply_M, refine_solve
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom


def test_host_apply_matches_device_apply():
    """The fp64 NumPy apply (the refinement loop's ground truth) must
    bit-track stencil.apply_M."""
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    x = rng.gaussian_cv(lat)
    want = np.asarray(op.apply_M(jnp.asarray(x)))
    got = HostStencil(op).apply(x)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_host_apply_shifts():
    """eo/dof shift semantics match stencil.apply_shift."""
    lat = Lattice2D(8, 8, 4)
    rng = np.random.default_rng(3)
    x = rng.normal(size=lat.cv_shape()) + 1j * rng.normal(
        size=lat.cv_shape())
    from qmg_tpu.stencil import make_coeffs, apply_M as japply
    clover = rng.normal(size=lat.cm_shape()) + 1j * rng.normal(
        size=lat.cm_shape())
    coeffs = make_coeffs(lat, clover=jnp.asarray(clover), shift=0.3,
                         eo_shift=0.1, dof_shift=0.05,
                         dtype=jnp.complex128)
    want = np.asarray(japply(coeffs, jnp.asarray(x)))
    got = host_apply_M(clover, None, x, shift=0.3, eo_shift=0.1,
                       dof_shift=0.05)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def _refined_problem(L, mass, n_refine, cfg_dir=None, direct=True):
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    if cfg_dir is None:
        g = np.asarray(u1.gauss_gauge_u1(lat0, rng, beta=6.0))
    else:
        g = np.asarray(u1.read_gauge_u1(
            lat0, os.path.join(cfg_dir, f"l{L}t{L}b60_heatbath.dat")))
    # The c64 hierarchy IS the device numerics; the fp64 host operator is
    # built from the same (c64-quantized) gauge so the two agree on what
    # "the operator" is - exactly the device situation, where the c64 links
    # are the uploaded truth.
    g64 = g.astype(np.complex64)
    op = Wilson2D(lat0, mass, jnp.asarray(g64), dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=8,
                       coarsest_direct=direct)
    mg = build_kcycle_hierarchy(lat0, op, cfg, rng)
    b = np.asarray(rng.gaussian_cv(lat0))
    return mg, b


def test_refine_reaches_1e10_32sq():
    """c64 inner K-cycle + host-fp64 defect correction clears 1e-10 -
    the contract a bare c64 solve cannot reach (floor ~1e-6)."""
    mg, b = _refined_problem(32, -0.05, 2)
    solve, state = make_refined_planes_solver(
        mg, tol=1e-10, inner_tol=1e-5, max_iter=200, restart_freq=32)
    res = solve(b)
    assert res.converged, f"history={res.history}"
    assert res.rel_resid < 1e-10
    # The history must show multi-digit gains per outer pass.
    assert res.outer_iters <= 8
    assert res.history[0] == 1.0
    # Cross-check against an independent fp64 residual computation.
    host = HostStencil(mg.get_stencil(0))
    rel = (np.linalg.norm((b - host.apply(res.x)).ravel())
           / np.linalg.norm(b.ravel()))
    assert rel < 1e-10


def test_refine_inner_floor_detected():
    """With a deliberately bad inner solver the loop must stop (not spin)
    and report converged=False."""
    mg, b = _refined_problem(16, -0.05, 1)
    host = HostStencil(mg.get_stencil(0))

    def bad_inner(r):
        return np.zeros_like(r), 0  # no progress at all

    res = refine_solve(host, bad_inner, b, tol=1e-10, max_outer=5)
    assert not res.converged
    assert res.outer_iters <= 1


@pytest.mark.slow
def test_refine_reaches_1e10_128sq(cfg_dir):
    """a planes-boundary solve at
    >= 128^2 reaching TRUE fp64 residual < 1e-10 (c64 inner emulated on
    CPU), on the shipped beta=6 config."""
    mg, b = _refined_problem(128, -0.075, 3, cfg_dir=cfg_dir)
    solve, state = make_refined_planes_solver(
        mg, tol=1e-10, inner_tol=1e-5, max_iter=300, restart_freq=32)
    res = solve(b)
    assert res.converged, f"history={res.history}"
    assert res.rel_resid < 1e-10
    print(f"[QMG-TEST] refined 128^2: {res.outer_iters} outer passes, "
          f"{res.inner_iters} inner iters, resid {res.rel_resid:.2e}, "
          f"history {[f'{h:.1e}' for h in res.history]}")
