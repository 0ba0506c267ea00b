"""Eigensolver scenarios (reference tests n10 + n12).

n10: full staggered spectrum - the massless staggered operator is
anti-hermitian, so its spectrum with mass m lies on the line Re = m; the
free-field spectrum is known in closed form.

n12: Wilson full spectrum + partial (smallest-magnitude) spectrum; the
partial solver must agree with the dense oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Staggered2D, Wilson2D
from qmg_tpu import u1, eig
from qmg_tpu.rng import QMGRandom

L = 8


def test_staggered_spectrum_on_mass_line():
    lat = Lattice2D(L, L, 1)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    m = 0.1
    op = Staggered2D(lat, m, g)
    evals, _ = eig.dense_eigensystem(op.get_apply_function(),
                                     lat.cv_shape())
    np.testing.assert_allclose(evals.real, m, atol=1e-12)
    # Spectrum symmetric under conjugation about the mass line.
    ims = np.sort(evals.imag)
    np.testing.assert_allclose(ims, -ims[::-1], atol=1e-10)


def test_free_staggered_spectrum_closed_form():
    """Free staggered: eigenvalues m +- i sqrt(sin^2 kx + sin^2 ky)."""
    lat = Lattice2D(L, L, 1)
    g = u1.unit_gauge_u1(lat)
    m = 0.05
    op = Staggered2D(lat, m, g)
    evals, _ = eig.dense_eigensystem(op.get_apply_function(),
                                     lat.cv_shape())
    ks = 2 * np.pi * np.arange(L) / L
    expect = []
    for kx in ks[: L // 2]:
        for ky in ks[: L // 2]:
            lam = np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
            expect += [lam] * 4  # doubling: 4 copies per momentum pair
    got = np.sort(np.abs(evals.imag))
    np.testing.assert_allclose(got, np.sort(expect), atol=1e-10)


def test_wilson_spectrum_gamma5_symmetry():
    """Wilson spectrum is symmetric under complex conjugation
    (gamma5-hermiticity: eigenvalues come in (lambda, conj(lambda)))."""
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    evals, evecs = eig.dense_eigensystem(op.get_apply_function(),
                                         lat.cv_shape())
    def stable_sort(v):
        # round the real key so conjugate near-ties sort identically
        return v[np.lexsort((v.imag, np.round(v.real, 6)))]

    np.testing.assert_allclose(stable_sort(np.conj(evals)),
                               stable_sort(evals), atol=1e-6)
    # Eigenpair residual check on a few vectors.
    for i in (0, len(evals) // 2, len(evals) - 1):
        v = jnp.asarray(evecs[i])
        r = op.apply_M(v) - evals[i] * v
        assert float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))) < 1e-8


def test_partial_spectrum_matches_dense():
    """Partial (20 smallest-magnitude) eigenvalues via the arnoldi entry
    point agree with the dense oracle (reference n12:162-219)."""
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    dense_vals, _ = eig.dense_eigensystem(op.get_apply_function(),
                                          lat.cv_shape())
    vals, vecs = eig.arnoldi_eigensystem(op.get_apply_function(),
                                         lat.cv_shape(), nev=20,
                                         which=eig.SMALLEST_MAGNITUDE)
    want = dense_vals[np.argsort(np.abs(dense_vals))[:20]]
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(want)), rtol=1e-6)


def test_arnoldi_iterative_path(monkeypatch):
    """Force the restarted-Arnoldi path (not the dense fallback) and
    check Ritz pairs against the dense oracle."""
    monkeypatch.setattr(eig, "_DENSE_CUTOFF", 8)
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    vals, vecs = eig.arnoldi_eigensystem(op.get_apply_function(),
                                         lat.cv_shape(), nev=8,
                                         which=eig.LARGEST_MAGNITUDE,
                                         ncv=32, tol=1e-8)
    monkeypatch.setattr(eig, "_DENSE_CUTOFF", 4096)
    dense_vals, _ = eig.dense_eigensystem(op.get_apply_function(),
                                          lat.cv_shape())
    want = dense_vals[np.argsort(-np.abs(dense_vals))[:8]]
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(want)), rtol=1e-5)
    # Residuals of returned Ritz pairs.
    for i in range(8):
        v = jnp.asarray(vecs[i])
        r = op.apply_M(v) - vals[i] * v
        assert float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))) < 1e-5


def test_arnoldi_iterative_path_smallest_magnitude(monkeypatch):
    """The deflation-relevant selector (SMALLEST_MAGNITUDE) through the
    true restarted-Arnoldi branch, small op so the dense oracle is
    exact."""
    lat = Lattice2D(8, 8, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    mv = op.get_apply_function()
    dense_vals, _ = eig.dense_eigensystem(mv, lat.cv_shape())
    monkeypatch.setattr(eig, "_DENSE_CUTOFF", 8)
    vals, vecs = eig.arnoldi_eigensystem(mv, lat.cv_shape(), nev=6,
                                         which=eig.SMALLEST_MAGNITUDE,
                                         tol=1e-9)
    want = dense_vals[np.argsort(np.abs(dense_vals))[:6]]
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(want)), rtol=1e-6)
    for i in range(6):
        v = jnp.asarray(vecs[i])
        r = mv(v) - vals[i] * v
        assert float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))) < 1e-6


def test_shift_invert_smallest_magnitude():
    """Shift-invert Arnoldi nails the smallest-|lambda| Wilson spectrum
    at the DEFAULT subspace size, where plain Arnoldi at 32^2 needs
    ncv=64 and hundreds of restarts (an extra beyond the reference's
    regular-mode ARPACK)."""
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    mv = op.get_apply_function()

    from qmg_tpu import solvers

    def solve(v):
        return solvers.bicgstab_l(mv, v, max_iter=2000, tol=1e-10).x

    vals, vecs = eig.shift_invert_eigensystem(solve, lat.cv_shape(),
                                              nev=6, sigma=0.0,
                                              tol=1e-8, matvec=mv)
    dense_vals, _ = eig.dense_eigensystem(mv, lat.cv_shape())
    want = dense_vals[np.argsort(np.abs(dense_vals))[:6]]
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(want)), rtol=1e-6)
    for i in range(6):
        v = jnp.asarray(vecs[i])
        r = mv(v) - vals[i] * v
        assert float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))) < 1e-6


@pytest.mark.slow
def test_shift_invert_with_mg_inner_solve():
    """The production composition: the MG K-cycle planes solver as the
    shift-invert inner operator, traced INSIDE the jitted Arnoldi sweep
    (one compiled program = Arnoldi step + full MG solve). c64
    throughout - the device path for computing deflation-grade low
    modes at sizes where dense/plain-Arnoldi are infeasible."""
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu.tpu_compat import make_planes_solver, to_planes, \
        from_planes
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    g = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = Wilson2D(lat, -0.05, jnp.asarray(g), dtype=jnp.complex64)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=150,
                       nullvec_tol=5e-4, coarsest_direct=True)
    mg = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(7))
    sp, state = make_planes_solver(mg, tol=1e-6, max_iter=200,
                                   restart_freq=16)
    mv = op.get_apply_function()

    def solve(v):
        x_p, _, _ = sp(state, to_planes(v.astype(jnp.complex64)))
        return from_planes(x_p).astype(v.dtype)

    vals, vecs = eig.shift_invert_eigensystem(
        solve, lat.cv_shape(), nev=6, sigma=0.0, tol=1e-7,
        dtype=jnp.complex64, matvec=mv)
    dense_vals, _ = eig.dense_eigensystem(mv, lat.cv_shape(),
                                          dtype=jnp.complex64)
    want = dense_vals[np.argsort(np.abs(dense_vals))[:6]]
    np.testing.assert_allclose(np.sort(np.abs(vals)),
                               np.sort(np.abs(want)), rtol=1e-5)
    for i in range(6):
        v = jnp.asarray(vecs[i])
        r = mv(v) - jnp.asarray(vals[i], jnp.complex64) * v
        # c64 floor: the inner solve stops at 1e-6 relative.
        assert float(jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))) < 5e-6
