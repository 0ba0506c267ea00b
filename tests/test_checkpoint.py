"""Hierarchy checkpoint/resume: a restored hierarchy must solve with the
exact iteration trajectory of the original (same coefficients, same
transfer)."""

import os

import numpy as np
import jax.numpy as jnp

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.checkpoint import save_hierarchy, load_hierarchy
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq


def test_checkpoint_roundtrip(tmp_path):
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    cfg = KCycleConfig(n_refine=2, coarse_dof=2, x_block=4, y_block=4,
                       free_null_vectors=True)
    # 16 -> 4 -> 1 point coarse; geometric null vectors keep the test
    # about (de)serialization, not setup solves.
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat))
    ref = mg.solve(b, tol=1e-8, max_iter=200, restart_freq=32, track=False)

    path = os.path.join(tmp_path, "mg.npz")
    save_hierarchy(mg, path)

    op2 = Wilson2D(lat, -0.05, g)
    mg2 = load_hierarchy(path, op2)
    assert mg2.get_num_levels() == mg.get_num_levels()
    res = mg2.solve(b, tol=1e-8, max_iter=200, restart_freq=32,
                    track=False)
    assert bool(res.converged)
    assert int(res.iters) == int(ref.iters)
    # Identical solutions: same coefficients, same trajectory.
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-12)


def test_checkpoint_asymmetric_transfer_and_decomp(tmp_path):
    """Asymmetric (R != P^dagger) transfers and saved block decompositions
    must round-trip: round 1 silently dropped them, turning the restored
    hierarchy into a different preconditioner."""
    import jax
    from qmg_tpu.transfer import TransferMG, DoublingType
    from qmg_tpu.stateful import (StatefulMultigridMG, LevelSolveMG,
                                  CoarsestSolveMG)
    from qmg_tpu.operators.coarse import CoarseSigmaType

    lat = Lattice2D(8, 8, 2)
    clat = Lattice2D(2, 2, 4)
    rng = QMGRandom(11)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    pv = jnp.stack([jnp.asarray(rng.gaussian_cv(lat)) for _ in range(4)])
    rv = pv + 0.1 * jnp.stack([jnp.asarray(rng.gaussian_cv(lat))
                               for _ in range(4)])
    t = TransferMG(lat, clat, pv, do_block_ortho=True, save_decomp=True,
                   restrict_null_vectors=rv,
                   doubling=DoublingType.OPERATOR)
    mg = StatefulMultigridMG(lat, op, CoarsestSolveMG(coarsest_tol=0.2))
    mg.push_level(clat, t, LevelSolveMG(), build_stencil=True,
                  is_chiral=True)

    b = jnp.asarray(rng.gaussian_cv(lat))
    ref = mg.solve(b, tol=1e-8, max_iter=300, restart_freq=32, track=False)
    xc = jnp.asarray(rng.gaussian_cv(clat))
    ref_sig = mg.get_stencil(1).apply_coarse_sigma(
        xc, CoarseSigmaType.SIGMA_1_L)

    path = os.path.join(tmp_path, "mg_asym.npz")
    save_hierarchy(mg, path)
    mg2 = load_hierarchy(path, Wilson2D(lat, -0.05, g))
    t2 = mg2.get_transfer(0)
    assert not t2.is_symmetric()
    assert t2.has_decompositions()
    np.testing.assert_allclose(np.asarray(t2._restrict_nvb),
                               np.asarray(t._restrict_nvb), atol=1e-14)
    res = mg2.solve(b, tol=1e-8, max_iter=300, restart_freq=32,
                    track=False)
    assert int(res.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-12)
    # The coarse sigma ops (built from the saved LU) must survive too.
    got_sig = mg2.get_stencil(1).apply_coarse_sigma(
        xc, CoarseSigmaType.SIGMA_1_L)
    np.testing.assert_allclose(np.asarray(got_sig), np.asarray(ref_sig),
                               atol=1e-12)


def test_checkpoint_lattice_mismatch(tmp_path):
    lat = Lattice2D(16, 16, 2)
    rng = QMGRandom(1)
    g = u1.unit_gauge_u1(lat)
    op = Wilson2D(lat, 0.1, g)
    cfg = KCycleConfig(n_refine=1, coarse_dof=2, free_null_vectors=True)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    path = os.path.join(tmp_path, "mg.npz")
    save_hierarchy(mg, path)
    other = Wilson2D(Lattice2D(8, 8, 2), 0.1,
                     u1.unit_gauge_u1(Lattice2D(8, 8, 2)))
    import pytest
    with pytest.raises(ValueError, match="does not match"):
        load_hierarchy(path, other)
