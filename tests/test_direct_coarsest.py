"""Direct (dense-inverse) coarsest solve - an extension: the coarsest
level of a shipped hierarchy is tiny (4^2 x nc8 = 128-dim), so its
per-visit iterative CGNR (~100 latency-bound ops) is replaced by one
precomputed-inverse matvec. Exact coarsest solves also cannot
degrade K-cycle quality vs the reference's tol-0.2 solve."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.checkpoint import save_hierarchy, load_hierarchy
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 16


def _mk(direct: bool):
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, -0.05, g)
    cfg = KCycleConfig(n_refine=2, coarse_dof=2, free_null_vectors=True,
                       coarsest_direct=direct)
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    b = jnp.asarray(rng.gaussian_cv(lat))
    return op, mg, b


def test_direct_coarsest_converges_no_worse():
    op, mg, b = _mk(direct=True)
    assert mg.coarsest_dinv is not None
    dim = int(np.prod(mg.get_lattice(mg.get_num_levels() - 1).cv_shape()))
    assert mg.coarsest_dinv.shape == (dim, dim)
    res = mg.solve(b, tol=1e-8, max_iter=200, restart_freq=32)
    assert bool(res.converged)
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    assert resid < 1e-7
    op2, mg2, b2 = _mk(direct=False)
    res2 = mg2.solve(b2, tol=1e-8, max_iter=200, restart_freq=32)
    # An exact coarsest solve cannot need more outer iterations.
    assert int(res.iters) <= int(res2.iters)
    # Coarsest-level op counter records one op per visit, not ~hundreds.
    from qmg_tpu.stateful import DSLASH_KRYLOV
    nl = mg.get_num_levels()
    assert mg.get_tracker_count(DSLASH_KRYLOV, nl - 1) < \
        mg2.get_tracker_count(DSLASH_KRYLOV, nl - 1)


def test_direct_coarsest_checkpoint_and_planes(tmp_path):
    """The dense inverse rides checkpoints and the planes boundary."""
    from qmg_tpu.tpu_compat import (make_planes_solver, host_to_planes,
                                    from_planes)
    op, mg, b = _mk(direct=True)
    path = os.path.join(tmp_path, "mg.npz")
    save_hierarchy(mg, path)
    lat = Lattice2D(L, L, 2)
    rng2 = QMGRandom(1337)
    g = u1.gauss_gauge_u1(lat, rng2, beta=6.0)
    op2 = Wilson2D(lat, -0.05, g)
    mg2 = load_hierarchy(path, op2)
    assert mg2.coarsest_dinv is not None
    assert mg2.get_coarsest_solve().direct
    ref = mg.solve(b, tol=1e-8, max_iter=200, restart_freq=32, track=False)
    res = mg2.solve(b, tol=1e-8, max_iter=200, restart_freq=32, track=False)
    assert int(res.iters) == int(ref.iters)

    sp, st = make_planes_solver(mg2, tol=1e-6, max_iter=100)
    assert "cdinv" in st
    xp, iters, rsq = sp(st, host_to_planes(np.asarray(b)))
    x = from_planes(xp).astype(jnp.complex128)
    bj = jnp.asarray(b)
    resid = float(jnp.sqrt(norm2sq(bj - op2.apply_M(x)) / norm2sq(bj)))
    assert resid < 1e-4
    assert mg2.coarsest_dinv is not None  # restored after trace


def test_update_links_invalidates_dinv():
    op, mg, b = _mk(direct=True)
    assert mg.coarsest_dinv is not None
    lat1 = mg.get_lattice(1)
    # Rebuilding/updating the coarsest level drops the stale inverse.
    mg.pop_level()
    assert mg.coarsest_dinv is None
