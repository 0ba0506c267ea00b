"""Device-resident adaptive (n22) setup vs the eager path.

setup.adaptive_pass/build_coarse_by_restrict ran
eagerly on host only; setup_planes.make_adaptive_setup_planes traces the
same flow into per-stage jits. The 16^2 oracle here compares the traced
state against the eager build at matched seeds and c64 precision - the
n22 flow is fixed-iteration (Richardson 10, K-cycle smooth 10), so the
two runs are path-identical modulo jit-vs-eager rounding; bounds in
PARITY.md "Setup equivalence oracles".
"""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import (AdaptiveConfig, build_adaptive_hierarchy,
                           adaptive_pass)
from qmg_tpu.setup_planes import (make_adaptive_setup_planes,
                                  adaptive_seed_planes)
from qmg_tpu.tpu_compat import (mg_state_planes, host_to_planes,
                                from_planes, make_planes_solver)
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 16
MASS = -0.05


class _QuantRng:
    """Quantizes host gaussian draws to complex64 so the eager path and
    the f32-plane traced path consume bit-identical seeds."""

    def __init__(self, inner):
        self.inner = inner

    def gaussian_cv(self, lat):
        return np.asarray(self.inner.gaussian_cv(lat)).astype(np.complex64)


class _ReplayRng:
    """Replays the adaptive_seed_planes stream for the eager build."""

    def __init__(self, init_seeds, pass_seeds):
        self.q = collections.deque()
        flat = list(init_seeds)
        for per_level in pass_seeds:
            for rebuilds in per_level:
                flat.extend(rebuilds)
        for s in flat:
            a = np.asarray(jax.device_get(s))
            for k in range(a.shape[0]):
                self.q.append(
                    (a[k][..., 0] + 1j * a[k][..., 1]).astype(np.complex64))

    def gaussian_cv(self, lat):
        v = self.q.popleft()
        assert v.shape == lat.cv_shape(), (v.shape, lat.cv_shape())
        return v


def _acfg():
    return AdaptiveConfig(n_refine=2, coarse_dof=4, x_block=4, y_block=4,
                          n_setup=1)


@pytest.fixture(scope="module")
def problem():
    lat0 = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat0, rng, beta=6.0)).astype(
        np.complex64)
    b = np.asarray(rng.gaussian_cv(lat0)).astype(np.complex64)
    return lat0, gauge, b


def test_adaptive_traced_matches_eager_c64(problem):
    """The restored-oracle pattern: traced per-stage jits vs the eager
    adaptive build, identical seeds, identical (c64) precision."""
    lat0, gauge, b = problem
    acfg = _acfg()
    seeds = adaptive_seed_planes(lat0, acfg, _QuantRng(QMGRandom(4242)))

    # Eager: c64 fine op + replayed seeds through the setup.py flow.
    op = Wilson2D(lat0, MASS, jnp.asarray(gauge), dtype=jnp.complex64)
    rr = _ReplayRng(*seeds)
    mg, tvs = build_adaptive_hierarchy(lat0, op, acfg, rr)
    adaptive_pass(mg, tvs, acfg, rr)
    assert not rr.q, f"{len(rr.q)} seeds left undrawn - order mismatch"
    state_e = mg_state_planes(mg)

    # Traced.
    setup_fn = make_adaptive_setup_planes(lat0, acfg, MASS)
    state_t = setup_fn(host_to_planes(gauge), seeds[0], seeds[1])

    assert set(state_e) == set(state_t)
    for k in sorted(state_e):
        a = np.asarray(state_e[k])
        c = np.asarray(jax.device_get(state_t[k]))
        assert a.shape == c.shape, k
        scale = max(float(np.max(np.abs(a))), 1e-30)
        rel = float(np.max(np.abs(a - c))) / scale
        # Fixed-iteration flow: jit-vs-eager c64 rounding through
        # 10 Richardson + 10 K-cycle-smooth iterations (PARITY.md bound).
        assert rel < 2e-2, f"{k}: rel diff {rel:.3e}"

    # Solver-level equivalence: both states drive the SAME planes-solver
    # scaffold to the same trajectory.
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    cfg_scaffold = KCycleConfig(n_refine=acfg.n_refine,
                                coarse_dof=acfg.coarse_dof,
                                coarsest_direct=False)
    mg_struct = build_kcycle_hierarchy(lat0, op, cfg_scaffold,
                                       QMGRandom(1), structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-5, max_iter=200)
    b_p = host_to_planes(b)
    _, it_e, _ = jax.jit(sp)(state_e, b_p)
    x_t, it_t, _ = jax.jit(sp)(state_t, b_p)
    assert abs(int(it_e) - int(it_t)) <= 1, (int(it_e), int(it_t))
    bj = jnp.asarray(b)
    resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(from_planes(x_t)))
                           / norm2sq(bj)))
    assert resid < 1e-4


def test_adaptive_pass_improves_preconditioner(problem):
    """n22's point: the adaptive pass must not degrade (and should
    improve or match) the K-cycle built from initial Richardson vectors
    alone. Compare outer iteration counts through the planes solver."""
    lat0, gauge, b = problem
    acfg = _acfg()
    seeds = adaptive_seed_planes(lat0, acfg, _QuantRng(QMGRandom(4242)))

    # State after the initial (Richardson-only) levels: n_setup=0.
    acfg0 = AdaptiveConfig(n_refine=2, coarse_dof=4, x_block=4, y_block=4,
                           n_setup=0)
    seeds0 = (seeds[0], [])
    fn0 = make_adaptive_setup_planes(lat0, acfg0, MASS)
    state0 = fn0(host_to_planes(gauge), seeds0[0], seeds0[1])

    fn1 = make_adaptive_setup_planes(lat0, acfg, MASS)
    state1 = fn1(host_to_planes(gauge), seeds[0], seeds[1])

    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    op = Wilson2D(lat0, MASS, jnp.asarray(gauge), dtype=jnp.complex64)
    cfg_scaffold = KCycleConfig(n_refine=2, coarse_dof=4,
                                coarsest_direct=False)
    mg_struct = build_kcycle_hierarchy(lat0, op, cfg_scaffold,
                                       QMGRandom(1), structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-5, max_iter=300)
    b_p = host_to_planes(b)
    _, it0, _ = jax.jit(sp)(state0, b_p)
    _, it1, _ = jax.jit(sp)(state1, b_p)
    assert int(it1) <= int(it0) + 1, (
        f"adaptive pass degraded the preconditioner: {int(it1)} vs "
        f"{int(it0)} outer iters")
