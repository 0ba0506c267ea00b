"""Device-resident (jittable) setup vs the eager host build.

setup_planes.make_kcycle_setup_planes traces the WHOLE n13 setup
(null-vector solves, block ortho, Galerkin coarse build, dense coarsest
inverse) into one jit. Oracles are functional (P(dagger)P = 1 and the
n08 Galerkin identity on the traced state, then an end-to-end solve):
elementwise equality with the eager build is NOT required, since
eager-vs-jit rounding in the c64 Krylov null-vector solves yields
legitimately different near-null spaces.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.setup_planes import (make_kcycle_setup_planes,
                                  gauss_seed_planes)
from qmg_tpu.tpu_compat import (make_planes_solver, mg_state_planes,
                                host_to_planes, from_planes)
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom
from qmg_tpu.linalg import norm2sq

L = 32
MASS = -0.05


def _cfg():
    return KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=120,
                        nullvec_tol=1e-3, coarsest_direct=True)


def test_traced_setup_state_galerkin_oracle():
    """n08-style functional oracle on the TRACED state: the coarse
    operator it built must equal prolong -> fine apply -> restrict
    through its own block-orthonormalized null vectors, and P(dagger)P = 1.
    (Elementwise comparison against the eager build is NOT a valid
    oracle: eager-vs-jit rounding in the c64 Krylov null-vector solves
    yields legitimately different near-null spaces.)"""
    cfg = _cfg()
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))
    setup_fn = make_kcycle_setup_planes(lat, cfg, MASS)
    state = setup_fn(host_to_planes(np.asarray(gauge)), *seeds)

    from qmg_tpu.stencil import make_coeffs, apply_M
    from qmg_tpu.transfer import TransferMG, DoublingType
    lats = [Lattice2D(L, L, 2),
            Lattice2D(L // 4, L // 4, cfg.coarse_dof),
            Lattice2D(L // 16, L // 16, cfg.coarse_dof)]
    for lvl in range(2):
        lat_f, lat_c = lats[lvl], lats[lvl + 1]
        nvb = from_planes(jnp.asarray(state[f"nvb{lvl}"]))
        # state nvb is the transfer's BLOCKED layout (nvec, 2c, B, Yc,
        # Xhc): build a shape-only transfer and inject it, the same
        # way the planes solver patches hierarchies.
        dummy = jnp.zeros((cfg.coarse_dof,) + lat_f.cv_shape(),
                          jnp.complex64)
        t = TransferMG(lat_f, lat_c, dummy, do_block_ortho=False,
                       doubling=DoublingType.PROJECTION)
        t._nvb = nvb
        sh_f = from_planes(jnp.asarray(state[f"shifts{lvl}"]))
        sh_c = from_planes(jnp.asarray(state[f"shifts{lvl + 1}"]))
        cf = make_coeffs(
            lat_f, clover=from_planes(jnp.asarray(state[f"clover{lvl}"])),
            hopping=from_planes(jnp.asarray(state[f"hopping{lvl}"])),
            shift=sh_f[0], eo_shift=sh_f[1], dof_shift=sh_f[2],
            dtype=jnp.complex64)
        cc = make_coeffs(
            lat_c,
            clover=from_planes(jnp.asarray(state[f"clover{lvl + 1}"])),
            hopping=from_planes(jnp.asarray(state[f"hopping{lvl + 1}"])),
            shift=sh_c[0], eo_shift=sh_c[1], dof_shift=sh_c[2],
            dtype=jnp.complex64)
        rng2 = QMGRandom(7 + lvl)
        xc = jnp.asarray(rng2.gaussian_cv(lat_c), jnp.complex64)
        # P(dagger)P = 1 on the coarse space.
        rt = t.restrict_f2c(t.prolong_c2f(xc))
        np.testing.assert_allclose(np.asarray(rt), np.asarray(xc),
                                   atol=2e-5)
        # Galerkin: A_c x = R A_f P x.
        built = apply_M(cc, xc)
        emulated = t.restrict_f2c(apply_M(cf, t.prolong_c2f(xc)))
        scale = float(jnp.max(jnp.abs(emulated)))
        np.testing.assert_allclose(np.asarray(built), np.asarray(emulated),
                                   atol=3e-5 * scale,
                                   err_msg=f"Galerkin oracle at level {lvl}")


def test_traced_setup_state_drives_planes_solver():
    """structure_only scaffold + traced-setup state = working solver."""
    cfg = _cfg()
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, MASS, jnp.asarray(gauge, jnp.complex64),
                  dtype=jnp.complex64)

    mg_struct = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(1),
                                       structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-6, max_iter=100)

    setup_fn = make_kcycle_setup_planes(lat, cfg, MASS)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))
    state = setup_fn(host_to_planes(np.asarray(gauge)), *seeds)

    # Monolithic single-jit variant produces an equivalent state
    # (the per-level default chains smaller XLA modules).
    setup_mono = make_kcycle_setup_planes(lat, cfg, MASS,
                                          per_level_jit=False)
    state_mono = jax.jit(setup_mono)(host_to_planes(np.asarray(gauge)),
                                     *seeds)
    assert set(state_mono) == set(state)
    for k in sorted(state):
        np.testing.assert_allclose(
            np.asarray(state_mono[k]), np.asarray(state[k]),
            atol=2e-2 * max(float(np.max(np.abs(np.asarray(state[k])))),
                            1e-3),
            err_msg=f"monolithic vs per-level setup diverged at {k}")

    b = np.asarray(rng.gaussian_cv(lat))
    x_p, iters, rsq = jax.jit(sp)(state, host_to_planes(b))
    x = from_planes(x_p)
    bj = jnp.asarray(b, jnp.complex64)
    resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
    assert resid < 1e-5, f"true resid {resid}"
    # The real (solved) null vectors must precondition far better than
    # the structure_only gaussians.
    _, st_struct = make_planes_solver(mg_struct, tol=1e-6, max_iter=100)
    x2_p, iters2, _ = jax.jit(sp)(st_struct, host_to_planes(b))
    assert int(iters) < int(iters2), (
        f"traced-setup state ({int(iters)} iters) should beat the "
        f"gaussian scaffold ({int(iters2)})")


def test_traced_setup_n19_schur_config():
    """Device setup under the n19 configuration: rbjacobi null-vector
    stype (traced batched-QR derived build), rbjacobi coarsening, Schur
    outer solve through the planes boundary."""
    from qmg_tpu.stencil import StencilType
    from qmg_tpu.operators.coarse import CoarseOperator2D
    cfg = KCycleConfig(
        n_refine=1, coarse_dof=4, nullvec_max_iter=150, nullvec_tol=1e-3,
        fine_stencil_app=StencilType.RIGHT_SCHUR,
        coarsest_stencil_app=StencilType.RIGHT_SCHUR,
        nullvec_stype=StencilType.RIGHT_JACOBI,
        nullvec_solver="gcr_restart",
        precond_coarsen_rbjacobi=True,
        build_extra=CoarseOperator2D.BUILD_RBJACOBI,
        coarsest_direct=False)  # Schur coarsest is half-space; no direct
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = Wilson2D(lat, MASS, jnp.asarray(gauge, jnp.complex64),
                  dtype=jnp.complex64)

    mg_struct = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(1),
                                       structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-6, max_iter=150,
                               outer_type=StencilType.RIGHT_SCHUR)
    setup_fn = make_kcycle_setup_planes(lat, cfg, MASS)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))
    state = setup_fn(host_to_planes(np.asarray(gauge)), *seeds)
    b = np.asarray(rng.gaussian_cv(lat))
    x_p, iters, rsq = jax.jit(sp)(state, host_to_planes(b))
    x = from_planes(x_p)
    bj = jnp.asarray(b, jnp.complex64)
    resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x)) / norm2sq(bj)))
    assert resid < 1e-5, f"true resid {resid}"
    assert int(iters) < 100


def test_mesh_sharded_setup_matches_single_device():
    """the device-resident setup sharded over the
    mesh (per-level jits with lattice-sharded stage boundaries) must
    produce the same state as the single-device setup at matched seeds
    and precision. Null-vector solves run a FIXED iteration count
    (tol=0), making the two runs path-identical; the only differences
    are SPMD reduction orders, so fp64 states agree to roundoff (see
    PARITY.md 'Setup equivalence oracles')."""
    from qmg_tpu import parallel
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jax.clear_caches()  # big SPMD compiles (see test_sharded_dslash)
    mesh = parallel.make_mesh(8)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, x_block=4, y_block=4,
                       nullvec_max_iter=24, nullvec_tol=0.0,
                       coarsest_direct=False)
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0))
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999), dtype=np.float64)
    gauge_p = host_to_planes(gauge, dtype=np.float64)

    setup_u = make_kcycle_setup_planes(lat, cfg, MASS,
                                       dtype=jnp.complex128)
    state_u = setup_u(gauge_p, *seeds)
    setup_s = make_kcycle_setup_planes(lat, cfg, MASS,
                                       dtype=jnp.complex128, mesh=mesh)
    state_s = setup_s(gauge_p, *seeds)
    assert set(state_u) == set(state_s)
    for k in sorted(state_u):
        a = np.asarray(jax.device_get(state_u[k]))
        c = np.asarray(jax.device_get(state_s[k]))
        scale = max(float(np.max(np.abs(a))), 1e-30)
        assert float(np.max(np.abs(a - c))) <= 1e-8 * scale, (
            f"sharded setup diverged at {k}")
    # The fine-level outputs really are lattice-sharded, not replicated.
    sh = state_s["clover0"].sharding
    assert not sh.is_fully_replicated


def test_mesh_sharded_cf_setup_matches_single_device():
    """channels_first composes with mesh: the cf stages keep standard
    plane formats at stage boundaries, so the same NamedShardings apply
    and the SPMD-partitioned cf setup must match the single-device cf
    setup at fp64 (pinned trajectory; differences = psum orders)."""
    from qmg_tpu import parallel
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jax.clear_caches()  # big SPMD compiles (see test_sharded_dslash)
    mesh = parallel.make_mesh(8)
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, x_block=4, y_block=4,
                       nullvec_max_iter=24, nullvec_tol=0.0,
                       coarsest_direct=False)
    lat = Lattice2D(32, 32, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0))
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999), dtype=np.float64)
    gauge_p = host_to_planes(gauge, dtype=np.float64)

    setup_u = make_kcycle_setup_planes(lat, cfg, MASS,
                                       dtype=jnp.complex128,
                                       channels_first=True)
    state_u = setup_u(gauge_p, *seeds)
    setup_s = make_kcycle_setup_planes(lat, cfg, MASS,
                                       dtype=jnp.complex128, mesh=mesh,
                                       channels_first=True)
    state_s = setup_s(gauge_p, *seeds)
    assert set(state_u) == set(state_s)
    for k in sorted(state_u):
        a = np.asarray(jax.device_get(state_u[k]))
        c = np.asarray(jax.device_get(state_s[k]))
        scale = max(float(np.max(np.abs(a))), 1e-30)
        assert float(np.max(np.abs(a - c))) <= 1e-8 * scale, (
            f"sharded cf setup diverged at {k}")
    assert not state_s["clover0"].sharding.is_fully_replicated


def test_mesh_sharded_setup_validates_tiling():
    from qmg_tpu import parallel
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = parallel.make_mesh(8)
    cfg = KCycleConfig(n_refine=1, coarse_dof=4)
    with pytest.raises(ValueError, match="does not tile"):
        # 16x12: Y=12 over my=4 gives 3 local rows (odd) - does not
        # tile; the 4x3 coarse lattice itself is valid (even X).
        make_kcycle_setup_planes(Lattice2D(16, 12, 2), cfg, MASS,
                                 mesh=mesh)


# ---------------------------------------------------------------------------
# The restored eager-vs-traced equivalence oracle.
#
# Why the naive oracle cannot hold: XLA compiles a lax.while_loop Krylov
# body differently standalone (eager dispatch) than fused inside the
# full setup jit, and those last-ulp fusion differences are amplified
# chaotically by tolerance-based stopping in the near-null residual
# solves - two runs produce DIFFERENT (equally valid) near-null spaces.
# Pinning the trajectory with tol=0 + fixed iteration count removes the
# chaos: the two runs are then the same computation to rounding, and
# per-array equivalence holds to fp64 roundoff (and to a measured,
# bounded c64 level). Full analysis: PARITY.md "Setup equivalence
# oracles".
# ---------------------------------------------------------------------------


class _ReplaySeeds:
    """Replays gauss_seed_planes output as an rng for the eager build."""

    def __init__(self, seeds, dtype):
        import collections
        self.q = collections.deque()
        for s in seeds:
            a = np.asarray(jax.device_get(s))
            for k in range(a.shape[0]):
                self.q.append((a[k][..., 0] + 1j * a[k][..., 1]).astype(
                    dtype))

    def gaussian_cv(self, lat):
        v = self.q.popleft()
        assert v.shape == lat.cv_shape()
        return v


def _fixed_iter_cfg():
    # tol=0: the stopping test never fires, so eager and traced runs are
    # path-identical (same fixed op sequence, rounding-level differences
    # only). 24 = 4 BiCGstab(6)-cycles.
    return KCycleConfig(n_refine=2, coarse_dof=4, nullvec_max_iter=24,
                        nullvec_tol=0.0, coarsest_direct=False)


def _eager_vs_traced_states(dtype, plane_dtype, seed_caster):
    cfg = _fixed_iter_cfg()
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = seed_caster(np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)))
    # Draw seeds once, quantized to the test precision, so eager and
    # traced consume bit-identical inputs.
    raw_rng = QMGRandom(999)
    lats = [lat, Lattice2D(L // 4, L // 4, cfg.coarse_dof),
            Lattice2D(L // 16, L // 16, cfg.coarse_dof)]
    seeds = []
    for i in range(cfg.n_refine):
        g = np.stack([seed_caster(raw_rng.gaussian_cv(lats[i]))
                      for _ in range(cfg.coarse_dof // 2)])
        seeds.append(host_to_planes(g, dtype=plane_dtype))

    op = Wilson2D(lat, MASS, jnp.asarray(gauge), dtype=dtype)
    mg = build_kcycle_hierarchy(lat, op, cfg,
                                _ReplaySeeds(seeds, np.dtype(dtype)))
    state_e = mg_state_planes(mg, dtype=plane_dtype)

    setup_fn = make_kcycle_setup_planes(lat, cfg, MASS, dtype=dtype)
    state_t = setup_fn(host_to_planes(gauge, dtype=plane_dtype), *seeds)
    return state_e, state_t


def _rel_diffs(state_e, state_t, plane_dtype):
    assert set(state_e) == set(state_t)
    out = {}
    for k in sorted(state_e):
        a = np.asarray(state_e[k], plane_dtype)
        c = np.asarray(jax.device_get(state_t[k]), plane_dtype)
        assert a.shape == c.shape, k
        scale = max(float(np.max(np.abs(a))), 1e-30)
        out[k] = float(np.max(np.abs(a - c))) / scale
    return out


def _assert_states_close(state_e, state_t, bound, plane_dtype):
    diffs = _rel_diffs(state_e, state_t, plane_dtype)
    for k, rel in diffs.items():
        assert rel < bound, f"{k}: rel diff {rel:.3e} vs bound {bound}"
    return max(diffs.values())


def test_traced_setup_matches_eager_fp64():
    """Fixed-trajectory per-array equivalence at fp64: the traced setup
    IS the eager computation (same seeds, same op sequence) to
    amplified roundoff. Fusion-level rounding grows by the Krylov
    amplification factor (~3e5 per level through 24 pinned BiCGstab(6)
    iterations on a near-singular system; PARITY.md "Setup equivalence
    oracles"): measured worst 1.1e-9 on the level-2 arrays, eps_f64
    (1e-16) x two levels of amplification. Bound 1e-7 - two orders
    above measurement, nine below any structural difference."""
    state_e, state_t = _eager_vs_traced_states(
        jnp.complex128, np.float64, lambda x: np.asarray(x, np.complex128))
    worst = _assert_states_close(state_e, state_t, 1e-7, np.float64)
    print(f"[QMG-TEST] fp64 eager-vs-traced setup: worst rel {worst:.2e}")


def _traced_vs_cf_states(dtype, plane_dtype):
    """Standard traced stage vs the channels-first (cf.py) fine stage at
    matched seeds and pinned trajectory."""
    cfg = _fixed_iter_cfg()
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0))
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999), dtype=plane_dtype)
    gauge_p = host_to_planes(gauge, dtype=plane_dtype)
    state_std = make_kcycle_setup_planes(lat, cfg, MASS, dtype=dtype)(
        gauge_p, *seeds)
    state_cf = make_kcycle_setup_planes(lat, cfg, MASS, dtype=dtype,
                                        channels_first=True)(
        gauge_p, *seeds)
    return state_std, state_cf


def test_channels_first_setup_matches_standard_fp64():
    """The cf fine stage (real-pair arithmetic, phase-form Wilson,
    2048^2 layout fix) is the SAME pinned computation as the standard
    traced stage - fp64 states agree to roundoff (measured worst ~2e-9
    through 24 pinned BiCGstab(6) iterations). At c64 a per-array bound
    cannot hold for ANY arithmetic change: f32 rounding differs at
    every op between the complex and real-pair formulations and the
    near-null Krylov trajectory amplifies eps ~1e7-fold to O(1)
    (PARITY.md "Setup equivalence oracles") - the c64 oracle is the
    functional one (test_channels_first_drives_planes_solver)."""
    state_std, state_cf = _traced_vs_cf_states(jnp.complex128, np.float64)
    worst = _assert_states_close(state_std, state_cf, 1e-8, np.float64)
    print(f"[QMG-TEST] fp64 std-vs-cf setup: worst rel {worst:.2e}")


def test_channels_first_drives_planes_solver():
    """End-to-end: the cf-built state drives the planes solver to the
    same trajectory as the standard-built state."""
    import jax as _jax
    from qmg_tpu.setup import build_kcycle_hierarchy
    from qmg_tpu.tpu_compat import make_planes_solver
    cfg = KCycleConfig(n_refine=2, coarse_dof=4, coarsest_direct=False)
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999))
    gauge_p = host_to_planes(gauge)
    state_std = make_kcycle_setup_planes(lat, cfg, MASS)(gauge_p, *seeds)
    state_cf = make_kcycle_setup_planes(lat, cfg, MASS,
                                        channels_first=True)(
        gauge_p, *seeds)
    op = Wilson2D(lat, MASS, jnp.asarray(gauge), dtype=jnp.complex64)
    mg_struct = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(1),
                                       structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-5, max_iter=200)
    b_p = host_to_planes(np.asarray(rng.gaussian_cv(lat), np.complex64))
    x_s, it_s, _ = _jax.jit(sp)(state_std, b_p)
    x_c, it_c, _ = _jax.jit(sp)(state_cf, b_p)
    assert abs(int(it_s) - int(it_c)) <= 1, (int(it_s), int(it_c))
    b = from_planes(b_p).astype(jnp.complex64)
    resid = float(jnp.sqrt(
        norm2sq(b - op.apply_M(from_planes(x_c).astype(jnp.complex64)))
        / norm2sq(b)))
    assert resid < 1e-4


@pytest.mark.slow
def test_channels_first_depth3_matches_standard_fp64():
    """Depth-3 cf oracle: a 128^2 n_refine=3 hierarchy runs the cf
    COARSE stage twice stacked (level-2 consumes level-1 cf outputs -
    the coarse-to-coarse matrix-stencil path that the 2048^2 n_refine=4
    flow exercises on hardware). Pinned trajectory, fp64, per-array
    equivalence vs the standard traced stages."""
    cfg = KCycleConfig(n_refine=3, coarse_dof=4, nullvec_max_iter=24,
                       nullvec_tol=0.0, coarsest_direct=False)
    lat = Lattice2D(128, 128, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0))
    seeds = gauss_seed_planes(lat, cfg, QMGRandom(999), dtype=np.float64)
    gauge_p = host_to_planes(gauge, dtype=np.float64)
    state_std = make_kcycle_setup_planes(lat, cfg, MASS,
                                         dtype=jnp.complex128)(
        gauge_p, *seeds)
    state_cf = make_kcycle_setup_planes(lat, cfg, MASS,
                                        dtype=jnp.complex128,
                                        channels_first=True)(
        gauge_p, *seeds)
    # Per-level bounds (PARITY.md "Setup equivalence oracles"): cf is a
    # DIFFERENT arithmetic at every op, so its fp64 rounding differences
    # amplify per Krylov stage (~1e3/stage measured at fp64). Levels
    # 0-2 (one amplification stage deep) hold 1e-7; the level-3 outputs
    # have passed through two stages (measured clover3 ~1.1e-3 - their
    # inputs already differ at ~1e-7) and get a matching bound.
    diffs = _rel_diffs(state_std, state_cf, np.float64)
    lvl3 = ("nvb2", "clover3", "hopping3")
    for k, rel in diffs.items():
        bound = 5e-2 if k in lvl3 else 1e-7
        assert rel < bound, f"{k}: rel diff {rel:.3e} vs bound {bound}"
    print("[QMG-TEST] fp64 depth-3 std-vs-cf: level<=2 worst "
          f"{max(v for k, v in diffs.items() if k not in lvl3):.2e}, "
          f"level-3 worst {max(diffs[k] for k in lvl3):.2e}")


def test_traced_setup_matches_eager_c64():
    """The c64 oracle, per-LEVEL (PARITY.md "Setup equivalence
    oracles"). Per-array equivalence at c64 holds exactly one Galerkin
    level deep: level-0 coefficients are analytic in the gauge field
    (exact), level-1 outputs differ by f32 fusion rounding amplified
    ~3e5x through the 24 pinned BiCGstab(6) iterations (measured 1.9e-2
    at 32^2), and level-2 outputs are built from level-1 MATRICES that
    already differ at 1e-2 - their null-vector trajectories diverge
    chaotically and individual entries differ at O(1) (measured
    0.48-0.75). That O(1) divergence is between two equally valid
    near-null bases: the level-2 assertion is therefore functional -
    both states drive the SAME planes solver to the same iteration
    count and residual."""
    state_e, state_t = _eager_vs_traced_states(
        jnp.complex64, np.float32, lambda x: np.asarray(x, np.complex64))
    diffs = _rel_diffs(state_e, state_t, np.float32)
    level1 = ["nvb0", "clover1", "hopping1", "shifts0", "shifts1"]
    for k in ["clover0", "hopping0"]:
        assert diffs[k] < 1e-6, f"{k}: rel diff {diffs[k]:.3e} (analytic)"
    for k in level1:
        assert diffs[k] < 0.2, f"{k}: rel diff {diffs[k]:.3e} vs 0.2"
    print("[QMG-TEST] c64 eager-vs-traced setup: level-1 worst rel "
          f"{max(diffs[k] for k in level1):.2e}; level-2 "
          f"{max(diffs[k] for k in ('nvb1', 'clover2', 'hopping2')):.2e} "
          "(functional oracle below)")

    # Functional level-2 oracle: identical solver, both states, same
    # trajectory length and converged residual.
    cfg = _fixed_iter_cfg()
    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(1337)
    gauge = np.asarray(u1.gauss_gauge_u1(lat, rng, beta=6.0)).astype(
        np.complex64)
    op = Wilson2D(lat, MASS, jnp.asarray(gauge), dtype=jnp.complex64)
    mg_struct = build_kcycle_hierarchy(lat, op, cfg, QMGRandom(1),
                                       structure_only=True)
    sp, _ = make_planes_solver(mg_struct, tol=1e-5, max_iter=200)
    b_p = host_to_planes(np.asarray(rng.gaussian_cv(lat), np.complex64))
    sp_jit = jax.jit(sp)
    x_e, it_e, res_e = sp_jit({k: np.asarray(v, np.float32)
                               for k, v in state_e.items()}, b_p)
    x_t, it_t, res_t = sp_jit(state_t, b_p)
    assert abs(int(it_e) - int(it_t)) <= 1, (int(it_e), int(it_t))
    b = from_planes(b_p).astype(jnp.complex64)
    for x in (x_e, x_t):
        resid = float(jnp.sqrt(
            norm2sq(b - op.apply_M(from_planes(x).astype(jnp.complex64)))
            / norm2sq(b)))
        assert resid < 1e-4
