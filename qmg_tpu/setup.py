"""MG setup: null-vector generation and hierarchy construction.

The reference's setup phase lives in its test mains (the de-facto user
API); this module packages the same flows:

  * ``generate_null_vectors``: gaussian -> orthogonalize -> residual-
    equation solve with BiCGstab(l) -> re-orthogonalize
    (reference tests/n13_wilson_kcycle/wilson_kcycle.cpp:338-371).
  * ``chiral_double``: split each vector into +-chirality halves and
    normalize (reference :375-384).
  * ``build_kcycle_hierarchy``: the full n13 ladder - per refinement
    level, generate vectors on the current coarsest stencil, double,
    build a TransferMG, and push a built Galerkin level with solve config.
"""

from __future__ import annotations

import dataclasses
import jax.numpy as jnp

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .transfer import TransferMG, DoublingType
from .stateful import (StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG,
                       DSLASH_NULLVEC)
from . import solvers
from .linalg import normalize, orthogonal


def generate_null_vectors(stencil: Stencil2D, n_vec: int, rng,
                          max_iter: int = 500, tol: float = 5e-5,
                          l: int = 6,
                          stype: StencilType = StencilType.ORIGINAL,
                          solver: str = "bicgstab_l"):
    """Algebraic near-null vectors via the residual equation.

    For each vector: gaussian guess g, orthogonalize against previous,
    solve M e = -M g with BiCGstab(l) (or restarted GCR, the n19 variant,
    reference n19:237), return v = g + e (so M v ~ 0), re-orthogonalize
    (reference n13:338-371). Returns (vectors (n_vec, cv_shape),
    total_ops) - ops feed the NULLVEC tracker.
    """
    lat = stencil.lat
    matvec = stencil.get_apply_function(stype)
    vecs = []
    total_ops = 0
    for _ in range(n_vec):
        g = jnp.asarray(rng.gaussian_cv(lat))
        for v in vecs:
            g = orthogonal(g, v)
        rhs = -matvec(g)
        total_ops += 1
        if solver == "bicgstab_l":
            res = solvers.bicgstab_l(matvec, rhs, max_iter=max_iter,
                                     tol=tol, l=l)
        elif solver == "gcr_restart":
            res = solvers.gcr_restart(matvec, rhs, max_iter=max_iter,
                                      tol=tol, restart_freq=64)
        else:
            raise ValueError(f"unknown null-vector solver {solver}")
        total_ops += int(res.ops_count)
        v = g + res.x
        for w in vecs:
            v = orthogonal(v, w)
        vecs.append(v)
    return jnp.stack(vecs), total_ops


def chiral_double(stencil: Stencil2D, vectors):
    """Chiral doubling: n vectors -> 2n, ups first then downs, normalized
    (reference n13:375-384)."""
    ups, downs = [], []
    for i in range(vectors.shape[0]):
        up, down = stencil.chiral_projection_both(vectors[i])
        ups.append(normalize(up))
        downs.append(normalize(down))
    return jnp.stack(ups + downs)


@dataclasses.dataclass
class KCycleConfig:
    """The n13 parameter block (reference n13:86-122)."""
    x_block: int = 4
    y_block: int = 4
    coarse_dof: int = 8          # after doubling
    n_refine: int = 2
    # outer solve
    tol: float = 1e-10
    max_iter: int = 1000
    restart_freq: int = 32
    # intermediate (K-cycle Krylov)
    inner_tol: float = 0.2
    inner_max_iter: int = 1000
    inner_restart_freq: int = 32
    # smoothers
    n_pre_smooth: int = 2
    pre_smooth_tol: float = 1e-15
    n_post_smooth: int = 2
    post_smooth_tol: float = 1e-15
    # coarsest
    coarsest_tol: float = 0.2
    coarsest_max_iter: int = 1000
    coarsest_restart_freq: int = 32
    # null vector generation
    nullvec_max_iter: int = 500
    nullvec_tol: float = 5e-5
    nullvec_solver: str = "bicgstab_l"
    nullvec_stype: StencilType = StencilType.ORIGINAL
    fine_stencil_app: StencilType = StencilType.ORIGINAL
    coarsest_stencil_app: StencilType = StencilType.ORIGINAL
    # What to coarsen / pre-build on each coarse level (the n19 Schur path
    # coarsens the rbjacobi stencil and pre-builds its rbjacobi form).
    precond_coarsen_rbjacobi: bool = False
    build_extra: int = 0
    free_null_vectors: bool = False  # geometric per-spin constants (do_free)
    # Extension: invert the (tiny) coarsest operator at setup and solve
    # it with one dense matvec per K-cycle visit (stateful.py).
    coarsest_direct: bool = False
    # Fixed-schedule mode: if > 0, every intermediate K-cycle
    # Krylov runs EXACTLY this many GCR iterations instead of stopping
    # at inner_tol (flexible GCR tolerates any inner variation). With a
    # direct coarsest this removes every data-dependent inner stopping
    # test, so a vmap-ed multi-RHS solve batches with no per-lane
    # masking (tpu_compat.make_batched_planes_solver).
    inner_fixed_iters: int = 0


@dataclasses.dataclass
class AdaptiveConfig:
    """The n22 adaptive (alpha-MG) setup parameter block
    (reference tests/n22_wilson_kcycle_adaptive/wilson_kcycle.cpp:46-122,
    :250-257, :289, :373-374, :441-448)."""
    n_refine: int = 2
    coarse_dof: int = 8          # after doubling
    x_block: int = 4
    y_block: int = 4
    n_setup: int = 1             # adaptive passes (reference m loop :336)
    # Setup-phase intermediate solve params (reference :250-253).
    setup_inner_tol: float = 1e-10
    setup_inner_iters: int = 8
    setup_inner_restart: int = 1024
    # Smoothers (shared between setup and solve phase).
    n_pre_smooth: int = 2
    pre_smooth_tol: float = 1e-15
    n_post_smooth: int = 2
    post_smooth_tol: float = 1e-15
    # Richardson initial test-vector smoothing (reference :289, :664).
    richardson_iters: int = 10
    richardson_omega: float = 0.33
    richardson_blocksize: int = 250
    # K-cycle smoothing of test vectors per adaptive pass (:373-374).
    kcycle_smooth_iters: int = 10
    kcycle_smooth_tol: float = 1e-10
    # Solve-phase params restored by finalize_adaptive (reference :441-448).
    inner_tol: float = 0.2
    inner_max_iter: int = 1000
    inner_restart_freq: int = 32
    coarsest_tol: float = 0.2
    coarsest_max_iter: int = 1000
    coarsest_restart_freq: int = 32


def _setup_level_solve(acfg: AdaptiveConfig) -> LevelSolveMG:
    return LevelSolveMG(
        intermediate_tol=acfg.setup_inner_tol,
        intermediate_iters=acfg.setup_inner_iters,
        intermediate_restart_freq=acfg.setup_inner_restart,
        pre_tol=acfg.pre_smooth_tol, pre_iters=acfg.n_pre_smooth,
        post_tol=acfg.post_smooth_tol, post_iters=acfg.n_post_smooth)


def build_coarse_by_restrict(mg: StatefulMultigridMG, test_vectors,
                             fine_level: int, coarse_lat: Lattice2D,
                             level_solve: LevelSolveMG, fresh_build: bool,
                             rng, acfg: AdaptiveConfig) -> TransferMG:
    """Build (or rebuild) the level below ``fine_level`` from
    Richardson-smoothed gaussian test vectors generated on ``fine_level``'s
    own operator (reference n22 build_coarse_by_restrict,
    tests/n22_wilson_kcycle_adaptive/wilson_kcycle.cpp:628-706: gaussian ->
    minv_vector_richardson(10, 1e-10, omega=0.33, blocksize=250) ->
    orthogonalize -> normalize -> chiral double -> new TransferMG ->
    push_level / update_level).

    Divergence from the reference (documented in PARITY.md): the new
    transfer carries DoublingType.PROJECTION. The reference omits the
    doubling argument (n22:680), defaulting to NONE, which makes the NEXT
    level's chiral_projection_both a no-op (coarse.h:624-650) and would
    produce zero down-vectors (singular blocks) at n_refine >= 3; with
    PROJECTION the chirality convention propagates and deep hierarchies
    work. For n_refine <= 2 the trajectories are identical (doubling only
    sets the coarse op's default-chirality metadata).
    """
    st = mg.get_stencil(fine_level)
    lat_f = mg.get_lattice(fine_level)
    matvec = st.get_apply_function()
    n_half = coarse_lat.nc // 2
    tvs = []
    for _ in range(n_half):
        g = jnp.asarray(rng.gaussian_cv(lat_f))
        res = solvers.richardson(matvec, g, max_iter=acfg.richardson_iters,
                                 tol=1e-10, omega=acfg.richardson_omega,
                                 blocksize=acfg.richardson_blocksize)
        mg.add_tracker_count(DSLASH_NULLVEC, int(res.ops_count), fine_level)
        v = res.x
        for w in tvs:
            v = orthogonal(v, w)
        tvs.append(normalize(v))
    test_vectors[fine_level] = tvs
    raw = chiral_double(st, jnp.stack(tvs))
    transfer = TransferMG(lat_f, coarse_lat, raw, do_block_ortho=True,
                          doubling=DoublingType.PROJECTION)
    if fresh_build:
        mg.push_level(coarse_lat, transfer, level_solve, build_stencil=True,
                      is_chiral=True, nvecs=raw)
    else:
        mg.update_level(fine_level + 1, coarse_lat, transfer, level_solve,
                        build_stencil=True, is_chiral=True, nvecs=raw)
    return transfer


def build_adaptive_hierarchy(lat0: Lattice2D, fine_op: Stencil2D,
                             acfg: AdaptiveConfig, rng):
    """The n22 initial setup (reference :260-333): every level gets
    Richardson-smoothed gaussian test vectors generated on its own
    operator. Returns (mg, test_vectors) - feed both to adaptive_pass."""
    coarsest = CoarsestSolveMG(
        coarsest_tol=acfg.coarsest_tol,
        coarsest_iters=acfg.coarsest_max_iter,
        coarsest_restart_freq=acfg.coarsest_restart_freq)
    mg = StatefulMultigridMG(lat0, fine_op, coarsest)
    test_vectors = {}
    cur_x, cur_y = lat0.x_len, lat0.y_len
    for i in range(acfg.n_refine):
        cur_x //= acfg.x_block
        cur_y //= acfg.y_block
        lat_i = Lattice2D(cur_x, cur_y, acfg.coarse_dof)
        build_coarse_by_restrict(mg, test_vectors, i, lat_i,
                                 _setup_level_solve(acfg), True, rng, acfg)
    return mg, test_vectors


def adaptive_pass(mg: StatefulMultigridMG, test_vectors,
                  acfg: AdaptiveConfig, rng):
    """One adaptive setup pass (reference n22 m-loop, :336-426).

    Per level i (fine to coarse): smooth each test vector with the
    CURRENT K-cycle at that level (10-iteration FGCR preconditioned by
    mg_preconditioner; the level-i rhs for i > 0 is the restriction of
    the finer level's test vector, :361-370), re-orthonormalize,
    chiral-double, rebuild the transfer, update_level - then rebuild all
    coarser levels via build_coarse_by_restrict (:403-410).
    """
    from .stateful import _zero_carry
    n_refine = mg.get_num_levels() - 1
    for i in range(n_refine):
        st = mg.get_stencil(i)
        lat_f = mg.get_lattice(i)
        lat_c = mg.get_lattice(i + 1)
        matvec = st.get_apply_function()
        precond = mg.make_preconditioner(i)
        n_half = lat_c.nc // 2
        new_tvs = []
        for j in range(n_half):
            if i == 0:
                rhs = test_vectors[0][j]
            else:
                rhs = mg.get_transfer(i - 1).restrict_f2c(
                    test_vectors[i - 1][j])
            res, _ = solvers.gcr_var_precond(
                matvec, rhs, precond,
                max_iter=acfg.kcycle_smooth_iters,
                tol=acfg.kcycle_smooth_tol,
                precond_carry=_zero_carry(mg.get_num_levels()))
            mg.add_tracker_count(DSLASH_NULLVEC, int(res.ops_count) + 1, i)
            v = res.x
            for w in new_tvs:
                v = orthogonal(v, w)
            new_tvs.append(normalize(v))
        test_vectors[i] = new_tvs
        raw = chiral_double(st, jnp.stack(new_tvs))
        transfer = TransferMG(lat_f, lat_c, raw, do_block_ortho=True,
                              doubling=DoublingType.PROJECTION)
        mg.update_level(i + 1, lat_c, transfer, mg.get_level_solve(i),
                        build_stencil=True, is_chiral=True, nvecs=raw)
        for jj in range(i + 1, n_refine):
            build_coarse_by_restrict(mg, test_vectors, jj,
                                     mg.get_lattice(jj + 1),
                                     mg.get_level_solve(jj), False, rng,
                                     acfg)


def finalize_adaptive(mg: StatefulMultigridMG, acfg: AdaptiveConfig):
    """End of setup: fold all setup work into the NULLVEC counters
    (reference :428-432) and restore the solve-phase intermediate
    parameters (:436-448)."""
    for i in range(mg.get_num_levels()):
        mg.shift_all_to_nullvec(i)
    for i in range(mg.get_num_levels() - 1):
        ls = mg.get_level_solve(i)
        mg.level_solve_list[i] = dataclasses.replace(
            ls, intermediate_tol=acfg.inner_tol,
            intermediate_iters=acfg.inner_max_iter,
            intermediate_restart_freq=acfg.inner_restart_freq)


def build_kcycle_hierarchy(lat0: Lattice2D, fine_op: Stencil2D,
                           cfg: KCycleConfig, rng,
                           is_chiral: bool = True,
                           structure_only: bool = False
                           ) -> StatefulMultigridMG:
    """Construct the full n13 hierarchy (reference n13:233-416).

    ``structure_only`` skips the null-vector solves and uses
    orthogonalized gaussians directly - the hierarchy has the right
    SHAPES but preconditions poorly. Use it as the static scaffold for
    tpu_compat.make_planes_solver when the real state comes from the
    device-resident setup (setup_planes.make_kcycle_setup_planes),
    which replaces every complex array at solve time.
    """
    coarsest = CoarsestSolveMG(
        coarsest_stencil_app=cfg.coarsest_stencil_app,
        coarsest_tol=cfg.coarsest_tol,
        coarsest_iters=cfg.coarsest_max_iter,
        coarsest_restart_freq=cfg.coarsest_restart_freq)
    mg = StatefulMultigridMG(lat0, fine_op, coarsest)

    cur_x, cur_y = lat0.x_len, lat0.y_len
    lat_prev = lat0
    for i in range(1, cfg.n_refine + 1):
        cur_x //= cfg.x_block
        cur_y //= cfg.y_block
        lat_i = Lattice2D(cur_x, cur_y, cfg.coarse_dof)
        stencil = mg.get_stencil(i - 1)

        if cfg.free_null_vectors:
            # Exact geometric null vectors: constant per spin component
            # (reference n13:264-277, do_free path; the reference pairs
            # do_free with coarse_dof=2 = n_spin, n13:91-94).
            nc = lat_prev.nc
            if cfg.coarse_dof > nc:
                raise ValueError(
                    f"free_null_vectors gives only {nc} independent "
                    f"per-spin constants at level {i - 1}; coarse_dof="
                    f"{cfg.coarse_dof} would duplicate vectors and make "
                    "the block Gram matrix singular (reference do_free "
                    "uses coarse_dof = n_spin, n13:91-94)")
            nv = jnp.zeros((cfg.coarse_dof,) + lat_prev.cv_shape(),
                           dtype=jnp.complex128)
            for c in range(cfg.coarse_dof):
                nv = nv.at[c, ..., c % nc].set(1.0)
            raw = nv
        elif structure_only:
            # Shape-only scaffold (checkpoint.py's __new__ reconstruction
            # pattern): zero blocked null vectors, identity coarse
            # clover, zero coarse hopping - no solves, no block ortho,
            # no Galerkin probing. Every complex array is replaced at
            # solve time by the device-resident setup's state
            # (setup_planes.make_kcycle_setup_planes).
            from .operators.coarse import CoarseOperator2D
            from .stencil import (Stencil2D as _Stencil2D, make_coeffs,
                                  DefaultChirality)
            from . import linalg as _linalg
            t = TransferMG.__new__(TransferMG)
            t.fine_lat = lat_prev
            t.coarse_lat = lat_i
            t.doubling = DoublingType.PROJECTION
            t._init_geometry()
            t._nvb = t._to_blocked_batch(jnp.zeros(
                (cfg.coarse_dof,) + lat_prev.cv_shape(),
                dtype=jnp.complex64))
            t._restrict_nvb = None
            t.block_cholesky = t.block_L = t.block_U = None

            st = CoarseOperator2D.__new__(CoarseOperator2D)
            clover = _linalg.identity_like(
                jnp.zeros(lat_i.cm_shape(), jnp.complex64))
            hopping = jnp.zeros((4,) + lat_i.cm_shape(), jnp.complex64)
            _Stencil2D.__init__(st, make_coeffs(
                lat_i, clover=clover, hopping=hopping, shift=0.0,
                dtype=jnp.complex64))
            st.is_chiral = is_chiral
            st.use_rbjacobi = cfg.precond_coarsen_rbjacobi
            st.in_transfer = t
            st._default_chirality = DefaultChirality.GAMMA_5
            st._sigma_1_L = None
            st._sigma_1_R = None

            level_solve = LevelSolveMG(
                fine_stencil_app=cfg.fine_stencil_app,
                intermediate_tol=cfg.inner_tol,
                intermediate_iters=(cfg.inner_fixed_iters
                                    if cfg.inner_fixed_iters > 0
                                    else cfg.inner_max_iter),
                intermediate_restart_freq=cfg.inner_restart_freq,
                pre_tol=cfg.pre_smooth_tol, pre_iters=cfg.n_pre_smooth,
                post_tol=cfg.post_smooth_tol,
                post_iters=cfg.n_post_smooth,
                fixed_trips=cfg.inner_fixed_iters > 0)
            mg.push_level(lat_i, t, level_solve, build_stencil=False,
                          is_chiral=is_chiral)
            mg.stencil_list[i] = st
            mg.is_stencil_managed[i] = True
            lat_prev = lat_i
            continue
        else:
            vecs, ops = generate_null_vectors(
                stencil, cfg.coarse_dof // 2, rng,
                max_iter=cfg.nullvec_max_iter, tol=cfg.nullvec_tol,
                stype=cfg.nullvec_stype, solver=cfg.nullvec_solver)
            mg.add_tracker_count(DSLASH_NULLVEC, ops, i - 1)
            raw = chiral_double(stencil, vecs)

        transfer = TransferMG(lat_prev, lat_i, raw, do_block_ortho=True,
                              doubling=DoublingType.PROJECTION)
        level_solve = LevelSolveMG(
            fine_stencil_app=cfg.fine_stencil_app,
            intermediate_tol=cfg.inner_tol,
            intermediate_iters=(cfg.inner_fixed_iters
                                if cfg.inner_fixed_iters > 0
                                else cfg.inner_max_iter),
            intermediate_restart_freq=cfg.inner_restart_freq,
            pre_tol=cfg.pre_smooth_tol, pre_iters=cfg.n_pre_smooth,
            post_tol=cfg.post_smooth_tol, post_iters=cfg.n_post_smooth,
            fixed_trips=cfg.inner_fixed_iters > 0)
        from .multigrid import PRECOND_RIGHT_BLOCK_JACOBI, PRECOND_ORIGINAL
        mg.push_level(
            lat_i, transfer, level_solve, build_stencil=True,
            is_chiral=is_chiral,
            build_stencil_from=(PRECOND_RIGHT_BLOCK_JACOBI
                                if cfg.precond_coarsen_rbjacobi
                                else PRECOND_ORIGINAL),
            build_extra=cfg.build_extra, nvecs=raw)
        lat_prev = lat_i
    if cfg.coarsest_direct:
        mg.prepare_direct_coarsest()
    return mg
