"""Device-resident (jittable) K-cycle setup.

The eager build (setup.build_kcycle_hierarchy) orchestrates null-vector
solves, transfer orthonormalization and the Galerkin coarse build on the
host backend. That is fine at reference sizes, but at large lattices
the eager setup dwarfs the solve.

Here the ENTIRE setup traces into one jittable function with f32-plane
boundaries: Wilson coefficient build from the gauge field, per-level
null-vector generation (lax.while_loop BiCGstab(l)/GCR on the level's
own operator), chiral doubling, transfer block orthonormalization,
distance-1 Galerkin coarse build, and the dense coarsest inverse -
emitting exactly the state dict that tpu_compat.make_planes_solver
consumes. Host-side randomness (the reference's mt19937 stream,
n13:64) stays on the host: gaussian seeds enter as inputs.

Reference flow being reproduced: tests/n13_wilson_kcycle/
wilson_kcycle.cpp:233-416 (setup phase), with the device/host split
being this framework's redesign.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .lattice import Lattice2D
from .linalg import orthogonal, normalize
from .stencil import StencilType
from .setup import KCycleConfig, AdaptiveConfig, chiral_double
from .stateful import StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG
from .transfer import TransferMG, DoublingType
from .tpu_compat import to_planes, from_planes, host_to_planes
from . import solvers


def _prec_wrap(fn, matmul_precision):
    """Stamp a matmul precision onto every op traced inside ``fn``.

    At default precision f32 matmuls/einsums may run in TF32 (about 3
    decimal digits); the solver path pins "highest" (tpu_compat.py) but
    the setup stages are a separate trace. "highest" is the safe
    default: the K-cycle-smoothing/Krylov recurrences inside the setup
    are exactly the computations the solver pins for, and the adaptive
    pass has produced NaN state at reduced matmul precision.
    """
    if matmul_precision is None:
        return fn

    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(matmul_precision):
            return fn(*args, **kwargs)
    return wrapped


def _level_lattices(lat0: Lattice2D, cfg: KCycleConfig):
    lats = [lat0]
    cur_x, cur_y = lat0.x_len, lat0.y_len
    for _ in range(cfg.n_refine):
        cur_x //= cfg.x_block
        cur_y //= cfg.y_block
        lats.append(Lattice2D(cur_x, cur_y, cfg.coarse_dof))
    return lats


def gauss_seed_planes(lat0: Lattice2D, cfg: KCycleConfig, rng,
                      dtype=np.float32):
    """Host-side gaussian seeds for the null-vector solves, one stacked
    (n_half, cv_shape) array per level, as real planes - drawn in the
    reference's order (per level, per vector). ``dtype`` is the PLANE
    dtype (float32 for the c64 device path, float64 for fp64 oracles)."""
    lats = _level_lattices(lat0, cfg)
    n_half = cfg.coarse_dof // 2
    out = []
    for i in range(1, cfg.n_refine + 1):
        g = np.stack([rng.gaussian_cv(lats[i - 1]) for _ in range(n_half)])
        out.append(host_to_planes(g, dtype=dtype))
    return out


def _setup_mesh_crossover(lats, mesh):
    """First level that no longer tiles the mesh (levels >= it replicate),
    with the SURVEY hard-part-#2 alignment checks: sharded levels must
    keep even local row counts and hold whole aggregation blocks per
    shard so blocking (transfer reshape) stays shard-local."""
    my, mx = mesh.devices.shape

    def tiles(lat):
        return (lat.y_len % my == 0 and lat.xh % mx == 0
                and (lat.y_len // my) % 2 == 0)

    crossover = len(lats)
    for i, lat in enumerate(lats):
        if not tiles(lat):
            crossover = i
            break
    if crossover == 0:
        raise ValueError(
            f"fine lattice ({lats[0].y_len}, {lats[0].xh}) does not tile "
            f"the mesh {mesh.devices.shape} with even local rows")
    for i in range(min(crossover, len(lats) - 1)):
        if i + 1 >= crossover:
            # The coarse side replicates - the blocking reshape crosses
            # shard boundaries and XLA inserts the (tiny) gather, which
            # IS the replication crossover. No alignment needed.
            continue
        f, c = lats[i], lats[i + 1]
        by, bx = f.y_len // c.y_len, f.x_len // c.x_len
        if bx % 2:
            raise ValueError("x blocking must be even under a mesh (an "
                             "odd block splits the eo-packed x axis)")
        y_loc, xh_loc = f.y_len // my, f.xh // mx
        if y_loc % by or xh_loc % max(bx // 2, 1):
            raise ValueError(
                f"level-{i} MG blocking ({by} x {bx}) does not align with "
                f"the shard grid: local extents ({y_loc}, {xh_loc}) must "
                "hold whole blocks")
    return crossover


def _setup_shardings(lats, mesh, crossover):
    """Per-level NamedShardings for the stage-boundary plane arrays."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def ns(spec):
        return NamedSharding(mesh, spec)

    out = []
    for i, lat in enumerate(lats):
        if i < crossover:
            ay, ax = "y", "x"
        else:
            ay = ax = None
        out.append({
            # (2, 2mu, Y, Xh, 2) handled separately (gauge); fields:
            "gauss": ns(P(None, None, ay, ax, None, None)),
            "clover": ns(P(None, ay, ax, None, None, None)),
            "hopping": ns(P(None, None, ay, ax, None, None, None)),
            # blocked null vectors (nvec, 2c, B, Yc, Xhc, 2) live on the
            # COARSE lattice of the transfer INTO level i:
            "nvb": ns(P(None, None, None, ay, ax, None)),
            "gauge": ns(P(None, None, ay, ax, None)),
            "scalar": ns(P()),
        })
    return out


def _direct_coarsest_dinv_traced(mg: StatefulMultigridMG, dtype):
    """Traced analog of StatefulMultigridMG.prepare_direct_coarsest:
    densify the coarsest operator by probing the full basis (lax.map)
    and invert on-device. Dead padding rows/cols (volume-1 parity slot)
    get identity so the inverse is well-defined."""
    cs = mg.coarsest_solve
    st = mg.get_stencil(mg.get_num_levels() - 1)
    matvec = st.get_apply_function(StencilType(cs.coarsest_stencil_app))
    shape = st.lat.cv_shape()
    n = int(np.prod(shape))
    basis = jnp.eye(n, dtype=dtype).reshape((n,) + tuple(shape))
    cols = jax.lax.map(lambda v: matvec(v).reshape(n), basis,
                       batch_size=min(n, 256))
    mat = cols.T
    dead = ((jnp.abs(mat).sum(axis=1) == 0)
            & (jnp.abs(mat).sum(axis=0) == 0))
    mat = mat + jnp.diag(dead.astype(mat.dtype))
    return jnp.linalg.inv(mat)


def make_kcycle_setup_planes(lat0: Lattice2D, cfg: KCycleConfig, mass,
                             w: float = 1.0, dtype=jnp.complex64,
                             per_level_jit: bool = True, mesh=None,
                             channels_first: bool = False,
                             deflate_low: int = 0, deflate_high: int = 0,
                             matmul_precision: str | None = "highest"):
    """Returns ``setup_fn(gauge_planes, *gauss_planes) -> state`` -- the
    n13 setup running on-device, producing the make_planes_solver state
    dict.

    ``gauge_planes``: (2, 2, Y, Xh, 2) f32 planes of the U(1) links.
    ``gauss_planes``: one (n_half, cv_shape..., 2) f32 plane array per
    refinement level (gauss_seed_planes above).

    ``per_level_jit`` (default): setup_fn is a host-side driver calling
    one jitted stage per refinement level (plus one for the coarsest
    inverse); only f32 planes cross stage boundaries, intermediates stay
    on device. This keeps each XLA module small (the monolithic
    whole-setup jit, per_level_jit=False, compiles one very large
    module). With per_level_jit the returned setup_fn must NOT be
    wrapped in jax.jit.

    Pair it with a cheap *structure* hierarchy on the host
    (setup.build_kcycle_hierarchy(..., structure_only=True)) that gives
    make_planes_solver its static shape information; every complex array
    in that structure is replaced by this function's output at solve
    time.

    ``mesh`` (a 2D ("y", "x") jax Mesh) shards the setup itself over the
    device mesh: stage inputs/outputs above the
    replication crossover carry lattice-sharded NamedShardings, so XLA's
    SPMD partitioner runs the null-vector Krylov solves, block
    orthonormalization and Galerkin probes domain-decomposed - the
    collectives (ppermute halos from the stencil rolls, psum reductions
    from the solver dots) are derived by the compiler, the same recipe
    as the mesh solve path (parallel.py). Blocking is validated to stay
    shard-local (SURVEY hard part #2); levels below the crossover
    replicate, mirroring the tiny coarsest lattices. Requires
    ``per_level_jit``.

    ``channels_first`` routes EVERY level's stage through cf.py:
    real-pair arithmetic with (Y, Xh)-minor layouts — a phase-form
    Wilson matvec on the fine level, per-site matrix stencils on the
    coarse levels — which keeps complex buffers, and the layout choices
    a compiler makes for them, out of the setup (cf.py). Same math,
    same seeds, same
    trajectory (fixed-point BiCGstab(l) port). n13-shaped flows only
    (Wilson fine, bicgstab_l on the ORIGINAL op, even x block, no
    rbjacobi precoarsening). Composes with ``mesh``: the cf stages keep
    the STANDARD plane formats at stage boundaries, so the same
    per-level NamedShardings apply and the SPMD partitioner
    domain-decomposes the real-pair arithmetic exactly as it does the
    complex stages (rolls -> ppermute halos, dots -> psum).

    ``deflate_low``/``deflate_high`` add a deflation stage (reference
    deflate_coarsest, stateful_multigrid.h:613-696): the coarsest
    NORMAL operator is densified on-device by basis probing and its
    extreme eigenpairs (lowest/highest by real part) computed on the
    host from the tiny dense matrix; ``cevals``/``cevecs`` join the
    state dict so the planes solver applies the initial-guess
    projection (:895-908). Requires a NORMAL coarsest stencil app.
    """
    if channels_first:
        if not per_level_jit:
            raise ValueError("channels_first requires per_level_jit")
        if cfg.nullvec_solver != "bicgstab_l":
            raise ValueError("channels_first fine stage implements the "
                             "n13 bicgstab_l null-vector solver only")
        if StencilType(cfg.nullvec_stype) != StencilType.ORIGINAL:
            raise ValueError("channels_first fine stage solves on the "
                             "ORIGINAL fine operator only")
        if cfg.precond_coarsen_rbjacobi or cfg.build_extra:
            raise ValueError("channels_first does not support rbjacobi "
                             "precoarsening / build_extra")
        if cfg.x_block % 2:
            raise ValueError("channels_first blocking requires an even "
                             "x block")
    if lat0.nc != 2:
        raise ValueError("make_kcycle_setup_planes builds the Wilson n13 "
                         f"flow; fine nc must be 2, got {lat0.nc}")
    lats = _level_lattices(lat0, cfg)
    if cfg.coarsest_direct:
        from .stencil import StencilType as _ST
        if _ST(cfg.coarsest_stencil_app) == _ST.RIGHT_SCHUR:
            raise ValueError(
                "coarsest_direct with a RIGHT_SCHUR coarsest app is not "
                "supported (the Schur apply acts on the even half; the "
                "dense inverse probes the full space) - use "
                "coarsest_direct=False for the n19 configuration")
        ncoarsest = int(np.prod(lats[-1].cv_shape()))
        if ncoarsest > 4096:
            raise ValueError(
                f"coarsest dimension {ncoarsest} too large for the "
                "device-resident direct inverse (densify probes the "
                "full basis; an 8 GB dense inverse at dim 32768 is "
                "infeasible) - use a deeper hierarchy (larger "
                "n_refine) or coarsest_direct=False")
    if deflate_low or deflate_high:
        if not per_level_jit:
            raise ValueError("the deflation stage requires per_level_jit")
        from .stateful import _NORMAL_TYPES
        if StencilType(cfg.coarsest_stencil_app) not in _NORMAL_TYPES:
            raise ValueError(
                "deflation requires a NORMAL coarsest stencil app "
                "(reference stateful_multigrid.h:625-631) - set "
                "coarsest_stencil_app to MDAGGER_M / M_MDAGGER")
        ndefl = int(np.prod(lats[-1].cv_shape()))
        if ndefl > 4096:
            raise ValueError(
                f"coarsest dimension {ndefl} too large for the densify-"
                "based deflation stage - deepen the hierarchy")
    n_half = cfg.coarse_dof // 2
    from .operators.wilson import Wilson2D
    from .operators.coarse import CoarseOperator2D
    from .stencil import Stencil2D, make_coeffs, DefaultChirality
    from .multigrid import PRECOND_RIGHT_BLOCK_JACOBI, PRECOND_ORIGINAL

    def _solve_null_vectors(fine_st, gauss):
        """Reference n13:338-371 null-vector flow on one level."""
        matvec = fine_st.get_apply_function(StencilType(cfg.nullvec_stype))
        vecs = []
        for k in range(n_half):
            g = gauss[k]
            for v in vecs:
                g = orthogonal(g, v)
            rhs = -matvec(g)
            if cfg.nullvec_solver == "bicgstab_l":
                res = solvers.bicgstab_l(
                    matvec, rhs, max_iter=cfg.nullvec_max_iter,
                    tol=cfg.nullvec_tol)
            elif cfg.nullvec_solver == "gcr_restart":
                res = solvers.gcr_restart(
                    matvec, rhs, max_iter=cfg.nullvec_max_iter,
                    tol=cfg.nullvec_tol, restart_freq=64)
            else:
                raise ValueError(
                    f"unknown null-vector solver {cfg.nullvec_solver}")
            v = g + res.x
            for wv in vecs:
                v = orthogonal(v, wv)
            vecs.append(v)
        return vecs

    def _level_outputs(i, fine_st, gauss):
        """Null vectors + transfer + Galerkin coarse build for level i;
        returns (nvb_planes, coarse_clover_p, coarse_hopping_p,
        coarse_shifts_p)."""
        vecs = _solve_null_vectors(fine_st, gauss)
        raw = chiral_double(fine_st, jnp.stack(vecs))
        transfer = TransferMG(lats[i - 1], lats[i], raw,
                              do_block_ortho=True,
                              doubling=DoublingType.PROJECTION)
        coarse = CoarseOperator2D(
            lats[i], fine_st, transfer, is_chiral=True,
            use_rbjacobi=cfg.precond_coarsen_rbjacobi,
            build_extra=cfg.build_extra)
        cc = coarse.coeffs
        return (to_planes(transfer._nvb.astype(dtype)),
                to_planes(cc.clover.astype(dtype)),
                to_planes(cc.hopping.astype(dtype)),
                to_planes(jnp.stack([jnp.asarray(cc.shift, dtype),
                                     jnp.asarray(cc.eo_shift, dtype),
                                     jnp.asarray(cc.dof_shift, dtype)])))

    def _reconstruct_stencil(lvl, clover_p, hopping_p, shifts_p):
        """checkpoint.py's __new__ reconstruction: a CoarseOperator2D
        from its coefficient planes (chirality metadata is static)."""
        sh = from_planes(shifts_p)
        st = CoarseOperator2D.__new__(CoarseOperator2D)
        Stencil2D.__init__(st, make_coeffs(
            lats[lvl], clover=from_planes(clover_p).astype(dtype),
            hopping=from_planes(hopping_p).astype(dtype),
            shift=sh[0], eo_shift=sh[1], dof_shift=sh[2], dtype=dtype))
        st.is_chiral = True
        st.use_rbjacobi = cfg.precond_coarsen_rbjacobi
        st.in_transfer = None
        st._default_chirality = DefaultChirality.GAMMA_5
        st._sigma_1_L = None
        st._sigma_1_R = None
        return st

    if per_level_jit:
        def _level1_fn(gauge_planes, gauss_p):
            gauge = from_planes(gauge_planes).astype(dtype)
            op = Wilson2D(lat0, mass, gauge, wilson_coeff=w, dtype=dtype)
            gs = from_planes(gauss_p).astype(dtype)
            outs = _level_outputs(1, op, gs)
            return (to_planes(op.coeffs.clover.astype(dtype)),
                    to_planes(op.coeffs.hopping.astype(dtype))) + outs

        def _level1_fn_cf(gauge_planes, gauss_p):
            """The fine stage in channels-first real-pair arithmetic
            (cf.py) - no complex buffer ever materializes on the fine
            lattice; outputs convert to the standard planes-state
            formats (coarse-level sizes) at the stage boundary."""
            from . import cf as _cf
            rdt = jnp.float64 if dtype == jnp.complex128 else jnp.float32
            cdt = dtype
            gauge_cf = jnp.moveaxis(gauge_planes, -1, 0).astype(rdt)
            phases = _cf.wilson_phases_cf(gauge_cf)
            gauss_cf = jnp.transpose(gauss_p, (0, 5, 1, 4, 2, 3)
                                     ).astype(rdt)
            fmass = float(np.real(mass))
            ncc = lats[1].nc
            eye = jnp.eye(ncc, dtype=rdt)
            clover_init = jnp.zeros(
                (2, 2, ncc, ncc, lats[1].y_len, lats[1].xh), dtype=rdt
            ).at[0].set(2.0 * w * eye[None, :, :, None, None])
            nvb_cf, clover_c, hopping_c = _cf.level_outputs_cf(
                lambda v: _cf.wilson_apply_cf(phases, v, fmass, w),
                lambda x, d: _cf.wilson_hop_dir_cf(phases, x, d, w),
                gauss_cf, lats[0], lats[1], cfg.nullvec_max_iter,
                cfg.nullvec_tol, clover_init=clover_init)
            # Fine clover planes: 2w I (wilson.py:41).
            c0 = jnp.zeros(lat0.cm_shape() + (2,), rdt)
            c0 = c0.at[..., 0, 0, 0].set(2.0 * w)
            c0 = c0.at[..., 1, 1, 0].set(2.0 * w)
            # Fine hopping planes from the phases and spin constants
            # (wilson.wilson_spin_matrices in host numpy).
            _i = 1j
            spin = 0.5 * np.stack([
                np.array([[-w, 1], [1, -w]]),
                np.array([[-w, -_i], [_i, -w]]),
                np.array([[-w, -1], [-1, -w]]),
                np.array([[-w, _i], [-_i, -w]])])
            s_re = jnp.asarray(spin.real, rdt)[:, None, None, None]
            s_im = jnp.asarray(spin.imag, rdt)[:, None, None, None]
            ur = phases[0][..., None, None]
            ui = phases[1][..., None, None]
            h0 = jnp.stack([ur * s_re - ui * s_im,
                            ur * s_im + ui * s_re], axis=-1)
            shifts1 = to_planes(jnp.stack([
                jnp.asarray(mass, cdt), jnp.zeros((), cdt),
                jnp.zeros((), cdt)]))
            return (c0, h0,
                    jnp.transpose(nvb_cf, (1, 2, 3, 4, 5, 0)),
                    jnp.transpose(clover_c, (1, 4, 5, 2, 3, 0)),
                    jnp.transpose(hopping_c, (1, 2, 5, 6, 3, 4, 0)),
                    shifts1)

        def _mk_level_fn_cf(i):
            """Coarse-level setup stage in cf arithmetic: at 2048^2 the
            LEVEL-2 stage (512^2, nc=8) hits the same complex-buffer
            layout pathology as the fine stage (measured: 16x padding,
            23.6 GB for a 2.2 GB program), so every sizeable level runs
            channels-first."""
            def _level_fn(clover_p, hopping_p, shifts_p, gauss_p):
                from . import cf as _cf
                rdt = (jnp.float64 if dtype == jnp.complex128
                       else jnp.float32)
                ccf = _cf.mat_planes_to_cf(clover_p).astype(rdt)
                hcf = _cf.hop_planes_to_cf(hopping_p).astype(rdt)
                sh = jnp.transpose(shifts_p, (1, 0)).astype(rdt)
                gauss_cf = jnp.transpose(gauss_p, (0, 5, 1, 4, 2, 3)
                                         ).astype(rdt)
                nvb_cf, clover_c, hopping_c = _cf.level_outputs_cf(
                    lambda v: _cf.stencil_apply_cf(ccf, hcf, sh, v),
                    lambda x, d: _cf.site_matvec_cf(
                        hcf[:, d], _cf.cshift_cf(x, d)),
                    gauss_cf, lats[i - 1], lats[i],
                    cfg.nullvec_max_iter, cfg.nullvec_tol,
                    clover_apply=lambda x: _cf.site_matvec_cf(ccf, x))
                # Coarse shifts: the scalar shift transfers, eo/dof
                # reset (make_coeffs defaults in build_coarse_coeffs).
                shifts_out = jnp.stack(
                    [shifts_p[0], jnp.zeros_like(shifts_p[0]),
                     jnp.zeros_like(shifts_p[0])])
                return (jnp.transpose(nvb_cf, (1, 2, 3, 4, 5, 0)),
                        jnp.transpose(clover_c, (1, 4, 5, 2, 3, 0)),
                        jnp.transpose(hopping_c, (1, 2, 5, 6, 3, 4, 0)),
                        shifts_out)
            return _level_fn

        def _mk_level_fn(i):
            def _level_fn(clover_p, hopping_p, shifts_p, gauss_p):
                fine_st = _reconstruct_stencil(i - 1, clover_p, hopping_p,
                                               shifts_p)
                gs = from_planes(gauss_p).astype(dtype)
                return _level_outputs(i, fine_st, gs)
            return _level_fn

        def _cdinv_fn(clover_p, hopping_p, shifts_p):
            st = _reconstruct_stencil(cfg.n_refine, clover_p, hopping_p,
                                      shifts_p)
            cs_app = StencilType(cfg.coarsest_stencil_app)
            matvec = st.get_apply_function(cs_app)
            shape = lats[-1].cv_shape()
            n = int(np.prod(shape))
            basis = jnp.eye(n, dtype=dtype).reshape((n,) + tuple(shape))
            cols = jax.lax.map(lambda v: matvec(v).reshape(n), basis,
                               batch_size=min(n, 256))
            mat = cols.T
            dead = ((jnp.abs(mat).sum(axis=1) == 0)
                    & (jnp.abs(mat).sum(axis=0) == 0))
            mat = mat + jnp.diag(dead.astype(mat.dtype))
            return to_planes(jnp.linalg.inv(mat))

        def _densify_coarsest_fn(clover_p, hopping_p, shifts_p):
            """Deflation stage, device half: densify the coarsest NORMAL
            operator by probing (the heavy O(n) matvecs run on-device);
            the tiny dense eig runs on the host (LAPACK on a <= 4096^2
            matrix), mirroring StatefulMultigridMG.deflate_coarsest
            (reference stateful_multigrid.h:613-696)."""
            st = _reconstruct_stencil(cfg.n_refine, clover_p, hopping_p,
                                      shifts_p)
            matvec = st.get_apply_function(
                StencilType(cfg.coarsest_stencil_app))
            shape = lats[-1].cv_shape()
            n = int(np.prod(shape))
            basis = jnp.eye(n, dtype=dtype).reshape((n,) + tuple(shape))
            cols = jax.lax.map(lambda v: matvec(v).reshape(n), basis,
                               batch_size=min(n, 256))
            return to_planes(cols.T)

        if channels_first:
            _level1_fn = _level1_fn_cf
            _mk_level_fn = _mk_level_fn_cf

        _level1_fn = _prec_wrap(_level1_fn, matmul_precision)
        _cdinv_fn = _prec_wrap(_cdinv_fn, matmul_precision)
        _densify_coarsest_fn = _prec_wrap(_densify_coarsest_fn,
                                          matmul_precision)
        _mk_level_fn_raw = _mk_level_fn
        _mk_level_fn = lambda i: _prec_wrap(_mk_level_fn_raw(i),
                                            matmul_precision)
        if mesh is None:
            level1_jit = jax.jit(_level1_fn)
            level_jits = [jax.jit(_mk_level_fn(i))
                          for i in range(2, cfg.n_refine + 1)]
            cdinv_jit = jax.jit(_cdinv_fn)
            densify_jit = jax.jit(_densify_coarsest_fn)
        else:
            crossover = _setup_mesh_crossover(lats, mesh)
            sh = _setup_shardings(lats, mesh, crossover)
            level1_jit = jax.jit(
                _level1_fn,
                in_shardings=(sh[0]["gauge"], sh[0]["gauss"]),
                out_shardings=(sh[0]["clover"], sh[0]["hopping"],
                               sh[1]["nvb"], sh[1]["clover"],
                               sh[1]["hopping"], sh[1]["scalar"]))
            level_jits = [
                jax.jit(_mk_level_fn(i),
                        in_shardings=(sh[i - 1]["clover"],
                                      sh[i - 1]["hopping"],
                                      sh[i - 1]["scalar"],
                                      sh[i - 1]["gauss"]),
                        out_shardings=(sh[i]["nvb"], sh[i]["clover"],
                                       sh[i]["hopping"], sh[i]["scalar"]))
                for i in range(2, cfg.n_refine + 1)]
            n = cfg.n_refine
            cdinv_jit = jax.jit(
                _cdinv_fn,
                in_shardings=(sh[n]["clover"], sh[n]["hopping"],
                              sh[n]["scalar"]),
                out_shardings=sh[n]["scalar"])
            densify_jit = jax.jit(
                _densify_coarsest_fn,
                in_shardings=(sh[n]["clover"], sh[n]["hopping"],
                              sh[n]["scalar"]),
                out_shardings=sh[n]["scalar"])

        # On a multi-device CPU mesh (the virtual-device test rig), a
        # stage's collectives run on 8 in-process participant threads
        # that must all reach each rendezvous within XLA's hard 40 s
        # watchdog (rendezvous.cc aborts the process past it). Letting
        # the NEXT stage's XLA compile overlap an in-flight stage
        # starves those threads on an undersized host (observed: fatal
        # collective-permute rendezvous timeout at 4096^2 on 1 core).
        # Stage boundaries are data-dependent anyway, so syncing there
        # costs nothing; real-chip meshes keep async dispatch.
        _cpu_mesh = (mesh is not None and
                     next(iter(mesh.devices.flat)).platform == "cpu")
        _sync = jax.block_until_ready if _cpu_mesh else (lambda x: x)

        def setup_fn(gauge_planes, *gauss_planes):
            if len(gauss_planes) != cfg.n_refine:
                raise ValueError(f"need {cfg.n_refine} gauss seed arrays, "
                                 f"got {len(gauss_planes)}")
            state = {}
            state["shifts0"] = host_to_planes(np.asarray(
                [complex(mass), 0j, 0j], np.complex64))
            (state["clover0"], state["hopping0"], state["nvb0"],
             state["clover1"], state["hopping1"],
             state["shifts1"]) = _sync(
                level1_jit(gauge_planes, gauss_planes[0]))
            for i in range(2, cfg.n_refine + 1):
                (state[f"nvb{i - 1}"], state[f"clover{i}"],
                 state[f"hopping{i}"], state[f"shifts{i}"]) = _sync(
                    level_jits[i - 2](
                        state[f"clover{i - 1}"], state[f"hopping{i - 1}"],
                        state[f"shifts{i - 1}"], gauss_planes[i - 1]))
            if cfg.coarsest_direct:
                n = cfg.n_refine
                state["cdinv"] = _sync(cdinv_jit(
                    state[f"clover{n}"], state[f"hopping{n}"],
                    state[f"shifts{n}"]))
            if deflate_low or deflate_high:
                # Deflation stage, host half: tiny dense eig of the
                # device-densified coarsest normal op, selection by real
                # part (deflate_coarsest semantics), planes back out -
                # cevals/cevecs ride the state through make_planes_solver
                # and checkpoint.save_hierarchy.
                n = cfg.n_refine
                mat_p = np.asarray(jax.device_get(densify_jit(
                    state[f"clover{n}"], state[f"hopping{n}"],
                    state[f"shifts{n}"])))
                mat = (mat_p[..., 0] + 1j * mat_p[..., 1]).astype(
                    np.complex128)
                evals, evecs = np.linalg.eig(mat)
                idx = np.argsort(evals.real)
                sel = list(idx[:deflate_low]) + (
                    list(idx[len(idx) - deflate_high:])
                    if deflate_high else [])
                shape = lats[-1].cv_shape()
                vecs = evecs[:, sel].T.reshape((-1,) + tuple(shape))
                nrms = np.sqrt(np.sum(np.abs(vecs) ** 2,
                                      axis=tuple(range(1, vecs.ndim)),
                                      keepdims=True))
                rdt = (np.float64 if dtype == jnp.complex128
                       else np.float32)
                state["cevals"] = host_to_planes(
                    evals[sel].astype(np.complex128), dtype=rdt)
                state["cevecs"] = host_to_planes(
                    (vecs / nrms).astype(np.complex128), dtype=rdt)
            return state

        return setup_fn

    if mesh is not None:
        raise ValueError("mesh-sharded setup requires per_level_jit=True "
                         "(the monolithic jit is a debugging path)")

    def setup_fn(gauge_planes, *gauss_planes):
        if len(gauss_planes) != cfg.n_refine:
            raise ValueError(f"need {cfg.n_refine} gauss seed arrays, "
                             f"got {len(gauss_planes)}")
        gauge = from_planes(gauge_planes).astype(dtype)
        op = Wilson2D(lat0, mass, gauge, wilson_coeff=w, dtype=dtype)
        coarsest = CoarsestSolveMG(
            coarsest_stencil_app=cfg.coarsest_stencil_app,
            coarsest_tol=cfg.coarsest_tol,
            coarsest_iters=cfg.coarsest_max_iter,
            coarsest_restart_freq=cfg.coarsest_restart_freq)
        mg = StatefulMultigridMG(lat0, op, coarsest)

        for i in range(1, cfg.n_refine + 1):
            st = mg.get_stencil(i - 1)
            matvec = st.get_apply_function(StencilType(cfg.nullvec_stype))
            gs = from_planes(gauss_planes[i - 1]).astype(dtype)
            vecs = []
            for k in range(n_half):
                g = gs[k]
                for v in vecs:
                    g = orthogonal(g, v)
                rhs = -matvec(g)
                if cfg.nullvec_solver == "bicgstab_l":
                    res = solvers.bicgstab_l(
                        matvec, rhs, max_iter=cfg.nullvec_max_iter,
                        tol=cfg.nullvec_tol)
                elif cfg.nullvec_solver == "gcr_restart":
                    res = solvers.gcr_restart(
                        matvec, rhs, max_iter=cfg.nullvec_max_iter,
                        tol=cfg.nullvec_tol, restart_freq=64)
                else:
                    raise ValueError(
                        f"unknown null-vector solver {cfg.nullvec_solver}")
                v = g + res.x
                for wv in vecs:
                    v = orthogonal(v, wv)
                vecs.append(v)
            raw = chiral_double(st, jnp.stack(vecs))
            transfer = TransferMG(lats[i - 1], lats[i], raw,
                                  do_block_ortho=True,
                                  doubling=DoublingType.PROJECTION)
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
            mg.push_level(
                lats[i], transfer, level_solve, build_stencil=True,
                is_chiral=True,
                build_stencil_from=(PRECOND_RIGHT_BLOCK_JACOBI
                                    if cfg.precond_coarsen_rbjacobi
                                    else PRECOND_ORIGINAL),
                build_extra=cfg.build_extra, nvecs=raw)

        state = {}
        for lvl in range(mg.get_num_levels()):
            c = mg.get_stencil(lvl).coeffs
            if c.clover is not None:
                state[f"clover{lvl}"] = to_planes(c.clover.astype(dtype))
            if c.hopping is not None:
                state[f"hopping{lvl}"] = to_planes(c.hopping.astype(dtype))
            state[f"shifts{lvl}"] = to_planes(jnp.stack(
                [jnp.asarray(c.shift, dtype),
                 jnp.asarray(c.eo_shift, dtype),
                 jnp.asarray(c.dof_shift, dtype)]))
        for lvl in range(mg.get_num_levels() - 1):
            state[f"nvb{lvl}"] = to_planes(
                mg.get_transfer(lvl)._nvb.astype(dtype))
        if cfg.coarsest_direct:
            state["cdinv"] = to_planes(
                _direct_coarsest_dinv_traced(mg, dtype))
        return state

    # Monolithic (whole-setup) trace: the caller jits setup_fn; stamp
    # the precision on the trace itself.
    return _prec_wrap(setup_fn, matmul_precision)


# ---------------------------------------------------------------------------
# Device-resident ADAPTIVE (n22 / alpha-MG) setup.
#
# Reference flow being reproduced: tests/n22_wilson_kcycle_adaptive/
# wilson_kcycle.cpp:260-333 (initial Richardson levels, build_coarse_by_
# restrict :628-706) and :336-426 (adaptive m-loop: K-cycle-smooth the
# test vectors with the CURRENT hierarchy, update the level, rebuild all
# coarser levels). The eager path (setup.build_adaptive_hierarchy /
# adaptive_pass) runs this on host; here every stage jits onto the
# device with f32-plane boundaries, the same split as the n13 flow
# above - only the reference's mt19937 gaussian draws stay on host
# (adaptive_seed_planes).
# ---------------------------------------------------------------------------


def _adaptive_lattices(lat0: Lattice2D, acfg: AdaptiveConfig):
    lats = [lat0]
    cur_x, cur_y = lat0.x_len, lat0.y_len
    for _ in range(acfg.n_refine):
        cur_x //= acfg.x_block
        cur_y //= acfg.y_block
        lats.append(Lattice2D(cur_x, cur_y, acfg.coarse_dof))
    return lats


def adaptive_seed_planes(lat0: Lattice2D, acfg: AdaptiveConfig, rng,
                         dtype=np.float32):
    """Host gaussian seeds for the adaptive setup, drawn in the exact
    order the eager path consumes them (initial levels fine-to-coarse,
    then per pass / per level the coarser-level rebuilds): returns
    (init_seeds, pass_seeds) with init_seeds[i] a (n_half, cv(lats[i]))
    plane array and pass_seeds[m][i] the list of rebuild seed arrays for
    levels i+1..n_refine-1 of pass m."""
    lats = _adaptive_lattices(lat0, acfg)
    n_half = acfg.coarse_dof // 2

    def draw(lat):
        return host_to_planes(
            np.stack([rng.gaussian_cv(lat) for _ in range(n_half)]),
            dtype=dtype)

    init = [draw(lats[i]) for i in range(acfg.n_refine)]
    passes = []
    for _ in range(acfg.n_setup):
        per_level = []
        for i in range(acfg.n_refine):
            per_level.append([draw(lats[jj])
                              for jj in range(i + 1, acfg.n_refine)])
        passes.append(per_level)
    return init, passes


def make_adaptive_setup_planes(lat0: Lattice2D, acfg: AdaptiveConfig,
                               mass, w: float = 1.0,
                               dtype=jnp.complex64,
                               coarsest_direct: bool = False,
                               matmul_precision: str | None = "highest"):
    """Returns ``setup_fn(gauge_planes, init_seeds, pass_seeds) ->
    state`` - the n22 adaptive setup running on-device as per-stage
    jits, producing the make_planes_solver state dict.

    Three compiled stage families, each called by the host driver with
    only f32 planes crossing the boundary:
      * ``init_fn(i)``: Richardson-smoothed test vectors on level i's
        own operator -> orthonormalize -> chiral double -> block-ortho
        transfer -> Galerkin coarse build of level i+1 (reference
        build_coarse_by_restrict, n22:628-706). Reused verbatim for the
        post-pass coarser-level rebuilds (:403-410) - the same
        computation, update-in-place at the state-dict level.
      * ``pass_fn(i)``: reconstructs the CURRENT full hierarchy from the
        state planes inside the trace, K-cycle-smooths each test vector
        with it (FGCR + mg_preconditioner at level i, :361-376),
        re-orthonormalizes, chiral-doubles, rebuilds transfer + level
        i+1 (:396-400).
      * optional dense-coarsest inverse (direct coarsest).

    The adaptive smoothing iteration counts are fixed (Richardson 10,
    K-cycle 10 at tol 1e-10 - the reference's own constants), so the
    flow is naturally fixed-trip-count and jits without dynamic shapes.
    """
    if lat0.nc != 2:
        raise ValueError("make_adaptive_setup_planes builds the Wilson "
                         f"n22 flow; fine nc must be 2, got {lat0.nc}")
    lats = _adaptive_lattices(lat0, acfg)
    n_half = acfg.coarse_dof // 2
    n_refine = acfg.n_refine
    from .operators.wilson import Wilson2D
    from .operators.coarse import CoarseOperator2D
    from .stencil import Stencil2D, make_coeffs, DefaultChirality

    coarsest_cfg = CoarsestSolveMG(
        coarsest_tol=acfg.coarsest_tol,
        coarsest_iters=acfg.coarsest_max_iter,
        coarsest_restart_freq=acfg.coarsest_restart_freq)
    setup_ls = LevelSolveMG(
        intermediate_tol=acfg.setup_inner_tol,
        intermediate_iters=acfg.setup_inner_iters,
        intermediate_restart_freq=acfg.setup_inner_restart,
        pre_tol=acfg.pre_smooth_tol, pre_iters=acfg.n_pre_smooth,
        post_tol=acfg.post_smooth_tol, post_iters=acfg.n_post_smooth)

    def _fine_stencil(gauge_planes):
        gauge = from_planes(gauge_planes).astype(dtype)
        return Wilson2D(lat0, mass, gauge, wilson_coeff=w, dtype=dtype)

    def _coarse_stencil(lvl, clover_p, hopping_p, shifts_p):
        sh = from_planes(shifts_p)
        st = CoarseOperator2D.__new__(CoarseOperator2D)
        Stencil2D.__init__(st, make_coeffs(
            lats[lvl], clover=from_planes(clover_p).astype(dtype),
            hopping=from_planes(hopping_p).astype(dtype),
            shift=sh[0], eo_shift=sh[1], dof_shift=sh[2], dtype=dtype))
        st.is_chiral = True
        st.use_rbjacobi = False
        st.in_transfer = None
        st._default_chirality = DefaultChirality.GAMMA_5
        st._sigma_1_L = None
        st._sigma_1_R = None
        return st

    def _transfer_from_nvb(lvl, nvb_p):
        t = TransferMG.__new__(TransferMG)
        t.fine_lat = lats[lvl]
        t.coarse_lat = lats[lvl + 1]
        t.doubling = DoublingType.PROJECTION
        t._init_geometry()
        t._nvb = from_planes(nvb_p).astype(dtype)
        t._restrict_nvb = None
        t.block_cholesky = t.block_L = t.block_U = None
        return t

    def _richardson_vectors(st, gauss):
        """build_coarse_by_restrict's test-vector smoothing
        (n22:664-676): gaussian -> Richardson(10, omega 0.33) ->
        orthogonalize -> normalize."""
        matvec = st.get_apply_function()
        tvs = []
        for k in range(n_half):
            res = solvers.richardson(
                matvec, gauss[k], max_iter=acfg.richardson_iters,
                tol=1e-10, omega=acfg.richardson_omega,
                blocksize=acfg.richardson_blocksize)
            v = res.x
            for wv in tvs:
                v = orthogonal(v, wv)
            tvs.append(normalize(v))
        return tvs

    def _build_level(i, fine_st, tvs):
        """chiral double + transfer + Galerkin build of level i+1 from
        level-i test vectors; returns the state-planes tuple."""
        raw = chiral_double(fine_st, jnp.stack(tvs))
        transfer = TransferMG(lats[i], lats[i + 1], raw,
                              do_block_ortho=True,
                              doubling=DoublingType.PROJECTION)
        coarse = CoarseOperator2D(lats[i + 1], fine_st, transfer,
                                  is_chiral=True)
        cc = coarse.coeffs
        return (to_planes(jnp.stack(tvs)),
                to_planes(transfer._nvb.astype(dtype)),
                to_planes(cc.clover.astype(dtype)),
                to_planes(cc.hopping.astype(dtype)),
                to_planes(jnp.stack([jnp.asarray(cc.shift, dtype),
                                     jnp.asarray(cc.eo_shift, dtype),
                                     jnp.asarray(cc.dof_shift, dtype)])))

    def _mk_init_fn(i):
        # Stable per-stage signatures (no whole-state dict): level 0
        # builds its stencil from the gauge field, deeper levels from
        # their own coefficient planes.
        if i == 0:
            def init_fn(gauge_planes, gauss_p):
                st = _fine_stencil(gauge_planes)
                gauss = from_planes(gauss_p).astype(dtype)
                return _build_level(0, st, _richardson_vectors(st, gauss))
        else:
            def init_fn(clover_p, hopping_p, shifts_p, gauss_p):
                st = _coarse_stencil(i, clover_p, hopping_p, shifts_p)
                gauss = from_planes(gauss_p).astype(dtype)
                return _build_level(i, st, _richardson_vectors(st, gauss))
        return init_fn

    def _call_init(i, state, gauge_planes, gauss_p):
        if i == 0:
            return init_jits[0](gauge_planes, gauss_p)
        return init_jits[i](state[f"clover{i}"], state[f"hopping{i}"],
                            state[f"shifts{i}"], gauss_p)

    def _mk_pass_fn(i):
        def pass_fn(state_planes, gauge_planes):
            # Reconstruct the CURRENT hierarchy for the K-cycle smoother.
            st0 = _fine_stencil(gauge_planes)
            mg = StatefulMultigridMG(lat0, st0, coarsest_cfg)
            transfers = []
            for lvl in range(n_refine):
                t = _transfer_from_nvb(lvl, state_planes[f"nvb{lvl}"])
                transfers.append(t)
                mg.push_level(lats[lvl + 1], t, setup_ls,
                              build_stencil=False, is_chiral=True)
                stc = _coarse_stencil(lvl + 1,
                                      state_planes[f"clover{lvl + 1}"],
                                      state_planes[f"hopping{lvl + 1}"],
                                      state_planes[f"shifts{lvl + 1}"])
                stc.in_transfer = t
                mg.stencil_list[lvl + 1] = stc
                mg.is_stencil_managed[lvl + 1] = True

            st_i = mg.get_stencil(i)
            matvec = st_i.get_apply_function()
            precond = mg.make_preconditioner(i)
            from .stateful import _zero_carry
            tv_in = from_planes(state_planes[f"tv{max(i - 1, 0)}"]
                                if i > 0 else state_planes["tv0"]
                                ).astype(dtype)
            new_tvs = []
            for j in range(n_half):
                if i == 0:
                    rhs = tv_in[j]
                else:
                    rhs = transfers[i - 1].restrict_f2c(tv_in[j])
                res, _ = solvers.gcr_var_precond(
                    matvec, rhs, precond,
                    max_iter=acfg.kcycle_smooth_iters,
                    tol=acfg.kcycle_smooth_tol,
                    precond_carry=_zero_carry(mg.get_num_levels()))
                v = res.x
                for wv in new_tvs:
                    v = orthogonal(v, wv)
                new_tvs.append(normalize(v))
            return _build_level(i, st_i, new_tvs)
        return pass_fn

    def _cdinv_fn(clover_p, hopping_p, shifts_p):
        st = _coarse_stencil(n_refine, clover_p, hopping_p, shifts_p)
        matvec = st.get_apply_function()
        shape = lats[-1].cv_shape()
        n = int(np.prod(shape))
        basis = jnp.eye(n, dtype=dtype).reshape((n,) + tuple(shape))
        cols = jax.lax.map(lambda v: matvec(v).reshape(n), basis,
                           batch_size=min(n, 256))
        mat = cols.T
        dead = ((jnp.abs(mat).sum(axis=1) == 0)
                & (jnp.abs(mat).sum(axis=0) == 0))
        mat = mat + jnp.diag(dead.astype(mat.dtype))
        return to_planes(jnp.linalg.inv(mat))

    init_jits = [jax.jit(_prec_wrap(_mk_init_fn(i), matmul_precision))
                 for i in range(n_refine)]
    pass_jits = [jax.jit(_prec_wrap(_mk_pass_fn(i), matmul_precision))
                 for i in range(n_refine)]
    cdinv_jit = jax.jit(_prec_wrap(_cdinv_fn, matmul_precision))

    def _apply_build(state, i, outs, label=""):
        (state[f"tv{i}"], state[f"nvb{i}"], state[f"clover{i + 1}"],
         state[f"hopping{i + 1}"], state[f"shifts{i + 1}"]) = outs
        if label and os.environ.get("QMG_ADAPTIVE_DEBUG"):
            # Failure localization (costs one device round trip per
            # stage): name the first stage whose outputs go non-finite.
            names = (f"tv{i}", f"nvb{i}", f"clover{i + 1}",
                     f"hopping{i + 1}", f"shifts{i + 1}")
            bad = [n for n, o in zip(names, outs)
                   if not bool(jnp.all(jnp.isfinite(o)))]
            print(f"[qmg_tpu adaptive] {label}: "
                  + (f"NONFINITE {bad}" if bad else "finite"), flush=True)

    def setup_fn(gauge_planes, init_seeds, pass_seeds):
        if len(init_seeds) != n_refine:
            raise ValueError(f"need {n_refine} init seed arrays, got "
                             f"{len(init_seeds)}")
        if len(pass_seeds) != acfg.n_setup:
            raise ValueError(f"need {acfg.n_setup} pass seed groups, got "
                             f"{len(pass_seeds)}")
        state = {"shifts0": host_to_planes(np.asarray(
            [complex(mass), 0j, 0j], np.complex64))}
        # Fine-level coefficients ride the state for the solver scaffold.
        fine = jax.jit(lambda gp: (
            to_planes(_fine_stencil(gp).coeffs.clover.astype(dtype)),
            to_planes(_fine_stencil(gp).coeffs.hopping.astype(dtype))))
        state["clover0"], state["hopping0"] = fine(gauge_planes)
        # Initial levels, fine to coarse (n22:260-333).
        for i in range(n_refine):
            _apply_build(state, i,
                         _call_init(i, state, gauge_planes, init_seeds[i]),
                         label=f"init L{i}")
        # Adaptive passes (n22:336-426).
        for m in range(acfg.n_setup):
            for i in range(n_refine):
                _apply_build(state, i, pass_jits[i](state, gauge_planes),
                             label=f"pass {m} L{i}")
                for idx, jj in enumerate(range(i + 1, n_refine)):
                    _apply_build(
                        state, jj,
                        _call_init(jj, state, gauge_planes,
                                   pass_seeds[m][i][idx]),
                        label=f"pass {m} rebuild L{jj}")
        if coarsest_direct:
            state["cdinv"] = cdinv_jit(state[f"clover{n_refine}"],
                                       state[f"hopping{n_refine}"],
                                       state[f"shifts{n_refine}"])
        for i in range(n_refine):
            del state[f"tv{i}"]  # setup-internal; not solver state
        return state

    return setup_fn
