"""Stateful multigrid: per-level solve configs, Dslash trackers, coarsest
deflation, and the recursive K-cycle preconditioner.

JAX counterpart of reference multigrid/stateful_multigrid.h:43-1060.

The reference's static ``mg_preconditioner`` (:734-1060) becomes a
function *factory*: the level recursion is static (n_refine <= ~4), so
``make_preconditioner(level)`` returns a pure traced function - nested
flexible-GCR while_loops compile into one XLA computation, with the
dynamic inner tolerances (coarse_tol * rnorm/rnorm_prep, reference :916)
as traced scalars.

Per-level Dslash counters (DslashTrackerMG, reference :119-200) thread
through the jitted solve as an integer carry: counts (n_levels, 4) by
{NULLVEC, KRYLOV, PRESMOOTH, POSTSMOOTH} plus Krylov iteration counts
(n_levels,); the host-side tracker accumulates returned carries.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .multigrid import MultigridMG
from . import solvers
from .linalg import norm2sq, vdot

# Reference QMGDslashType (stateful_multigrid.h:31-37).
DSLASH_NULLVEC = 0
DSLASH_KRYLOV = 1
DSLASH_PRESMOOTH = 2
DSLASH_POSTSMOOTH = 3

_NORMAL_TYPES = (StencilType.M_MDAGGER, StencilType.MDAGGER_M,
                 StencilType.RBJ_M_MDAGGER, StencilType.RBJ_MDAGGER_M)


@dataclasses.dataclass
class LevelSolveMG:
    """Solve config for a non-coarsest level
    (reference LevelSolveMG, stateful_multigrid.h:62-114)."""
    fine_stencil_app: StencilType = StencilType.ORIGINAL
    intermediate_tol: float = 1e-20
    intermediate_iters: int = 1000
    intermediate_restart_freq: int = 32
    pre_tol: float = 1e-20
    pre_iters: int = 2
    pre_cgne: bool = False
    post_tol: float = 1e-20
    post_iters: int = 2
    post_cgne: bool = False
    # Fixed-schedule mode: the intermediate K-cycle Krylov runs EXACTLY
    # intermediate_iters trips (tolerance reported, not tested). The
    # loop predicate then depends only on the trip counter, so a
    # vmap-ed (multi-RHS) solve batches with no per-lane masking
    # selects - see solvers._gcr_impl(fixed_trips=...).
    fixed_trips: bool = False

    def __post_init__(self):
        ok = (StencilType.ORIGINAL, StencilType.RIGHT_JACOBI,
              StencilType.RIGHT_SCHUR)
        if StencilType(self.fine_stencil_app) not in ok:
            raise ValueError(
                "LevelSolveMG.fine_stencil_app must be original, right "
                "jacobi, or schur (reference stateful_multigrid.h:403-408)")


@dataclasses.dataclass
class CoarsestSolveMG:
    """Coarsest-level solve config
    (reference CoarsestSolveMG, stateful_multigrid.h:204-241)."""
    coarsest_stencil_app: StencilType = StencilType.ORIGINAL
    coarsest_tol: float = 1e-20
    coarsest_iters: int = 1000
    coarsest_restart_freq: int = 32
    deflate: bool = True
    normal_shift: float = 0.0
    # Extension (no reference counterpart): solve the coarsest level
    # with a precomputed dense inverse - one dense matvec instead of
    # hundreds of latency-bound tiny stencil applies per K-cycle visit.
    # Enable via prepare_direct_coarsest().
    direct: bool = False


class DslashTrackerMG:
    """Per-level operator-application counters
    (reference DslashTrackerMG, stateful_multigrid.h:119-200)."""

    def __init__(self):
        self.tracker = {DSLASH_NULLVEC: 0, DSLASH_KRYLOV: 0,
                        DSLASH_PRESMOOTH: 0, DSLASH_POSTSMOOTH: 0}
        self.iterations = 0

    def add_tracker_count(self, dtype: int, accum: int):
        self.tracker[dtype] += int(accum)

    def add_iterations_count(self, accum: int):
        self.iterations += int(accum)

    def shift_all_to_nullvec(self):
        for t in (DSLASH_KRYLOV, DSLASH_PRESMOOTH, DSLASH_POSTSMOOTH):
            self.tracker[DSLASH_NULLVEC] += self.tracker[t]
            self.tracker[t] = 0
        self.iterations = 0

    def get_tracker_count(self, dtype: int) -> int:
        return self.tracker[dtype]

    def get_total_count(self) -> int:
        return sum(self.tracker.values())

    def get_iterations_count(self) -> int:
        return self.iterations

    def reset_tracker(self):
        self.__init__()


def _zero_carry(n_levels: int):
    return {"counts": jnp.zeros((n_levels, 4), dtype=jnp.int32),
            "iters": jnp.zeros((n_levels,), dtype=jnp.int32)}


class StatefulMultigridMG(MultigridMG):
    """MultigridMG + solve state (reference StatefulMultigridMG)."""

    def __init__(self, lat: Lattice2D, stencil: Stencil2D,
                 coarsest_solve: CoarsestSolveMG):
        super().__init__(lat, stencil)
        self.coarsest_solve = coarsest_solve
        self.level_solve_list = []
        self.dslash_tracker_list = [DslashTrackerMG()]
        self.coarsest_evals = None
        self.coarsest_evecs = None
        self.coarsest_dinv = None
        self._aux_version = 0
        self._solve_cache = {}

    # --- level management (reference :374-497) ---
    def push_level(self, new_lat, new_transfer, level_solve=None, **kw):
        super().push_level(new_lat, new_transfer, **kw)
        self.level_solve_list.append(level_solve)
        self.dslash_tracker_list.append(DslashTrackerMG())
        self.coarsest_dinv = None  # coarsest level changed
        self._aux_version += 1

    def pop_level(self):
        super().pop_level()
        self.level_solve_list.pop()
        self.dslash_tracker_list.pop()
        self.coarsest_dinv = None
        self._aux_version += 1

    def update_level(self, level, new_lat, new_transfer, level_solve=None,
                     **kw):
        super().update_level(level, new_lat, new_transfer, **kw)
        self.level_solve_list[level - 1] = level_solve
        # Trackers are preserved (reference :490-491).
        if level == self.get_num_levels() - 1:
            self.coarsest_dinv = None
        self._aux_version += 1

    def get_level_solve(self, i: int) -> LevelSolveMG:
        ls = self.level_solve_list[i]
        if ls is None:
            raise ValueError(f"level solve for level {i} does not exist")
        return ls

    def get_coarsest_solve(self) -> CoarsestSolveMG:
        return self.coarsest_solve

    # --- trackers (reference :500-609) ---
    def add_tracker_count(self, dtype, accum, i):
        self.dslash_tracker_list[i].add_tracker_count(dtype, accum)

    def add_iterations_count(self, accum, i):
        self.dslash_tracker_list[i].add_iterations_count(accum)

    def shift_all_to_nullvec(self, i):
        self.dslash_tracker_list[i].shift_all_to_nullvec()

    def get_tracker_count(self, dtype, i):
        return self.dslash_tracker_list[i].get_tracker_count(dtype)

    def get_total_count(self, i):
        return self.dslash_tracker_list[i].get_total_count()

    def get_iterations_count(self, i):
        return self.dslash_tracker_list[i].get_iterations_count()

    def query_average_iterations(self):
        """Coarse-iters per fine-iter ratios (reference :582-591)."""
        n = self.get_num_levels()
        avg = [float(self.dslash_tracker_list[0].get_iterations_count())]
        for i in range(1, n):
            num = self.dslash_tracker_list[i].get_iterations_count()
            den = self.dslash_tracker_list[i - 1].get_iterations_count()
            avg.append(num / den if den else 0.0)
        return avg

    def reset_tracker(self, i: int = -1):
        targets = (range(self.get_num_levels()) if i == -1 else [i])
        for j in targets:
            self.dslash_tracker_list[j].reset_tracker()

    def absorb_carry(self, carry):
        """Fold a jitted solve's counter carry into the host trackers."""
        counts = np.asarray(carry["counts"])
        iters = np.asarray(carry["iters"])
        for lvl in range(self.get_num_levels()):
            for t in range(4):
                self.dslash_tracker_list[lvl].add_tracker_count(
                    t, int(counts[lvl, t]))
            self.dslash_tracker_list[lvl].add_iterations_count(
                int(iters[lvl]))

    # --- coarsest deflation (reference deflate_coarsest, :613-696) ---
    def deflate_coarsest(self, num_low: int, num_high: int,
                         print_evals: bool = False):
        cs = self.coarsest_solve
        if StencilType(cs.coarsest_stencil_app) not in _NORMAL_TYPES:
            raise ValueError("cannot deflate coarsest operator unless it's "
                             "a normal op solve (reference :625-631)")
        if num_low + num_high == 0:
            return
        from . import eig
        st = self.get_stencil(self.get_num_levels() - 1)
        matvec = st.get_apply_function(cs.coarsest_stencil_app)
        shape = st.lat.cv_shape()
        evals, evecs = eig.dense_eigensystem(matvec, shape)
        idx = np.argsort(np.real(evals))
        sel = list(idx[:num_low]) + list(idx[len(idx) - num_high:])
        vals = jnp.asarray(evals[sel])
        vecs = jnp.asarray(evecs[sel])
        # Normalize (reference :682-685).
        nrms = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2,
                                axis=tuple(range(1, vecs.ndim)),
                                keepdims=True))
        self.coarsest_evals = vals
        self.coarsest_evecs = vecs / nrms
        self._aux_version += 1
        if print_evals:
            for i, v in enumerate(np.asarray(vals)):
                print(f"[QMG-COARSEST-EVALS]: {i} {v.real}")

    # --- direct coarsest solve (no reference counterpart) ---
    def prepare_direct_coarsest(self):
        """Materialize and invert the coarsest operator (for the configured
        coarsest_stencil_app), enabling a one-matmul coarsest solve.

        The coarsest level of a shipped hierarchy is tiny (e.g. 4^2 x nc8
        = 128-dim); its iterative solve is hundreds of latency-bound ops
        per K-cycle visit on an accelerator. A dense 128^2 inverse apply
        is a single dense matvec - exact, so it also improves K-cycle
        quality over the reference's tol-0.2 CGNR."""
        from . import eig
        cs = self.coarsest_solve
        st = self.get_stencil(self.get_num_levels() - 1)
        stype = StencilType(cs.coarsest_stencil_app)
        matvec = st.get_apply_function(stype)
        # RIGHT_SCHUR solves on the even half-space; densify on the
        # solve-space shape (the K-cycle's direct branch applies dinv to
        # prepare_M's output, which already has that shape).
        shape = st.solve_size_shape(stype)
        import jax
        dd = (jnp.complex128 if jax.config.jax_enable_x64
              else jnp.complex64)
        mat = np.array(eig.densify(matvec, shape, dtype=dd),
                       np.complex128)
        if not np.isfinite(mat).all():
            raise ValueError(
                "coarsest operator contains non-finite entries - the "
                "hierarchy setup produced a degenerate coarse level "
                "(e.g. rank-deficient null vectors)")
        # Volume-1 coarse lattices carry a parity-1 padding slot whose
        # rows/cols are identically zero; give padding an identity block
        # so the inverse is well-defined (padding rhs is always zero).
        dead = (np.abs(mat).sum(axis=1) == 0) & (np.abs(mat).sum(axis=0)
                                                 == 0)
        if dead.any():
            mat[dead, dead] = 1.0
        try:
            dinv = np.linalg.inv(mat)
        except np.linalg.LinAlgError:
            dinv = np.linalg.pinv(mat)
        self.coarsest_dinv = jnp.asarray(dinv, dd)
        cs.direct = True
        self._aux_version += 1

    # ------------------------------------------------------------------
    # The K-cycle preconditioner (reference mg_preconditioner, :734-1060).
    # ------------------------------------------------------------------

    def _apply_level(self, level: int, stype: StencilType):
        st = self.get_stencil(level)
        return lambda x: st.apply_M(x, stype)

    def prebuild_derived_stencils(self, outer_type=StencilType.ORIGINAL):
        """Force every derived coefficient set the configured solve will
        touch (dagger / rbjacobi / fused Schur, per level) to build NOW.

        Call this at the top of a jit trace whose stencil coefficients
        are traced values (tpu_compat planes solvers): the lazy builds
        would otherwise first trigger inside a Krylov while_loop body
        trace and be RECOMPUTED EVERY ITERATION (see
        Stencil2D.prebuild_derived). No-op when already built.
        """
        n_levels = self.get_num_levels()
        self.get_stencil(0).prebuild_derived(outer_type)
        for lvl in range(n_levels - 1):
            ls = self.get_level_solve(lvl)
            st = self.get_stencil(lvl)
            ft = StencilType(ls.fine_stencil_app)
            st.prebuild_derived(ft)
            if ls.pre_cgne or ls.post_cgne:
                # CGNE smoother branch (reference :845-866).
                if ft == StencilType.ORIGINAL:
                    st.prebuild_derived(StencilType.M_MDAGGER)
                elif ft == StencilType.RIGHT_JACOBI:
                    st.prebuild_derived(StencilType.RBJ_M_MDAGGER)
        cs = self.coarsest_solve
        self.get_stencil(n_levels - 1).prebuild_derived(
            StencilType(cs.coarsest_stencil_app))

    def make_preconditioner(self, level: int = 0, verbose=False):
        """Returns precond(rhs, carry) -> (lhs, carry), a pure traced
        function implementing one K-cycle at ``level``.

        ``verbose`` takes a bool (back-compat: True = DETAIL prints at
        every level, the pre-round-5 behavior) or a solvers.VerboseMG.
        The inner-solve struct follows the reference's composition
        (stateful_multigrid.h:761-776): the coarse solve prints at the
        caller's precond_verbosity (at least SUMMARY when the caller is
        verbose at all), deeper levels print SUMMARY, all with the
        two-spaces-per-level '[QMG-MG-SOLVE-INFO]: Level N ' prefix,
        via jax.debug.print so it works inside jit."""
        n_levels = self.get_num_levels()
        if n_levels == 1:
            return lambda rhs, carry: (rhs, carry)

        fine_stencil = self.get_stencil(level)
        coarse_stencil = self.get_stencil(level + 1)
        transfer = self.get_transfer(level)
        level_solve = self.get_level_solve(level)

        fine_type = StencilType(level_solve.fine_stencil_app)
        fine_schur = fine_type == StencilType.RIGHT_SCHUR
        apply_fine = self._apply_level(level, fine_type)

        # Coarse solve parameters (reference :810-827).
        if level < n_levels - 2:
            nxt = self.get_level_solve(level + 1)
            coarse_type = StencilType(nxt.fine_stencil_app)
            coarse_max_iter = nxt.intermediate_iters
            coarse_tol = nxt.intermediate_tol
            coarse_restart = nxt.intermediate_restart_freq
            coarse_fixed = nxt.fixed_trips
        else:
            cs = self.coarsest_solve
            coarse_type = StencilType(cs.coarsest_stencil_app)
            coarse_max_iter = cs.coarsest_iters
            coarse_tol = cs.coarsest_tol
            coarse_restart = cs.coarsest_restart_freq
            coarse_fixed = False
        apply_coarse = self._apply_level(level + 1, coarse_type)
        coarsest_normal = coarse_type in _NORMAL_TYPES
        # Inner-solve verbosity struct (reference verb2 construction,
        # stateful_multigrid.h:761-776).
        from .solvers import VerboseMG, Verbosity, _as_verbose
        v = _as_verbose(verbose)
        prefix = ("  " * (level + 1)
                  + f"[QMG-MG-SOLVE-INFO]: Level {level + 1} ")
        if (v.verbosity == Verbosity.NONE
                and v.precond_verbosity == Verbosity.NONE):
            vprefix = None
        else:
            lvl_v = max(v.precond_verbosity, Verbosity.SUMMARY)
            vprefix = VerboseMG(lvl_v,
                                lvl_v if lvl_v >= Verbosity.DETAIL
                                else Verbosity.SUMMARY, prefix)

        def smoother(rhs, n_iters, s_tol, use_cgne, dslash_type, carry):
            """Pre/post smoother: MinRes(relax 0.85), or MinRes on M M^dag
            followed by M^dag (CGNE variant) (reference :845-866)."""
            if n_iters <= 0:
                return jnp.zeros_like(rhs), carry
            if use_cgne and fine_type in (StencilType.ORIGINAL,
                                          StencilType.RIGHT_JACOBI):
                mmd = (StencilType.M_MDAGGER
                       if fine_type == StencilType.ORIGINAL
                       else StencilType.RBJ_M_MDAGGER)
                dag = (StencilType.DAGGER
                       if fine_type == StencilType.ORIGINAL
                       else StencilType.RBJ_DAGGER)
                res = solvers.minres(self._apply_level(level, mmd), rhs,
                                     max_iter=n_iters, tol=s_tol,
                                     omega=0.85)
                z = fine_stencil.apply_M(res.x, dag)
                ops = 2 * res.ops_count + 1
            else:
                res = solvers.minres(apply_fine, rhs, max_iter=n_iters,
                                     tol=s_tol, omega=0.85)
                z = res.x
                ops = res.ops_count
            carry = dict(carry)
            carry["counts"] = carry["counts"].at[level, dslash_type].add(ops)
            return z, carry

        def precond(rhs, carry):
            # --- presmooth (reference :840-873) ---
            if level_solve.pre_iters > 0:
                z1, carry = smoother(rhs, level_solve.pre_iters,
                                     level_solve.pre_tol,
                                     level_solve.pre_cgne, DSLASH_PRESMOOTH,
                                     carry)
                r1 = rhs - apply_fine(z1)
                carry = dict(carry)
                carry["counts"] = carry["counts"].at[
                    level, DSLASH_PRESMOOTH].add(1)
            else:
                z1 = rhs
                r1 = rhs

            # --- restrict + prepare (reference :875-884) ---
            if fine_schur:
                full = jnp.stack([r1, jnp.zeros_like(r1)])
            else:
                full = r1
            r_coarse = transfer.restrict_f2c(full)
            rnorm = jnp.sqrt(norm2sq(r_coarse))
            r_coarse_prep = coarse_stencil.prepare_M(r_coarse, coarse_type)
            rnorm_prep = jnp.sqrt(norm2sq(r_coarse_prep))
            inner_tol = coarse_tol * rnorm / rnorm_prep

            # --- coarse solve (reference :885-998) ---
            if (level == n_levels - 2 and self.coarsest_solve.direct
                    and self.coarsest_dinv is not None):
                # Direct dense solve: one dense matvec.
                dinv = self.coarsest_dinv.astype(r_coarse_prep.dtype)
                e_coarse = (dinv @ r_coarse_prep.reshape(-1)).reshape(
                    r_coarse_prep.shape)
                sub_iters = jnp.int32(1)
                sub_ops = jnp.int32(1)
            elif level == n_levels - 2:
                e0 = jnp.zeros_like(r_coarse_prep)
                if (coarsest_normal and self.coarsest_solve.deflate
                        and self.coarsest_evecs is not None):
                    # Deflation projection (reference :895-908).
                    for i in range(self.coarsest_evecs.shape[0]):
                        v = self.coarsest_evecs[i]
                        e0 = e0 + (vdot(v, r_coarse_prep)
                                   / self.coarsest_evals[i]) * v
                shift = self.coarsest_solve.normal_shift
                if coarsest_normal and shift != 0.0:
                    base = apply_coarse
                    mv = lambda x: base(x) + shift * x
                else:
                    mv = apply_coarse
                if coarsest_normal:
                    if coarse_restart == -1:
                        res = solvers.cg(mv, r_coarse_prep, x0=e0,
                                         max_iter=coarse_max_iter,
                                         tol=inner_tol, verbose=vprefix)
                    else:
                        res = solvers.cg_restart(
                            mv, r_coarse_prep, x0=e0,
                            max_iter=coarse_max_iter, tol=inner_tol,
                            restart_freq=coarse_restart)
                else:
                    if coarse_restart == -1:
                        res = solvers.gcr(mv, r_coarse_prep, x0=e0,
                                          max_iter=coarse_max_iter,
                                          tol=inner_tol, verbose=vprefix)
                    else:
                        res = solvers.gcr_restart(
                            mv, r_coarse_prep, x0=e0,
                            max_iter=coarse_max_iter, tol=inner_tol,
                            restart_freq=coarse_restart, verbose=vprefix)
                e_coarse = res.x
                sub_iters, sub_ops = res.iters, res.ops_count
            else:
                # K-cycle recursion (reference :973-995). The deeper
                # preconditioner sees the INNER solve's struct, so its
                # levels print at its precond_verbosity.
                inner_precond = self.make_preconditioner(level + 1,
                                                         verbose=vprefix)
                if coarse_restart == -1:
                    res, carry = solvers.gcr_var_precond(
                        apply_coarse, r_coarse_prep, inner_precond,
                        max_iter=coarse_max_iter, tol=inner_tol,
                        precond_carry=carry, verbose=vprefix,
                        fixed_trips=coarse_fixed)
                else:
                    res, carry = solvers.gcr_var_precond_restart(
                        apply_coarse, r_coarse_prep, inner_precond,
                        max_iter=coarse_max_iter, tol=inner_tol,
                        restart_freq=coarse_restart, precond_carry=carry,
                        verbose=vprefix, fixed_trips=coarse_fixed)
                e_coarse = res.x
                sub_iters, sub_ops = res.iters, res.ops_count
            carry = dict(carry)
            carry["counts"] = carry["counts"].at[
                level + 1, DSLASH_KRYLOV].add(sub_ops)
            carry["iters"] = carry["iters"].at[level + 1].add(sub_iters)

            # --- reconstruct + prolong (reference :999-1021) ---
            e_rec = coarse_stencil.reconstruct_M(e_coarse, r_coarse,
                                                 coarse_type)
            z2_full = transfer.prolong_c2f(e_rec)
            z2 = z2_full[0] if fine_schur else z2_full
            lhs = z1 + z2

            # --- postsmooth (reference :1023-1056) ---
            if level_solve.post_iters > 0:
                r2 = rhs - apply_fine(lhs)
                z3, carry = smoother(r2, level_solve.post_iters,
                                     level_solve.post_tol,
                                     level_solve.post_cgne,
                                     DSLASH_POSTSMOOTH, carry)
                lhs = lhs + z3
                carry = dict(carry)
                carry["counts"] = carry["counts"].at[
                    level, DSLASH_POSTSMOOTH].add(1)
            return lhs, carry

        return precond

    # ------------------------------------------------------------------
    # Outer MG-preconditioned solve (the n13 flagship path: FGCR around
    # the K-cycle, reference tests/n13_wilson_kcycle/wilson_kcycle.cpp:459).
    # ------------------------------------------------------------------

    def solve(self, b, tol: float = 1e-10, max_iter: int = 1000,
              restart_freq: int = 32,
              outer_type: StencilType = StencilType.ORIGINAL, x0=None,
              track: bool = True, jit: bool = True,
              verbose: bool = False):
        """Run the outer flexible GCR with the K-cycle preconditioner.

        Returns a SolveResult; Dslash counters are absorbed into the
        host-side trackers when ``track``.
        """
        n_levels = self.get_num_levels()

        # Cache compiled solves. The key is built from monotonic state
        # versions (never reused, unlike id()s, which GC can recycle):
        # every stencil bumps its version on update_links / update_shifts,
        # transfers carry a fixed per-instance version, and deflation /
        # direct-coarsest preparation bumps the hierarchy's own version.
        # Repeated solves (e.g. per-source propagators) reuse the
        # executable; any state mutation misses the cache.
        state_vs = []
        for lvl in range(n_levels):
            st = self.get_stencil(lvl)
            state_vs += [st.version, complex(st.coeffs.shift)]
        for lvl in range(n_levels - 1):
            state_vs.append(self.get_transfer(lvl).version)
        from .solvers import VerboseMG, _as_verbose
        v = _as_verbose(verbose)
        key = (tuple(state_vs), b.shape, str(b.dtype), float(tol),
               int(max_iter), int(restart_freq), int(outer_type),
               self._aux_version,
               (int(v.verbosity), int(v.precond_verbosity), v.prefix))

        run = self._solve_cache.get(key) if jit else None
        if run is None:
            matvec = self._apply_level(0, StencilType(outer_type))
            precond = self.make_preconditioner(0, verbose=v)
            vprefix = (VerboseMG(v.verbosity, v.precond_verbosity,
                                 v.prefix or "[QMG-MG-SOLVE-INFO]: "
                                             "Level 0 ")
                       if v.verbosity else None)

            def run(b, x0):
                carry = _zero_carry(n_levels)
                res, carry = solvers.gcr_var_precond_restart(
                    matvec, b, precond, x0=x0, max_iter=max_iter, tol=tol,
                    restart_freq=restart_freq, precond_carry=carry,
                    verbose=vprefix)
                return res, carry

            if jit:
                run = jax.jit(run)
                if len(self._solve_cache) > 8:
                    self._solve_cache.clear()
                self._solve_cache[key] = run
        x0 = jnp.zeros_like(b) if x0 is None else x0
        res, carry = run(b, x0)
        if track:
            # Outer matvecs are level-0 Krylov ops.
            carry["counts"] = carry["counts"].at[0, DSLASH_KRYLOV].add(
                res.ops_count)
            carry["iters"] = carry["iters"].at[0].add(res.iters)
            self.absorb_carry(carry)
        return res
