"""Real-plane jit boundaries and the whole-solver wrappers.

Every jit boundary of the planes solvers is real: complex arrays
travel as float32 plane-pairs (..., 2) = (real, imag) and are
reassembled with lax.complex inside the computation. The boundary is
plain JAX and costs one decode per solve; retiring it is ROADMAP
"Design" item 4.

``to_planes`` / ``from_planes`` convert at the jit boundary;
``make_planes_solver`` below wraps the whole MG-preconditioned solve
this way.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["to_planes", "from_planes", "host_to_planes",
           "mg_state_planes", "make_planes_solver", "shard_planes_state"]


def to_planes(x):
    """Complex array -> real (..., 2) plane pair (f32 for c64)."""
    x = jnp.asarray(x)
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)


def host_to_planes(x, dtype=np.float32) -> np.ndarray:
    """NumPy version for preparing device inputs on the host."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(dtype)


def from_planes(p):
    """Real (..., 2) plane pair -> complex array."""
    return jax.lax.complex(p[..., 0], p[..., 1])


# ---------------------------------------------------------------------------
# Whole-solver wrapper: run the full MG-preconditioned solve behind real
# jit boundaries. All complex state (stencil coefficient pytrees at every
# level, blocked null vectors, deflation vectors) is plane-encoded once
# on host; one jitted function decodes and solves.
# ---------------------------------------------------------------------------

def mg_state_planes(mg, dtype=np.float32):
    """Extract every complex array of a StatefulMultigridMG hierarchy as a
    flat dict of ``dtype`` plane arrays (host numpy)."""
    state = {}
    for lvl in range(mg.get_num_levels()):
        st = mg.get_stencil(lvl)
        c = st.coeffs
        if c.clover is not None:
            state[f"clover{lvl}"] = host_to_planes(np.asarray(c.clover),
                                                   dtype)
        if c.hopping is not None:
            state[f"hopping{lvl}"] = host_to_planes(np.asarray(c.hopping),
                                                    dtype)
        state[f"shifts{lvl}"] = host_to_planes(np.asarray(
            [complex(c.shift), complex(c.eo_shift), complex(c.dof_shift)]),
            dtype)
    for lvl in range(mg.get_num_levels() - 1):
        t = mg.get_transfer(lvl)
        state[f"nvb{lvl}"] = host_to_planes(np.asarray(t._nvb), dtype)
    if mg.coarsest_dinv is not None:
        state["cdinv"] = host_to_planes(np.asarray(mg.coarsest_dinv), dtype)
    if mg.coarsest_evecs is not None:
        # Coarsest deflation state (reference stateful_multigrid.h:613-696)
        # rides the planes boundary so the device solve applies the same
        # initial-guess projection (:895-908) as the eager path.
        state["cevals"] = host_to_planes(np.asarray(mg.coarsest_evals),
                                         dtype)
        state["cevecs"] = host_to_planes(np.asarray(mg.coarsest_evecs),
                                         dtype)
    return state


def _derived_need(mg, outer_type):
    """Map level -> {"rbj", "fused"} for the derived coefficient sets the
    configured solve will apply (rbjacobi B^-1 / fused Schur composition).

    These are the EXPENSIVE derived builds (batched QR inverses, stencil-
    stencil composition); when the planes state ships them precomputed,
    each solve call skips re-deriving them from the traced coefficients,
    which costs far more than a Krylov iteration. The cheap elementwise
    derived sets (dagger conjugations) stay lazy.
    """
    from .stencil import StencilType
    need = {}

    def add(lvl, t):
        t = StencilType(t)
        if t in (StencilType.RIGHT_JACOBI, StencilType.RBJ_DAGGER,
                 StencilType.RBJ_M_MDAGGER, StencilType.RBJ_MDAGGER_M):
            need.setdefault(lvl, set()).add("rbj")
        elif t == StencilType.RIGHT_SCHUR:
            need.setdefault(lvl, set()).update(("rbj", "fused"))

    n_levels = mg.get_num_levels()
    if outer_type is not None:
        add(0, outer_type)
    if hasattr(mg, "get_level_solve"):
        for lvl in range(n_levels - 1):
            add(lvl, mg.get_level_solve(lvl).fine_stencil_app)
        add(n_levels - 1, mg.coarsest_solve.coarsest_stencil_app)
    return need


def derived_state_planes(mg, outer_type=None, dtype=np.float32):
    """Planes dict of the precomputed derived sets ``_derived_need``
    selects: per level ``rbjcinv{lvl}`` ((clover+mass)^-1),
    ``rbjh{lvl}``/``rbjt{lvl}``/``rbjc{lvl}`` (rbjacobi hopping/twolink/
    corner) and ``schurf{lvl}`` (the 9 composed even-half Schur
    coefficient matrices, stacked). Built eagerly from the hierarchy's
    concrete coefficients — call at state-construction time (per
    configuration), NOT per solve."""
    state = {}
    for lvl, kinds in _derived_need(mg, outer_type).items():
        st = mg.get_stencil(lvl)
        rbj = st.build_rbjacobi_stencil()
        state[f"rbjcinv{lvl}"] = host_to_planes(np.asarray(rbj.cinv), dtype)
        for name, arr in (("rbjh", rbj.coeffs.hopping),
                          ("rbjt", rbj.coeffs.twolink),
                          ("rbjc", rbj.coeffs.corner)):
            if arr is not None:
                state[f"{name}{lvl}"] = host_to_planes(np.asarray(arr),
                                                       dtype)
        if ("fused" in kinds and rbj.coeffs.hopping is not None
                and st.lat.volume > 1):
            from .stencil import build_rbj_schur_fused
            fused = st._rbj_schur_fused
            if fused is None:
                fused = build_rbj_schur_fused(rbj)
            f9 = np.concatenate([np.asarray(fused.clover)[None],
                                 np.asarray(fused.twolink),
                                 np.asarray(fused.corner)])
            state[f"schurf{lvl}"] = host_to_planes(f9, dtype)
    return state


def _patch_hierarchy(mg, state):
    """Patch decoded complex arrays from a planes state dict into the
    hierarchy for tracing. Returns a token for _restore_hierarchy.

    Shifts ride the planes state too: a concrete scalar would make
    derived builds (rbjacobi QR etc.) evaluate eagerly at trace time and
    embed them as constants. Shipped
    derived sets (rbjcinv/rbjh/rbjt/rbjc/schurf, see
    derived_state_planes) are decoded instead of re-derived.
    """
    n_levels = mg.get_num_levels()
    saved = []
    for lvl in range(n_levels):
        st = mg.get_stencil(lvl)
        saved.append((st, st.coeffs, st._dagger, st._rbjacobi,
                      st._rbj_dagger, st._rbj_schur_fused))
        kw = {}
        if f"clover{lvl}" in state:
            kw["clover"] = from_planes(state[f"clover{lvl}"])
        if f"hopping{lvl}" in state:
            kw["hopping"] = from_planes(state[f"hopping{lvl}"])
        sh = from_planes(state[f"shifts{lvl}"])
        st.coeffs = st.coeffs.replace(
            **kw, shift=sh[0], eo_shift=sh[1], dof_shift=sh[2])
        st.invalidate_derived()
        if f"rbjcinv{lvl}" in state:
            from .stencil import RBJacobiSet, SchurFused
            from . import linalg as _linalg
            cinv = from_planes(state[f"rbjcinv{lvl}"])
            zero = jnp.zeros((), cinv.dtype)
            kwr = dict(clover=_linalg.identity_like(cinv),
                       hopping=None, twolink=None, corner=None,
                       shift=zero, eo_shift=zero, dof_shift=zero)
            for name, key in (("hopping", f"rbjh{lvl}"),
                              ("twolink", f"rbjt{lvl}"),
                              ("corner", f"rbjc{lvl}")):
                if key in state:
                    kwr[name] = from_planes(state[key])
            st._rbjacobi = RBJacobiSet(
                coeffs=st.coeffs.replace(**kwr), cinv=cinv)
            if f"schurf{lvl}" in state:
                f9 = from_planes(state[f"schurf{lvl}"])
                st._rbj_schur_fused = SchurFused(
                    clover=f9[0], twolink=f9[1:5], corner=f9[5:9])
    saved_nvb = []
    for lvl in range(n_levels - 1):
        t = mg.get_transfer(lvl)
        saved_nvb.append((t, t._nvb))
        t._nvb = from_planes(state[f"nvb{lvl}"])
    saved_dinv = mg.coarsest_dinv
    if "cdinv" in state:
        mg.coarsest_dinv = from_planes(state["cdinv"])
    saved_defl = (mg.coarsest_evals, mg.coarsest_evecs)
    if "cevecs" in state:
        mg.coarsest_evals = from_planes(state["cevals"])
        mg.coarsest_evecs = from_planes(state["cevecs"])
    return (saved, saved_nvb, saved_dinv, saved_defl)


def _restore_hierarchy(mg, token):
    saved, saved_nvb, saved_dinv, saved_defl = token
    for (st, coeffs, dag, rbj, rbjd, rbjsf) in saved:
        st.coeffs = coeffs
        st._dagger, st._rbjacobi, st._rbj_dagger = dag, rbj, rbjd
        st._rbj_schur_fused = rbjsf
        st.apply_override = None
    for (t, nvb) in saved_nvb:
        t._nvb = nvb
    mg.coarsest_dinv = saved_dinv
    mg.coarsest_evals, mg.coarsest_evecs = saved_defl


def make_planes_solver(mg, tol=1e-8, max_iter=400, restart_freq=32,
                       coarse_apply: str = "jnp",
                       outer_type=None,
                       mesh=None,
                       fixed_outer_iters=None):
    """Returns (solve_planes, state) where solve_planes(state, b_planes)
    -> (x_planes, iters, res_sq) is fully real at the jit boundary.

    The hierarchy's complex state is swapped in from the plane encoding at
    trace time (one decode pass per solve - negligible vs the Krylov
    work), so the same StatefulMultigridMG drives CPU fp64 and GPU c64.
    ``outer_type`` selects the outer operator (e.g. RIGHT_SCHUR for the
    n19 configuration); prepare_M/reconstruct_M run inside the jit, so
    callers still pass the plain rhs planes and get full-space x planes.
    Wrap the returned function in ``jax.jit``.

    ``coarse_apply`` selects the COARSE levels' ORIGINAL apply
    formulation:
      * "jnp": the stacked-einsum apply (default);
      * "gather": static-neighbor-table gather + one einsum (~4 ops
        per apply instead of ~10, stencil.build_gather_apply).

    ``mesh`` (a 2D ("y", "x") jax Mesh) makes the whole solve
    multi-chip: the fine level's Dslash runs through the explicit
    shard_map + ppermute halo exchange (qmg_tpu.shard_dslash) and the
    caller places the fine-level state/rhs planes on the mesh
    (shard_planes_state below); coarse levels replicate, Krylov
    reductions become all-reduces under SPMD.
    """
    from . import solvers
    from .stencil import StencilType

    state = mg_state_planes(mg)
    _need = _derived_need(mg, outer_type)
    if _need:
        # Ship the expensive derived sets (rbjacobi QR inverses, fused
        # Schur composition) in the state, built ONCE here instead of
        # re-derived from traced coefficients inside every solve call.
        state.update(derived_state_planes(mg, outer_type))
    n_levels = mg.get_num_levels()
    if mesh is not None:
        from . import parallel
        parallel.validate_mg_sharding(mg, mesh)

    def solve_planes(state, b_planes):
        # f32 matmuls and einsums may run in TF32 (about 3 decimal
        # digits) at default precision; the rbjacobi QR / B^-1 chains
        # and the Krylov projections need full f32. The K-cycle is
        # latency-bound, not matmul-bound, so pinning costs little.
        with jax.default_matmul_precision("highest"):
            return _solve_impl(state, b_planes)

    def _solve_impl(state, b_planes):
        token = _patch_hierarchy(mg, state)
        try:
            b = from_planes(b_planes)
            fine_st = mg.get_stencil(0)
            from .stencil import apply_M as _apply_M
            fine_coeffs = fine_st.coeffs
            otype = (StencilType.ORIGINAL if outer_type is None
                     else StencilType(outer_type))
            # Build every derived set (dagger/rbjacobi/fused Schur) the
            # configured solve needs at the TOP trace level. With traced
            # coefficients, a lazy build first triggered inside a Krylov
            # while_loop body would be re-executed every iteration.
            if hasattr(mg, "prebuild_derived_stencils"):
                mg.prebuild_derived_stencils(otype)
            if otype == StencilType.ORIGINAL:
                # The outer matvec is the plain apply (it bypasses the
                # mesh override; under a mesh XLA's partitioner shards it).
                matvec = lambda v: _apply_M(fine_coeffs, v)
            else:
                matvec = lambda v: fine_st.apply_M(v, otype)
            if mesh is not None:
                from .shard_dslash import make_sharded_dslash
                fine_st.apply_override = make_sharded_dslash(
                    fine_st.coeffs, mesh)
            if coarse_apply == "gather":
                from .stencil import build_gather_apply
                for lvl in range(1, n_levels):
                    st_l = mg.get_stencil(lvl)
                    st_l.apply_override = build_gather_apply(st_l.coeffs)
            elif coarse_apply != "jnp":
                raise ValueError(f"unknown coarse_apply {coarse_apply!r}")
            precond = mg.make_preconditioner(0)
            carry = {"counts": jnp.zeros((n_levels, 4), jnp.int32),
                     "iters": jnp.zeros((n_levels,), jnp.int32)}
            rhs = (b if otype == StencilType.ORIGINAL
                   else fine_st.prepare_M(b, otype))
            if fixed_outer_iters:
                # Fixed-schedule outer: exactly fixed_outer_iters FGCR
                # trips, predicate on the trip counter only (vmap
                # batches with no masking; see make_batched_planes_
                # solver). tol still sets the reported res_sq target.
                res, carry = solvers.gcr_var_precond_restart(
                    matvec, rhs, precond, max_iter=int(fixed_outer_iters),
                    tol=tol, restart_freq=restart_freq,
                    precond_carry=carry, fixed_trips=True)
            else:
                res, carry = solvers.gcr_var_precond_restart(
                    matvec, rhs, precond, max_iter=max_iter, tol=tol,
                    restart_freq=restart_freq, precond_carry=carry)
            x = (res.x if otype == StencilType.ORIGINAL
                 else fine_st.reconstruct_M(res.x, b, otype))
            return (to_planes(x), res.iters,
                    jnp.real(res.res_sq).astype(jnp.float32))
        finally:
            _restore_hierarchy(mg, token)

    return solve_planes, state


def make_batched_planes_solver(mg, **solver_kw):
    """Multi-RHS (batched) planes solver: ``solve(state, B_planes)``
    with ``B_planes`` carrying a leading rhs axis ``(nrhs, *cv, 2)``;
    returns per-rhs ``(x_planes, iters, res_sq)`` stacked on the same
    axis.

    Throughput mode with NO reference counterpart: the
    reference streams one propagator solve per source per config
    (tests/n15_wilson_goldstone/wilson_goldstone.cpp source loop); here
    the whole MG K-cycle is ``jax.vmap``-ed over the rhs axis, so every
    level's matvecs/einsums gain a batch dimension (amortizing the
    coarse-level dispatch latency that dominates small lattices) and ONE
    device program solves all sources. Per-rhs
    semantics are exact: XLA's while_loop batching masks carry updates
    per lane, so each rhs follows its own trajectory, stops at its own
    iteration count, and keeps its converged solution frozen while
    other lanes finish (wall time = slowest rhs).

    ``solver_kw`` forwards to make_planes_solver.
    """
    solve_planes, state = make_planes_solver(mg, **solver_kw)
    return jax.vmap(solve_planes, in_axes=(None, 0)), state


def make_fixed_batched_planes_solver(mg, outer_iters: int,
                                     allow_masked_inner: bool = False,
                                     **solver_kw):
    """Fixed-schedule batched multi-RHS solver: like
    make_batched_planes_solver, but the OUTER FGCR runs exactly
    ``outer_iters`` trips - removing the outer while_loop's per-lane
    masking over the (R, n) direction-store carries. Whether either
    batched mode beats sequential per-rhs dispatches on the GPU is not
    measured yet.

    By default the INNER schedule must also be trip-counted (build the
    hierarchy with KCycleConfig(inner_fixed_iters=...) and a direct
    coarsest) - then NO loop anywhere has a data-dependent predicate.
    ``allow_masked_inner=True`` keeps the adaptive (tolerance-stopping)
    inner K-cycle loops instead: their masked carries are small
    coarse-level fields, and the adaptive inner typically does LESS
    work than a conservatively calibrated fixed inner count.

    Calibrate ``outer_iters`` from one adaptive solve (the returned
    res_sq reports the achieved residual so under-shooting is visible).
    """
    if not allow_masked_inner:
        if not (mg.coarsest_solve.direct and mg.coarsest_dinv is not None):
            raise ValueError(
                "fixed-schedule batched solves need a direct coarsest "
                "(prepare_direct_coarsest / KCycleConfig("
                "coarsest_direct=True)): the iterative coarsest keeps a "
                "tolerance loop that re-introduces per-lane masking; or "
                "pass allow_masked_inner=True")
        for lvl in range(1, mg.get_num_levels() - 1):
            if not mg.get_level_solve(lvl).fixed_trips:
                raise ValueError(
                    f"level-{lvl} intermediate solve is not fixed_trips "
                    "- build the hierarchy with KCycleConfig("
                    "inner_fixed_iters=k), or pass "
                    "allow_masked_inner=True")
    solve_planes, state = make_planes_solver(
        mg, fixed_outer_iters=int(outer_iters), **solver_kw)
    return jax.vmap(solve_planes, in_axes=(None, 0)), state


def make_calibrated_batched_planes_solver(mg, probe_b_planes, margin: int = 1,
                                          **solver_kw):
    """Fixed-outer batched solver auto-calibrated by ONE masked probe
    solve.

    Runs the single-rhs masked (adaptive) solver once on
    ``probe_b_planes`` - a representative rhs in planes layout - reads
    its outer iteration count, and builds the fixed-outer batched
    solver at ``iters + margin`` trips with the adaptive masked inner
    (the measured-best fixed configuration; the flexible-GCR tolerance
    contract keeps the reported res_sq honest, quantum-linalg
    minv_vector_gcr_var_precond / reference stateful_multigrid.h:916).

    Returns ``(solve, state, outer_iters)``. Callers should check the
    returned per-rhs res_sq against the tolerance: statistically a
    same-distribution rhs converges within +-1 outer of the probe, so
    margin=1 meets the target without the >1-decade overshoot a
    guessed schedule produces.
    """
    import numpy as _np
    probe_solve, _ = make_planes_solver(mg, **solver_kw)
    state = None  # reuse the state from the fixed build below
    _, iters, _ = jax.jit(probe_solve)(mg_state_planes(mg), probe_b_planes)
    outer = int(_np.asarray(jax.device_get(iters))) + int(margin)
    solve, state = make_fixed_batched_planes_solver(
        mg, outer, allow_masked_inner=True, **solver_kw)
    return solve, state, outer


def make_refined_planes_solver(mg, tol: float = 1e-10,
                               inner_tol: float = 1e-5,
                               max_iter: int = 400, restart_freq: int = 32,
                               max_outer: int = 12, **solver_kw):
    """The reference's fp64 1e-10 contract around a c64 device solve.

    Wraps ``make_planes_solver`` (the c64 MG K-cycle) as the correction
    step of a host-fp64 defect-correction loop (refine.py): the TRUE
    residual is accumulated in complex128 NumPy against the fine
    operator's fp64 coefficients, the device solves the correction
    equation in c64 to ``inner_tol``, and the loop repeats until the
    fp64 relative residual clears ``tol`` - the n13 outer contract
    (tests/n13_wilson_kcycle/wilson_kcycle.cpp:104-106) that a bare c64
    solve cannot reach.

    Returns ``(solve, state)``; ``solve(b[, state=...]) -> RefineResult``
    with a NumPy complex128 solution. ``solver_kw`` forwards to
    make_planes_solver (kernel routing, outer_type, mesh); with a mesh,
    pass the shard-placed state explicitly per call.
    """
    from .refine import HostStencil, refine_solve

    host_op = HostStencil(mg.get_stencil(0))
    solve_planes, state = make_planes_solver(
        mg, tol=inner_tol, max_iter=max_iter, restart_freq=restart_freq,
        **solver_kw)
    jitted = jax.jit(solve_planes)

    def solve(b, state=state, tol=tol, max_outer=max_outer):
        def inner(r):
            r_p = host_to_planes(np.asarray(r, np.complex64))
            x_p, iters, _ = jitted(state, r_p)
            xp = np.asarray(jax.device_get(x_p))
            return xp[..., 0] + 1j * xp[..., 1], int(iters)

        return refine_solve(host_op, inner, b, tol=tol,
                            max_outer=max_outer)

    return solve, state


def shard_planes_state(state, mesh, b_planes=None):
    """Place a planes-solver state dict (mg_state_planes layout) on a
    2D ("y", "x") mesh: fine-level (level 0) clover/hopping planes and
    the rhs shard over the lattice axes, everything else replicates.

    Plane layouts: clover planes (2, Y, Xh, nc, nc, 2), hopping planes
    (4, 2, Y, Xh, nc, nc, 2), field planes (2, Y, Xh, nc, 2).

    Returns the placed state (and the placed rhs when ``b_planes`` is
    given).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    placed = {}
    for k, v in state.items():
        if k == "clover0":
            placed[k] = put(v, P(None, "y", "x", None, None, None))
        elif k == "hopping0":
            placed[k] = put(v, P(None, None, "y", "x", None, None, None))
        else:
            placed[k] = put(v, P())
    if b_planes is None:
        return placed
    b_placed = put(b_planes, P(None, "y", "x", None, None))
    return placed, b_placed
