"""Krylov solvers as jittable `lax.while_loop` kernels.

JAX counterpart of the quantum-linalg inverter family the reference
links against (reconstructed from call sites; SURVEY.md section 2.9):
minv_vector_{cg, cg_restart, gcr, gcr_restart, bicgstab, bicgstab_l,
minres, richardson, tfqmr, gcr_var_precond, gcr_var_precond_restart}.

Conventions (matching the reference's observable behavior):

  * matvec is a pure callable x -> A x on arrays of any fixed shape.
  * Convergence: ||r|| < tol * ||b|| (tests print sqrt(resSq)/bnorm).
  * Results carry iteration count, final residual norm^2, success flag and
    ops_count = number of operator applications (the currency of the
    reference's DslashTrackerMG, multigrid/stateful_multigrid.h:119-200).
  * The flexible solvers take precond(r, carry) -> (z, carry) so a nested
    K-cycle can thread its per-level counters through the solve.

Everything here traces into a single XLA computation - the hot loops run
on device with no host round-trips; dynamic tolerances (the K-cycle's
coarse_tol * rnorm/rnorm_prep rescale) are traced scalars.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .linalg import vdot, norm2sq

# Trace-time cap on the flat (R, n) GCR direction store (see _gcr_impl).
# A legitimate restart_freq=32 store at 2048^2 is 4 GiB and must pass;
# the restart_freq=-1 hazard (R = max_iter = 1000 at production sizes,
# tens-to-thousands of GiB) must not. Under a mesh the store shards with
# the fields, so the effective per-device footprint is store/n_devices -
# raise the limit for large multi-device runs if needed.
GCR_STORE_LIMIT_BYTES = 8 * 1024 ** 3

__all__ = [
    "SolveResult", "Verbosity", "VerboseMG", "cg", "cg_restart", "gcr",
    "gcr_restart", "bicgstab", "bicgstab_l", "minres", "richardson",
    "tfqmr", "gcr_var_precond", "gcr_var_precond_restart",
]


class Verbosity(enum.IntEnum):
    """Print levels of quantum-linalg's inversion_verbose_struct
    (reconstructed from the reference's use at
    multigrid/stateful_multigrid.h:761-776): NONE prints nothing,
    SUMMARY prints one line per completed inversion (iterations + final
    relative residual), DETAIL additionally prints every iteration's
    residual."""
    NONE = 0
    SUMMARY = 1
    DETAIL = 2


@dataclasses.dataclass
class VerboseMG:
    """inversion_verbose_struct analog: this solve's own print level,
    an independent level for its preconditioner's solves, and the line
    prefix (the reference indents two spaces per MG level and tags
    '[QMG-MG-SOLVE-INFO]: Level N')."""
    verbosity: Verbosity = Verbosity.NONE
    precond_verbosity: Verbosity = Verbosity.NONE
    prefix: str = ""


def _as_verbose(verbose) -> VerboseMG:
    """Back-compat coercion: None/False -> NONE; a bare prefix string ->
    DETAIL with that prefix (the pre-round-5 solver convention); True ->
    DETAIL; VerboseMG passes through."""
    if isinstance(verbose, VerboseMG):
        return verbose
    if verbose is None or verbose is False:
        return VerboseMG()
    if verbose is True:
        return VerboseMG(Verbosity.DETAIL, Verbosity.DETAIL)
    return VerboseMG(Verbosity.DETAIL, Verbosity.NONE, str(verbose))


class SolveResult(NamedTuple):
    """Analog of quantum-linalg inversion_info (.success/.iter/.resSq/
    .ops_count)."""
    x: jax.Array
    iters: jax.Array      # int32
    res_sq: jax.Array     # real
    converged: jax.Array  # bool
    ops_count: jax.Array  # int32, operator applications


def _real_dtype(x):
    return jnp.real(jnp.zeros((), dtype=x.dtype)).dtype


def _i32(v):
    return jnp.asarray(v, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Conjugate gradient (for hermitian positive definite ops).
# ---------------------------------------------------------------------------

def _verbose_print(verbose, k, rsq, bsq):
    """Per-iteration residual print at DETAIL level (quantum-linalg
    inversion_verbose_struct analog); works inside jit via debug.print."""
    v = _as_verbose(verbose)
    if v.verbosity >= Verbosity.DETAIL:
        jax.debug.print(v.prefix + "iter {k} relres {r:.6e}", k=k,
                        r=jnp.sqrt(rsq / bsq))


def _verbose_summary(verbose, name, iters, rsq, bsq):
    """One line per completed inversion at SUMMARY level (the reference's
    VERB_SUMMARY: algorithm, iteration count, final relative residual)."""
    v = _as_verbose(verbose)
    if v.verbosity >= Verbosity.SUMMARY:
        jax.debug.print(
            v.prefix + name + " summary: {k} iters, relres {r:.6e}",
            k=iters, r=jnp.sqrt(rsq / bsq))


def cg(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
       verbose=None) -> SolveResult:
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    r0 = b - matvec(x0)
    p0 = r0

    def cond(s):
        x, r, p, rsq, k = s
        return jnp.logical_and(jnp.isfinite(rsq),
                               jnp.logical_and(k < max_iter, rsq > target))

    def body(s):
        x, r, p, rsq, k = s
        ap = matvec(p)
        # Breakdown guard (see gcr core): a stalled solve's <p, Ap> can
        # underflow to 0 in f32 - no-op the iteration instead of NaN.
        den = jnp.real(vdot(p, ap))
        alpha = jnp.where(den > 0, rsq / jnp.where(den > 0, den, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rsq_new = norm2sq(r)
        beta = rsq_new / rsq
        p = r + beta * p
        _verbose_print(verbose, k + 1, rsq_new, bsq)
        return (x, r, p, rsq_new, k + 1)

    x, r, p, rsq, k = jax.lax.while_loop(
        cond, body, (x0, r0, p0, norm2sq(r0), _i32(0)))
    _verbose_summary(verbose, "cg", k, rsq, bsq)
    return SolveResult(x, k, rsq, rsq <= target, k + 1)


def cg_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
               restart_freq: int = 32) -> SolveResult:
    """CG with hard restarts every restart_freq iterations
    (quantum-linalg minv_vector_cg_restart)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq

    def outer_cond(s):
        x, rsq, k, ops = s
        return jnp.logical_and(k < max_iter, rsq > target)

    def outer_body(s):
        x, rsq, k, ops = s
        res = cg(matvec, b, x0=x, max_iter=restart_freq, tol=tol)
        return (res.x, res.res_sq, k + res.iters,
                ops + res.ops_count)

    r0sq = norm2sq(b - matvec(x0))
    x, rsq, k, ops = jax.lax.while_loop(
        outer_cond, outer_body, (x0, r0sq, _i32(0), _i32(1)))
    return SolveResult(x, k, rsq, rsq <= target, ops)


# ---------------------------------------------------------------------------
# GCR family. One implementation drives gcr / gcr_restart /
# gcr_var_precond / gcr_var_precond_restart: the preconditioner is a
# callable z, carry = precond(r, carry) (identity by default).
# ---------------------------------------------------------------------------

def _gcr_impl(matvec, b, x0, max_iter: int, tol, restart_len: int,
              precond=None, precond_carry=None, verbose=None,
              fixed_trips: bool = False):
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    rdt = _real_dtype(b)
    R = restart_len

    if precond is None:
        def precond(r, carry):
            return r, carry

    r0 = b - matvec(x0)

    # Direction store is FLAT (R, n), so the projections are plain
    # matvecs rather than multi-axis einsum reductions
    # ("i...,...->i" over the 4 trailing field axes).
    n = int(np.prod(b.shape))
    # Guard the direction store: unrestarted GCR (restart_freq=-1 routes
    # here with restart_len=max_iter) allocates 2*(R, n) complex arrays;
    # at default caps (max_iter 1000) on a production lattice that is
    # tens of GB. Fail at trace time instead of OOMing the device.
    store_bytes = 2 * R * n * jnp.dtype(b.dtype).itemsize
    if store_bytes > GCR_STORE_LIMIT_BYTES:
        raise ValueError(
            f"GCR direction store (2 x {R} x {n} {jnp.dtype(b.dtype).name}"
            f" = {store_bytes / 2**30:.1f} GiB) exceeds the "
            f"{GCR_STORE_LIMIT_BYTES / 2**30:.1f} GiB limit - use the "
            "restarted variant (restart_freq > 0) at this problem size, "
            "or raise solvers.GCR_STORE_LIMIT_BYTES")
    ps0 = jnp.zeros((R, n), dtype=b.dtype)
    aps0 = jnp.zeros_like(ps0)
    apsq0 = jnp.ones((R,), dtype=rdt)  # dummy ones to avoid 0/0

    def cond(s):
        x, r, rsq, ps, aps, apsq, j, k, ops, carry = s
        if fixed_trips:
            # Fixed-schedule mode: the predicate depends ONLY on the
            # (unbatched) trip counter, so a vmap-ed solve batches with
            # NO per-lane masking selects on the carries - the whole
            # body stays a clean batched program (make_batched_planes_
            # solver). Runs exactly max_iter trips; `converged` still
            # reports the tolerance test.
            return k < max_iter
        return jnp.logical_and(jnp.isfinite(rsq),
                               jnp.logical_and(k < max_iter, rsq > target))

    def body(s):
        x, r, rsq, ps, aps, apsq, j, k, ops, carry = s

        # Restart: recompute the true residual, clear direction store.
        def do_restart(args):
            x, r, ps, aps, apsq, ops = args
            r_new = b - matvec(x)
            return (x, r_new, jnp.zeros_like(ps), jnp.zeros_like(aps),
                    jnp.ones_like(apsq), ops + 1)

        need_restart = j >= R
        x, r, ps, aps, apsq, ops = jax.lax.cond(
            need_restart, do_restart, lambda a: a,
            (x, r, ps, aps, apsq, ops))
        j = jnp.where(need_restart, 0, j)

        z, carry = precond(r, carry)
        ap = matvec(z)
        ops = ops + 1

        # Orthogonalize (z, Az) against stored directions (slots < j).
        valid = (jnp.arange(R) < j)
        ap_flat = ap.reshape(n)
        betas = (jnp.conj(aps) @ ap_flat) / apsq
        betas = jnp.where(valid, betas, 0.0)
        ap = (ap_flat - betas @ aps).reshape(b.shape)
        z = (z.reshape(n) - betas @ ps).reshape(b.shape)

        apsq_new = norm2sq(ap)
        # Breakdown guard: when the solve has stalled at the dtype's
        # noise floor (e.g. a c64 solve asked for tol 1e-10), the
        # orthogonalized direction collapses and apsq_new can UNDERFLOW
        # to exactly 0 in f32 - alpha would be 0/0 = NaN and poison x
        # (observed in the 512^2 adaptive pass-stage smoothing). A
        # broken-down iteration becomes a
        # no-op (alpha 0, dummy apsq slot) instead; `converged` still
        # reports the tolerance test honestly.
        broke = ~(apsq_new > jnp.asarray(np.finfo(rdt).tiny, rdt))
        alpha = jnp.where(broke, 0.0,
                          vdot(ap, r) / jnp.where(broke, 1.0, apsq_new))
        x = x + alpha * z
        r = r - alpha * ap
        rsq = norm2sq(r)

        ps = jax.lax.dynamic_update_index_in_dim(ps, z.reshape(n), j, 0)
        aps = jax.lax.dynamic_update_index_in_dim(aps, ap.reshape(n), j, 0)
        apsq = jax.lax.dynamic_update_index_in_dim(
            apsq, jnp.where(broke, jnp.ones((), rdt), apsq_new), j, 0)
        _verbose_print(verbose, k + 1, rsq, bsq)
        return (x, r, rsq, ps, aps, apsq, j + 1, k + 1, ops, carry)

    state0 = (x0, r0, norm2sq(r0), ps0, aps0, apsq0, _i32(0), _i32(0),
              _i32(1), precond_carry)
    out = jax.lax.while_loop(cond, body, state0)
    x, r, rsq, ps, aps, apsq, j, k, ops, carry = out
    _verbose_summary(verbose, "gcr", k, rsq, bsq)
    return SolveResult(x, k, rsq, rsq <= target, ops), carry


def gcr(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
        verbose=None) -> SolveResult:
    """Unrestarted GCR: keeps up to max_iter directions."""
    res, _ = _gcr_impl(matvec, b, x0, max_iter, tol,
                       restart_len=max(int(max_iter), 1), verbose=verbose)
    return res


def gcr_restart(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
                restart_freq: int = 32, verbose=None) -> SolveResult:
    res, _ = _gcr_impl(matvec, b, x0, max_iter, tol,
                       restart_len=int(restart_freq), verbose=verbose)
    return res


def gcr_var_precond(matvec, b, precond, x0=None, max_iter: int = 1000,
                    tol=1e-8, precond_carry=None, verbose=None,
                    fixed_trips: bool = False):
    """Flexible GCR with a variable (possibly nonlinear) preconditioner -
    the outer solver of the reference's MG stack
    (quantum-linalg minv_vector_gcr_var_precond)."""
    return _gcr_impl(matvec, b, x0, max_iter, tol,
                     restart_len=max(int(max_iter), 1), precond=precond,
                     precond_carry=precond_carry, verbose=verbose,
                     fixed_trips=fixed_trips)


def gcr_var_precond_restart(matvec, b, precond, x0=None,
                            max_iter: int = 1000, tol=1e-8,
                            restart_freq: int = 32, precond_carry=None,
                            verbose=None, fixed_trips: bool = False):
    return _gcr_impl(matvec, b, x0, max_iter, tol,
                     restart_len=int(restart_freq), precond=precond,
                     precond_carry=precond_carry, verbose=verbose,
                     fixed_trips=fixed_trips)


# ---------------------------------------------------------------------------
# BiCGstab and BiCGstab(l).
# ---------------------------------------------------------------------------

def bicgstab(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8
             ) -> SolveResult:
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    r0 = b - matvec(x0)
    rtilde = r0
    one = jnp.ones((), dtype=b.dtype)

    def cond(s):
        x, r, p, v, rho, alpha, omega, rsq, k, ops = s
        return jnp.logical_and(jnp.isfinite(rsq),
                               jnp.logical_and(k < max_iter, rsq > target))

    def body(s):
        x, r, p, v, rho, alpha, omega, rsq, k, ops = s
        rho_new = vdot(rtilde, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / vdot(rtilde, v)
        s_vec = r - alpha * v
        t = matvec(s_vec)
        omega = vdot(t, s_vec) / norm2sq(t)
        x = x + alpha * p + omega * s_vec
        r = s_vec - omega * t
        return (x, r, p, v, rho_new, alpha, omega, norm2sq(r), k + 1,
                ops + 2)

    state0 = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
              norm2sq(r0), _i32(0), _i32(1))
    x, r, p, v, rho, alpha, omega, rsq, k, ops = jax.lax.while_loop(
        cond, body, state0)
    return SolveResult(x, k, rsq, rsq <= target, ops)


def bicgstab_l(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8,
               l: int = 6) -> SolveResult:
    """BiCGstab(l) after Sleijpen-Fokkema. ``l`` is static; the BiCG and MR
    parts unroll at trace time. Used for null-vector generation
    (reference tests/n13_wilson_kcycle/wilson_kcycle.cpp:359, l=6).

    ``max_iter`` counts l-cycles x l (matching the reference's use of 500
    as a generous cap); each l-cycle costs 2l matvecs.
    """
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    cdt = b.dtype

    r0 = b - matvec(x0)
    rtilde = r0
    max_cycles = max(int(max_iter) // max(l, 1), 1)

    def cond(s):
        x, rs, us, rho0, alpha, omega, rsq, k, ops = s
        return jnp.logical_and(jnp.isfinite(rsq),
                               jnp.logical_and(k < max_cycles,
                                               rsq > target))

    def body(s):
        x, rs, us, rho0, alpha, omega, rsq, k, ops = s
        rho0 = -omega * rho0
        # --- BiCG part (unrolled over j) ---
        for j in range(l):
            rho1 = vdot(rtilde, rs[j])
            beta = alpha * rho1 / rho0
            rho0 = rho1
            us = us.at[:j + 1].set(rs[:j + 1] - beta * us[:j + 1])
            us = us.at[j + 1].set(matvec(us[j]))
            gamma_c = vdot(rtilde, us[j + 1])
            alpha = rho0 / gamma_c
            rs = rs.at[:j + 1].set(rs[:j + 1] - alpha * us[1:j + 2])
            rs = rs.at[j + 1].set(matvec(rs[j]))
            x = x + alpha * us[0]
        ops = ops + 2 * l
        # --- MR part: minimize ||r0 - sum_j gamma_j r_j|| (j=1..l) ---
        # Modified Gram-Schmidt on r_1..r_l (Fokkema's tau/gamma recurrences).
        tau = jnp.zeros((l + 1, l + 1), dtype=cdt)
        sigma = jnp.zeros((l + 1,), dtype=jnp.real(r0).dtype)
        gamma_p = jnp.zeros((l + 1,), dtype=cdt)
        for j in range(1, l + 1):
            for i in range(1, j):
                t_ij = vdot(rs[i], rs[j]) / sigma[i]
                tau = tau.at[i, j].set(t_ij)
                rs = rs.at[j].add(-t_ij * rs[i])
            sigma = sigma.at[j].set(norm2sq(rs[j]))
            gamma_p = gamma_p.at[j].set(vdot(rs[j], rs[0]) / sigma[j])
        gamma = jnp.zeros((l + 1,), dtype=cdt)
        gamma = gamma.at[l].set(gamma_p[l])
        for j in range(l - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j, i] * gamma[i]
            gamma = gamma.at[j].set(acc)
        gamma_pp = jnp.zeros((l + 1,), dtype=cdt)
        for j in range(1, l):
            acc = gamma[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j, i] * gamma[i + 1]
            gamma_pp = gamma_pp.at[j].set(acc)
        # Updates.
        x = x + gamma[1] * rs[0]
        rs = rs.at[0].add(-gamma_p[l] * rs[l])
        us = us.at[0].add(-gamma[l] * us[l])
        for j in range(1, l):
            us = us.at[0].add(-gamma[j] * us[j])
            x = x + gamma_pp[j] * rs[j]
            rs = rs.at[0].add(-gamma_p[j] * rs[j])
        omega = gamma[l]
        return (x, rs, us, rho0, alpha, omega, norm2sq(rs[0]), k + 1, ops)

    rs0 = jnp.zeros((l + 1,) + b.shape, dtype=cdt).at[0].set(r0)
    us0 = jnp.zeros((l + 1,) + b.shape, dtype=cdt)
    one = jnp.ones((), dtype=cdt)
    state0 = (x0, rs0, us0, one, jnp.zeros((), dtype=cdt), one,
              norm2sq(r0), _i32(0), _i32(1))
    x, rs, us, rho0, alpha, omega, rsq, k, ops = jax.lax.while_loop(
        cond, body, state0)
    return SolveResult(x, k * l, rsq, rsq <= target, ops)


# ---------------------------------------------------------------------------
# MinRes smoother with relaxation (the K-cycle smoother:
# minv_vector_minres(z, r, n=2, tol, relax=0.85, op), reference
# multigrid/stateful_multigrid.h:851-861).
# ---------------------------------------------------------------------------

def minres(matvec, b, x0=None, max_iter: int = 2, tol=1e-15,
           omega: float = 1.0) -> SolveResult:
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    r0 = b - matvec(x0)

    def cond(s):
        x, r, rsq, k, ops = s
        return jnp.logical_and(k < max_iter, rsq > target)

    def body(s):
        x, r, rsq, k, ops = s
        ar = matvec(r)
        # Guarded against r == 0 exactly (the unrolled path runs the
        # body unconditionally; the while_loop would have skipped).
        arsq = norm2sq(ar)
        alpha = jnp.where(arsq > 0,
                          vdot(ar, r) / jnp.where(arsq > 0, arsq, 1.0),
                          0.0)
        x = x + omega * alpha * r
        r = r - omega * alpha * ar
        return (x, r, norm2sq(r), k + 1, ops + 1)

    try:
        _tol_f = float(jnp.real(tol))
    except Exception:  # traced tolerance: not a fixed-iteration smoother
        _tol_f = None
    if max_iter <= 4 and _tol_f is not None and _tol_f <= 1e-14:
        # Fixed-iteration smoother (the K-cycle's MinRes(2) with a
        # never-met tolerance): unroll instead of a while_loop - the
        # loop machinery costs real latency on the small coarse levels,
        # where a K-cycle runs thousands of these.
        s = (x0, r0, norm2sq(r0), _i32(0), _i32(1))
        for _ in range(max_iter):
            s = body(s)
        x, r, rsq, k, ops = s
        return SolveResult(x, k, rsq, rsq <= target, ops)
    x, r, rsq, k, ops = jax.lax.while_loop(
        cond, body, (x0, r0, norm2sq(r0), _i32(0), _i32(1)))
    return SolveResult(x, k, rsq, rsq <= target, ops)


def richardson(matvec, b, x0=None, max_iter: int = 10, tol=1e-10,
               omega: float = 0.33, blocksize: int = 250) -> SolveResult:
    """Relaxed Richardson x += omega (b - A x), recomputing the true
    residual every ``blocksize`` iterations (quantum-linalg
    minv_vector_richardson; used by the adaptive setup,
    tests/n22_wilson_kcycle_adaptive/wilson_kcycle.cpp:289)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    target = jnp.real(tol) ** 2 * bsq
    r0 = b - matvec(x0)

    def cond(s):
        x, r, rsq, k, ops = s
        return jnp.logical_and(k < max_iter, rsq > target)

    def body(s):
        x, r, rsq, k, ops = s
        x = x + omega * r
        recompute = (k + 1) % blocksize == 0

        def true_resid(_):
            return b - matvec(x)

        def incr_resid(_):
            return r - omega * matvec(r)

        r = jax.lax.cond(recompute, true_resid, incr_resid, None)
        return (x, r, norm2sq(r), k + 1, ops + 1)

    x, r, rsq, k, ops = jax.lax.while_loop(
        cond, body, (x0, r0, norm2sq(r0), _i32(0), _i32(1)))
    return SolveResult(x, k, rsq, rsq <= target, ops)


# ---------------------------------------------------------------------------
# TFQMR (Freund). 2 matvecs per iteration.
# ---------------------------------------------------------------------------

def tfqmr(matvec, b, x0=None, max_iter: int = 1000, tol=1e-8) -> SolveResult:
    x0 = jnp.zeros_like(b) if x0 is None else x0
    bsq = norm2sq(b)
    rdt = _real_dtype(b)
    target = jnp.real(tol) ** 2 * bsq
    r0 = b - matvec(x0)
    rtilde = r0

    w0 = r0
    u0 = r0
    au0 = matvec(u0)
    v0 = au0  # v_0 = A u_0
    d0 = jnp.zeros_like(b)
    tau0 = jnp.sqrt(norm2sq(r0))
    theta0 = jnp.zeros((), dtype=rdt)
    eta0 = jnp.zeros((), dtype=b.dtype)
    rho0 = vdot(rtilde, r0)

    def half_step(x, w, u, au, d, tau, theta, eta, alpha):
        """One TFQMR half-step (Saad, Algorithm 7.4)."""
        w = w - alpha * au
        d = u + (theta * theta * eta / alpha) * d
        theta = jnp.sqrt(norm2sq(w)) / tau
        c = 1.0 / jnp.sqrt(1.0 + theta * theta)
        tau = tau * theta * c
        eta = c * c * alpha
        x = x + eta * d
        return x, w, d, tau, theta, eta

    def cond(s):
        x, w, u, au, v, d, tau, theta, eta, rho, k, ops = s
        # tau bounds ||r|| up to sqrt(2k+1); standard proxy criterion.
        return jnp.logical_and(k < max_iter, tau * tau > target)

    def body(s):
        x, w, u, au, v, d, tau, theta, eta, rho, k, ops = s
        alpha = rho / vdot(rtilde, v)
        u2 = u - alpha * v  # odd-index u
        # even half-step with A u (carried; v = A p != A u in general)
        x, w, d, tau, theta, eta = half_step(
            x, w, u, au, d, tau, theta, eta, alpha)
        # odd half-step
        au2 = matvec(u2)
        x, w, d, tau, theta, eta = half_step(
            x, w, u2, au2, d, tau, theta, eta, alpha)
        rho_new = vdot(rtilde, w)
        beta = rho_new / rho
        u = w + beta * u2
        au = matvec(u)  # reused as the next even half-step's A u
        v = au + beta * (au2 + beta * v)
        return (x, w, u, au, v, d, tau, theta, eta, rho_new, k + 1,
                ops + 2)

    state0 = (x0, w0, u0, au0, v0, d0, tau0, theta0, eta0, rho0, _i32(0),
              _i32(2))
    out = jax.lax.while_loop(cond, body, state0)
    x, w, u, au, v, d, tau, theta, eta, rho, k, ops = out
    return SolveResult(x, k, tau * tau, tau * tau <= target, ops)
