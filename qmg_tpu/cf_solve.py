"""Channels-first K-cycle solve: the whole MG iteration without complex
buffers.

Why this exists: every complex field in the standard solve path carries
the geometric shape (2p, Y, X/2, nc) with nc minormost. A compiler that
tiles the two minor dims pads such fields by the tile width over nc.
Whether that costs anything on the GPU is not measured yet (ROADMAP
"Speed").

The layout is the same one the >=2048^2 device SETUP already uses
(setup_planes channels_first=True, cf.py): hold every field as a
real-pair channels-first array (2, 2p, nc, Y, Xh).  The minor dims
(Y, Xh) tile perfectly at every level, per-site color contractions
are einsums over a middle axis, and no complex buffer ever
materializes.  This module composes the existing cf.py kernels
(stencil_apply_cf, restrict/prolong_f2c_cf) into the full n13 K-cycle
(reference multigrid/stateful_multigrid.h:795-1056 and
tests/n13_wilson_kcycle/wilson_kcycle.cpp:459):

  outer flexible GCR        flat real-pair direction stores (R, 2, n);
                            betas from ONE matmul against [v, swap(v)],
                            corrections from ONE einsum with per-slot
                            2x2 rotation blocks - each pass reads the
                            store exactly once
  K-cycle preconditioner    MinRes(2, omega .85) pre/post smoothing,
                            cf transfers, recursive inner FGCR at
                            tol 0.2, direct dense coarsest
                            (KCycleConfig schedule, setup.py:81-122)

Scope: the standard ORIGINAL-stencil path (the flagship bench
configuration).  Schur/rbjacobi outer variants, deflation, and
mesh-sharded solves stay on tpu_compat.make_planes_solver.
Consumes the SAME planes state dict the standard solver uses
(make_kcycle_setup_planes / checkpoint.save_hierarchy).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import cf
from .lattice import Lattice2D

__all__ = ["make_cf_planes_solver"]


def _field_shape(lat: Lattice2D):
    return (2, 2, lat.nc, lat.y_len, lat.xh)  # (ri, 2p, nc, Y, Xh)


def _cvdot_flat(a, b):
    """<a, b> (complex) for cf arrays: re via the plain real dot, im via
    the swapped pairing (conj convention of linalg.vdot)."""
    re = jnp.sum(a * b)
    im = jnp.sum(a[0] * b[1]) - jnp.sum(a[1] * b[0])
    return re, im


def make_cf_planes_solver(mg, tol=1e-8, max_iter=400, restart_freq=32,
                          inner_tol=0.2, inner_max_iter=1000,
                          inner_restart_freq=32, n_pre_smooth=2,
                          n_post_smooth=2, smooth_omega=0.85):
    """Returns ``solve(state, b_planes) -> (x_planes, iters, res_sq)``
    - signature-compatible with tpu_compat.make_planes_solver, running
    the whole K-cycle in channels-first real-pair form.

    ``mg`` is the (structure-only) hierarchy, used for level lattices
    only; coefficients come from the planes ``state``.  The coarsest
    level must be direct (state carries ``cdinv``): the flagship
    configuration (KCycleConfig.coarsest_direct=True).
    """
    n_levels = mg.get_num_levels()
    lats = [mg.get_stencil(l).lat for l in range(n_levels)]
    rdt = jnp.float32

    def _decode_level(state, l):
        clover = (cf.mat_planes_to_cf(state[f"clover{l}"]).astype(rdt)
                  if f"clover{l}" in state else None)
        hopping = cf.hop_planes_to_cf(state[f"hopping{l}"]).astype(rdt)
        shifts = jnp.moveaxis(state[f"shifts{l}"], -1, 0).astype(rdt)
        return clover, hopping, shifts

    def _apply(level_coeffs, x_cf):
        clover, hopping, shifts = level_coeffs
        return cf.stencil_apply_cf(clover, hopping, shifts, x_cf)

    def _minres_smooth(level_coeffs, r_cf, n_iters):
        """MinRes(n_iters, omega) from zero initial guess (reference
        stateful_multigrid.h:845-866), unrolled."""
        x = jnp.zeros_like(r_cf)
        r = r_cf
        for _ in range(n_iters):
            ar = _apply(level_coeffs, r)
            arsq = cf.cnorm2(ar)
            a_re, a_im = _cvdot_flat(ar, r)
            safe = arsq > jnp.asarray(np.finfo(np.float32).tiny, rdt)
            den = jnp.where(safe, arsq, 1.0)
            alpha = jnp.where(safe, 1.0, 0.0) * jnp.stack(
                [a_re / den, a_im / den])
            step = smooth_omega * alpha
            x = x + cf._pair_smul(step, r)
            r = r - cf._pair_smul(step, ar)
        return x

    def _fgcr_cf(apply_fn, b_cf, precond, tol_, max_iter_, restart_):
        """Flexible GCR, channels-first.  Carries x/r/z/ap as UNPADDED
        cf fields; direction stores as flat real-pair (R, 2, n) with
        single-pass projections/corrections (solvers._gcr_impl
        trajectory semantics: same betas/alpha arithmetic, same restart
        and breakdown handling)."""
        R = int(restart_)
        shape = b_cf.shape
        n = int(np.prod(shape[1:]))  # real elements per component
        bsq = cf.cnorm2(b_cf)
        target = jnp.asarray(tol_, rdt) ** 2 * bsq

        r0 = b_cf - apply_fn(jnp.zeros_like(b_cf))

        def flat(v):
            return v.reshape(2, n)

        def body(s):
            x, r, rsq, ps, aps, apsq, j, k = s

            def do_restart(args):
                x_, r_, ps_, aps_, apsq_ = args
                return (x_, b_cf - apply_fn(x_), jnp.zeros_like(ps_),
                        jnp.zeros_like(aps_), jnp.ones_like(apsq_))

            need = j >= R
            x, r, ps, aps, apsq = lax.cond(
                need, do_restart, lambda a: a, (x, r, ps, aps, apsq))
            j = jnp.where(need, 0, j)

            z = precond(r)
            ap = apply_fn(z)
            apf, zf = flat(ap), flat(z)

            # betas_j = <Ap_j, ap> / apsq_j: one matmul against the
            # two-column rhs [ap, swap(ap)] reads the store once.
            rhs = jnp.stack([apf.reshape(2 * n),
                             jnp.concatenate([apf[1], -apf[0]])], axis=1)
            bri = (aps.reshape(R, 2 * n) @ rhs) / apsq[:, None]
            valid = (jnp.arange(R) < j).astype(rdt)
            bri = bri * valid[:, None]
            # ap -= sum_j beta_j Ap_j, z -= sum_j beta_j p_j via the
            # per-slot 2x2 rotation blocks (one store read each).
            rot = jnp.stack(
                [jnp.stack([bri[:, 0], -bri[:, 1]], axis=1),
                 jnp.stack([bri[:, 1], bri[:, 0]], axis=1)], axis=1)
            apf = apf - jnp.einsum("jcd,jdn->cn", rot, aps)
            zf = zf - jnp.einsum("jcd,jdn->cn", rot, ps)
            ap = apf.reshape(shape)
            z = zf.reshape(shape)

            apsq_new = cf.cnorm2(ap)
            # Breakdown guard (solvers._gcr_impl): no-op a collapsed
            # direction instead of dividing by an f32 underflow.
            broke = ~(apsq_new > jnp.asarray(np.finfo(np.float32).tiny,
                                             rdt))
            den = jnp.where(broke, 1.0, apsq_new)
            a_re, a_im = _cvdot_flat(ap, r)
            alpha = jnp.where(broke, 0.0, 1.0) * jnp.stack(
                [a_re / den, a_im / den])
            x = x + cf._pair_smul(alpha, z)
            r = r - cf._pair_smul(alpha, ap)
            rsq = cf.cnorm2(r)

            ps = lax.dynamic_update_index_in_dim(ps, zf, j, 0)
            aps = lax.dynamic_update_index_in_dim(aps, apf, j, 0)
            apsq = lax.dynamic_update_index_in_dim(
                apsq, jnp.where(broke, jnp.ones((), rdt), apsq_new), j, 0)
            return (x, r, rsq, ps, aps, apsq, j + 1, k + 1)

        def cond(s):
            rsq, k = s[2], s[7]
            return jnp.logical_and(
                jnp.isfinite(rsq),
                jnp.logical_and(k < max_iter_, rsq > target))

        s0 = (jnp.zeros_like(b_cf), r0, cf.cnorm2(r0),
              jnp.zeros((R, 2, n), rdt), jnp.zeros((R, 2, n), rdt),
              jnp.ones((R,), rdt), jnp.int32(0), jnp.int32(0))
        x, r, rsq, *_rest, j, k = lax.while_loop(cond, body, s0)
        return x, k, rsq

    def solve(state, b_planes):
        if "cdinv" not in state:
            raise ValueError(
                "make_cf_planes_solver requires a direct coarsest "
                "(KCycleConfig.coarsest_direct=True): the cf path "
                "ships no iterative coarsest")
        with jax.default_matmul_precision("highest"):
            coeffs = [_decode_level(state, l) for l in range(n_levels)]
            nvbs = [jnp.moveaxis(state[f"nvb{l}"], -1, 0).astype(rdt)
                    for l in range(n_levels - 1)]
            cd = state["cdinv"].astype(rdt)  # (N, N, 2)

            def direct_coarsest(rc_cf):
                latc = lats[-1]
                N = 2 * latc.nc * latc.y_len * latc.xh
                v = rc_cf.transpose(0, 1, 3, 4, 2).reshape(2, N)
                ar, ai = cd[..., 0], cd[..., 1]
                out = jnp.stack([ar @ v[0] - ai @ v[1],
                                 ar @ v[1] + ai @ v[0]])
                return out.reshape(
                    (2, 2, latc.y_len, latc.xh, latc.nc)
                ).transpose(0, 1, 4, 2, 3)

            def make_precond(level):
                lc = coeffs[level]
                nvb = nvbs[level]
                fine_lat, coarse_lat = lats[level], lats[level + 1]

                def precond(r_cf):
                    z1 = (_minres_smooth(lc, r_cf, n_pre_smooth)
                          if n_pre_smooth > 0 else jnp.zeros_like(r_cf))
                    r1 = (r_cf - _apply(lc, z1) if n_pre_smooth > 0
                          else r_cf)
                    rc = cf.restrict_f2c_cf(nvb, r1, fine_lat, coarse_lat)
                    if level + 1 == n_levels - 1:
                        ec = direct_coarsest(rc)
                    else:
                        ec, _, _ = _fgcr_cf(
                            lambda v: _apply(coeffs[level + 1], v), rc,
                            make_precond(level + 1), inner_tol,
                            inner_max_iter, inner_restart_freq)
                    lhs = z1 + cf.prolong_c2f_cf(nvb, ec, fine_lat,
                                                 coarse_lat)
                    if n_post_smooth > 0:
                        r2 = r_cf - _apply(lc, lhs)
                        lhs = lhs + _minres_smooth(lc, r2, n_post_smooth)
                    return lhs

                return precond

            b_cf = cf.planes_to_cf(b_planes).astype(rdt)
            x, iters, rsq = _fgcr_cf(
                lambda v: _apply(coeffs[0], v), b_cf, make_precond(0),
                tol, max_iter, restart_freq)
            return (cf.cf_to_planes(x), iters,
                    jnp.real(rsq).astype(jnp.float32))

    return solve
