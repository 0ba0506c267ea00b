"""Channels-first real-pair ("cf") arithmetic for huge fine lattices.

A compiler that tiles the two minor dimensions of a buffer pads
complex temporaries whose minor dims are the size-2 real/imag or parity
axes or a small nc. This module removes complex buffers from the
program entirely: every field is a real array with the real/imag pair
as the LEADING axis and the lattice (Y, Xh) axes LAST, so the default
row-major layout puts the large lattice axes minor and the layout
heuristic has nothing to decide. bench.py selects it for the device
setup at >= 2048^2; whether it pays on the GPU is not measured yet
(ROADMAP "Speed"). Complex arithmetic is written out over the leading
pair; complex *scalars* (solver coefficients) stay ordinary 0-d complex
arrays - scalars never hit the tiled-layout path.

Layouts (mirroring the standard complex layouts in lattice.py):

    field    (2ri, 2p, nc, Y, Xh)      <- complex (2p, Y, Xh, nc)
    gauge mu (2ri, 2p, Y, Xh)          <- complex (2p, Y, Xh)
    blocked  (2ri, [nvec,] 2c, B, Yc, Xhc)
                                       <- complex ([nvec,] 2c, Yc, Xhc, B)
    coarse   (2ri, 2c, ncc, Yc, Xhc)   <- complex (2c, Yc, Xhc, ncc)
    coarse mat (2ri, 2c, no, ni, Yc, Xhc)

Used by the fine-level stage of the device-resident setup
(setup_planes.make_kcycle_setup_planes(channels_first=True)); the
outputs convert back to the standard planes-state formats at the stage
boundary, where the buffer sizes are coarse-level (known-good).

Reference semantics reproduced: cshift/cshift_2d.h:45-236 (shifts),
operators/wilson.h:179-209 (spin structure), transfer/transfer.h
(blocking + block ortho), operators/coarse.h:137-444 (Galerkin probes),
tests/n13_wilson_kcycle/wilson_kcycle.cpp:338-384 (null-vector flow).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .lattice import Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1

__all__ = [
    "field_to_cf", "field_from_cf", "cvdot", "cnorm2", "caxpy", "csmul",
    "cshift_cf", "wilson_phases_cf", "wilson_apply_cf",
    "bicgstab_l_cf", "orthogonal_cf", "normalize_cf",
]


# ---------------------------------------------------------------------------
# Complex-pair primitives. The ri axis is LEADING (axis 0) unless the
# ``axis`` argument says otherwise (stacked Krylov bases put a stacking
# axis in front, making ri axis 1).
# ---------------------------------------------------------------------------


def field_to_cf(x):
    """complex (2p, Y, Xh, nc) -> cf (2, 2p, nc, Y, Xh)."""
    x = jnp.asarray(x)
    re, im = jnp.real(x), jnp.imag(x)
    return jnp.stack([re, im]).transpose(0, 1, 4, 2, 3)


def field_from_cf(xcf, dtype=jnp.complex64):
    """cf (2, 2p, nc, Y, Xh) -> complex (2p, Y, Xh, nc)."""
    z = xcf.transpose(0, 1, 3, 4, 2)
    return jax.lax.complex(z[0], z[1]).astype(dtype)


def planes_to_cf(p):
    """planes (2p, Y, Xh, nc, 2) f32 -> cf (2, 2p, nc, Y, Xh)."""
    return jnp.moveaxis(p, (4, 3), (0, 2))


def cf_to_planes(xcf):
    """cf (2, 2p, nc, Y, Xh) -> planes (2p, Y, Xh, nc, 2) f32."""
    return jnp.moveaxis(xcf, (0, 2), (4, 3))


def _take2(v, axis):
    return jnp.take(v, 0, axis), jnp.take(v, 1, axis)


def cvdot(x, y, axis=0):
    """<x, y> = sum conj(x) y -> 0-d complex."""
    xr, xi = _take2(x, axis)
    yr, yi = _take2(y, axis)
    re = jnp.sum(xr * yr + xi * yi)
    im = jnp.sum(xr * yi - xi * yr)
    return jax.lax.complex(re, im)


def cnorm2(x):
    """||x||^2 -> 0-d real."""
    return jnp.sum(x * x)


def csmul(alpha, v, axis=0):
    """alpha * v for a complex scalar alpha."""
    ar, ai = jnp.real(alpha), jnp.imag(alpha)
    vr, vi = _take2(v, axis)
    return jnp.stack([ar * vr - ai * vi, ar * vi + ai * vr], axis=axis)


def caxpy(alpha, x, y, axis=0):
    """y + alpha * x for a complex scalar alpha."""
    return y + csmul(alpha, x, axis=axis)


def orthogonal_cf(v, w):
    """v - (<w, v>/<w, w>) w (linalg.orthogonal in cf form)."""
    g = cvdot(w, v) / cnorm2(w)
    return caxpy(-g, w, v)


def normalize_cf(v):
    return v / jnp.sqrt(cnorm2(v))


# ---------------------------------------------------------------------------
# cshift in cf layout: parity axis 1, Y = -2, Xh = -1 (works for any
# number of inner dof axes between).
# ---------------------------------------------------------------------------


def _row_mask_cf(y_len: int, q: int):
    return ((jnp.arange(y_len) % 2) == (q % 2)).reshape(y_len, 1)


def _pull_x_half_cf(src, q: int, sign: int):
    """src (..., Y, Xh) on parity 1-q -> pulled values on parity-q slots
    (mirror of cshift._pull_x_half with trailing lattice axes)."""
    y_len = src.shape[-2]
    if sign > 0:
        rolled = jnp.roll(src, -1, axis=-1)
        direct = _row_mask_cf(y_len, q)
    else:
        rolled = jnp.roll(src, 1, axis=-1)
        direct = _row_mask_cf(y_len, 1 - q)
    return jnp.where(direct, src, rolled)


def cshift_cf(field, direction: int):
    """Pull-shift in cf layout: field (2ri, 2p, ..., Y, Xh)."""
    if direction == DIR_YP1:
        return jnp.roll(field[:, ::-1], -1, axis=-2)
    if direction == DIR_YM1:
        return jnp.roll(field[:, ::-1], 1, axis=-2)
    if direction == DIR_XP1:
        return jnp.stack([
            _pull_x_half_cf(field[:, 1], 0, +1),
            _pull_x_half_cf(field[:, 0], 1, +1)], axis=1)
    if direction == DIR_XM1:
        return jnp.stack([
            _pull_x_half_cf(field[:, 1], 0, -1),
            _pull_x_half_cf(field[:, 0], 1, -1)], axis=1)
    raise ValueError(f"unsupported cshift direction {direction}")


# ---------------------------------------------------------------------------
# Wilson fine operator in phase form (operators/wilson.h:179-209): the
# hopping term is (per-site U(1) phase) x (constant 2x2 spin matrix), so
# the apply streams only x and 4 phase fields - no materialized hopping.
# ---------------------------------------------------------------------------


def wilson_phases_cf(gauge_cf):
    """gauge_cf (2, 2mu, 2p, Y, Xh) -> phases (2, 4dir, 2p, Y, Xh):
    [U_x(s), U_y(s), conj U_x(s-x), conj U_y(s-y)] per site (the
    reference's link layout after the cshift_pull of wilson.py:43-44)."""
    ux = gauge_cf[:, 0]
    uy = gauge_cf[:, 1]
    ux_m = cshift_cf(ux, DIR_XM1)
    uy_m = cshift_cf(uy, DIR_YM1)
    conj = jnp.array([1.0, -1.0], gauge_cf.dtype).reshape(2, 1, 1, 1)
    return jnp.stack([ux, uy, conj * ux_m, conj * uy_m], axis=1)


def _phase_mul(u, t):
    """(per-site complex phase u (2, 2p, Y, Xh)) * (field t
    (2, 2p, nc, Y, Xh)) -> cf field."""
    ur = u[0][:, None]
    ui = u[1][:, None]
    return jnp.stack([ur * t[0] - ui * t[1], ur * t[1] + ui * t[0]])


def _spin_xp(t, w):
    """0.5 [[-w, 1], [1, -w]] on spin (real matrix: same action on re/im).
    t (2, 2p, 2s, Y, Xh)."""
    t0, t1 = t[:, :, 0], t[:, :, 1]
    return 0.5 * jnp.stack([t1 - w * t0, t0 - w * t1], axis=2)


def _spin_xm(t, w):
    """0.5 [[-w, -1], [-1, -w]]."""
    t0, t1 = t[:, :, 0], t[:, :, 1]
    return -0.5 * jnp.stack([w * t0 + t1, t0 + w * t1], axis=2)


def _spin_yp(t, w):
    """0.5 [[-w, -i], [i, -w]]: out0 = -w t0 - i t1, out1 = i t0 - w t1."""
    t0r, t1r = t[0, :, 0], t[0, :, 1]
    t0i, t1i = t[1, :, 0], t[1, :, 1]
    out0 = jnp.stack([-w * t0r + t1i, -w * t0i - t1r])
    out1 = jnp.stack([-t0i - w * t1r, t0r - w * t1i])
    return 0.5 * jnp.stack([out0, out1], axis=2)


def _spin_ym(t, w):
    """0.5 [[-w, i], [-i, -w]]: out0 = -w t0 + i t1, out1 = -i t0 - w t1."""
    t0r, t1r = t[0, :, 0], t[0, :, 1]
    t0i, t1i = t[1, :, 0], t[1, :, 1]
    out0 = jnp.stack([-w * t0r - t1i, -w * t0i + t1r])
    out1 = jnp.stack([t0i - w * t1r, -t0r - w * t1i])
    return 0.5 * jnp.stack([out0, out1], axis=2)


_SPIN_FNS = {DIR_XP1: _spin_xp, DIR_YP1: _spin_yp,
             DIR_XM1: _spin_xm, DIR_YM1: _spin_ym}


def wilson_hop_dir_cf(phases_cf, x_cf, direction: int, w: float = 1.0):
    """One direction's hopping term: S_d (U_d . pull_d(x))."""
    idx = {DIR_XP1: 0, DIR_YP1: 1, DIR_XM1: 2, DIR_YM1: 3}[direction]
    t = cshift_cf(x_cf, direction)
    t = _phase_mul(phases_cf[:, idx], t)
    return _SPIN_FNS[direction](t, w)


def wilson_hopping_cf(phases_cf, x_cf, w: float = 1.0):
    out = wilson_hop_dir_cf(phases_cf, x_cf, DIR_XP1, w)
    for d in (DIR_YP1, DIR_XM1, DIR_YM1):
        out = out + wilson_hop_dir_cf(phases_cf, x_cf, d, w)
    return out


def wilson_apply_cf(phases_cf, x_cf, mass: float, w: float = 1.0):
    """Full Wilson M x = (2w + mass) x + hopping terms (the clover is
    2w I and the shift is the mass, wilson.py:41,88)."""
    return (2.0 * w + mass) * x_cf + wilson_hopping_cf(phases_cf, x_cf, w)


# ---------------------------------------------------------------------------
# BiCGstab(l) on cf vectors - a literal port of solvers.bicgstab_l with
# the scalar-vector algebra routed through the pair primitives. The
# stacked Krylov bases rs/us put the stack axis FIRST, so their ri axis
# is 1 (``axis=1`` in the helpers).
# ---------------------------------------------------------------------------


def bicgstab_l_cf(matvec, b, max_iter: int = 1000, tol=1e-8, l: int = 6):
    """Returns (x, iters, rsq, converged) - SolveResult fields without
    the complex-array wrapper. Trajectory-identical to
    solvers.bicgstab_l (same update order; rounding-level differences
    only), reference n13:359."""
    cdt = jnp.complex64 if b.dtype == jnp.float32 else jnp.complex128
    rdt = b.dtype
    bsq = cnorm2(b)
    target = jnp.asarray(tol, rdt) ** 2 * bsq
    x0 = jnp.zeros_like(b)

    r0 = b - matvec(x0)
    rtilde = r0
    max_cycles = max(int(max_iter) // max(l, 1), 1)

    def cond(s):
        x, rs, us, rho0, alpha, omega, rsq, k = s
        return jnp.logical_and(jnp.isfinite(rsq),
                               jnp.logical_and(k < max_cycles,
                                               rsq > target))

    def body(s):
        x, rs, us, rho0, alpha, omega, rsq, k = s
        rho0 = -omega * rho0
        for j in range(l):
            rho1 = cvdot(rtilde, rs[j])
            beta = alpha * rho1 / rho0
            rho0 = rho1
            us = us.at[:j + 1].set(rs[:j + 1]
                                   - csmul(beta, us[:j + 1], axis=1))
            us = us.at[j + 1].set(matvec(us[j]))
            gamma_c = cvdot(rtilde, us[j + 1])
            alpha = rho0 / gamma_c
            rs = rs.at[:j + 1].set(rs[:j + 1]
                                   - csmul(alpha, us[1:j + 2], axis=1))
            rs = rs.at[j + 1].set(matvec(rs[j]))
            x = caxpy(alpha, us[0], x)
        tau = jnp.zeros((l + 1, l + 1), dtype=cdt)
        sigma = jnp.zeros((l + 1,), dtype=rdt)
        gamma_p = jnp.zeros((l + 1,), dtype=cdt)
        for j in range(1, l + 1):
            for i in range(1, j):
                t_ij = cvdot(rs[i], rs[j]) / sigma[i]
                tau = tau.at[i, j].set(t_ij)
                rs = rs.at[j].add(-csmul(t_ij, rs[i]))
            sigma = sigma.at[j].set(cnorm2(rs[j]))
            gamma_p = gamma_p.at[j].set(cvdot(rs[j], rs[0]) / sigma[j])
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
        x = caxpy(gamma[1], rs[0], x)
        rs = rs.at[0].add(-csmul(gamma_p[l], rs[l]))
        us = us.at[0].add(-csmul(gamma[l], us[l]))
        for j in range(1, l):
            us = us.at[0].add(-csmul(gamma[j], us[j]))
            x = caxpy(gamma_pp[j], rs[j], x)
            rs = rs.at[0].add(-csmul(gamma_p[j], rs[j]))
        omega = gamma[l]
        return (x, rs, us, rho0, alpha, omega, cnorm2(rs[0]), k + 1)

    rs0 = jnp.zeros((l + 1,) + b.shape, dtype=rdt).at[0].set(r0)
    us0 = jnp.zeros((l + 1,) + b.shape, dtype=rdt)
    one = jnp.ones((), dtype=cdt)
    state0 = (x0, rs0, us0, one, jnp.zeros((), dtype=cdt), one,
              cnorm2(r0), jnp.zeros((), jnp.int32))
    x, rs, us, rho0, alpha, omega, rsq, k = jax.lax.while_loop(
        cond, body, state0)
    return x, k * l, rsq, rsq <= target


# ---------------------------------------------------------------------------
# Blocking (transfer.py:_to_blocked in cf form) + block ortho + the
# restrict/prolong einsums. Blocked cf layout: (2ri, 2c, B, Yc, Xhc);
# the b axis ordering (parity-major, then y, then xh, then color)
# matches transfer.py:187-215 exactly.
# ---------------------------------------------------------------------------


def to_blocked_cf(x_cf, fine_lat: Lattice2D, coarse_lat: Lattice2D):
    by = fine_lat.y_len // coarse_lat.y_len
    bx = fine_lat.x_len // coarse_lat.x_len
    if bx % 2:
        raise ValueError("cf blocking requires an even x block")
    bxh = bx // 2
    yc, xc = coarse_lat.y_len, coarse_lat.x_len
    nc = fine_lat.nc
    z = x_cf.reshape(2, 2, nc, yc, by, xc, bxh)
    z = z.transpose(0, 3, 5, 1, 4, 6, 2)     # (r, yc, xc, p, by, bxh, nc)
    z = z.reshape(2, yc, xc, 2 * by * bxh * nc)
    zp = z.reshape(2, yc, coarse_lat.xh, 2, -1)
    row_odd = (jnp.arange(yc) % 2).astype(bool).reshape(yc, 1, 1)
    even = jnp.where(row_odd, zp[:, :, :, 1], zp[:, :, :, 0])
    odd = jnp.where(row_odd, zp[:, :, :, 0], zp[:, :, :, 1])
    blocked = jnp.stack([even, odd], axis=1)  # (r, 2c, yc, xhc, B)
    return jnp.moveaxis(blocked, -1, 2)       # (r, 2c, B, yc, xhc)


def from_blocked_cf(blocked, fine_lat: Lattice2D, coarse_lat: Lattice2D):
    by = fine_lat.y_len // coarse_lat.y_len
    bx = fine_lat.x_len // coarse_lat.x_len
    bxh = bx // 2
    yc, xc = coarse_lat.y_len, coarse_lat.x_len
    nc = fine_lat.nc
    z = jnp.moveaxis(blocked, 2, -1)          # (r, 2c, yc, xhc, B)
    row_odd = (jnp.arange(yc) % 2).astype(bool).reshape(yc, 1, 1)
    k0 = jnp.where(row_odd, z[:, 1], z[:, 0])
    k1 = jnp.where(row_odd, z[:, 0], z[:, 1])
    z = jnp.stack([k0, k1], axis=3).reshape(2, yc, xc, -1)
    z = z.reshape(2, yc, xc, 2, by, bxh, nc)
    z = z.transpose(0, 3, 6, 1, 4, 2, 5)      # (r, p, nc, yc, by, xc, bxh)
    return z.reshape(2, 2, nc, fine_lat.y_len, fine_lat.xh)


def _bdot_cf(a, b):
    """Per-site <a, b> over the block axis: a, b (2, 2c, B, Yc, Xhc) ->
    (2, 2c, Yc, Xhc) complex-pair site scalars."""
    re = jnp.sum(a[0] * b[0] + a[1] * b[1], axis=1)
    im = jnp.sum(a[0] * b[1] - a[1] * b[0], axis=1)
    return jnp.stack([re, im])


def _site_smul_cf(g, v):
    """(per-site complex scalar g (2, 2c, Yc, Xhc)) * (blocked v
    (2, 2c, B, Yc, Xhc))."""
    gr = g[0][:, None]
    gi = g[1][:, None]
    return jnp.stack([gr * v[0] - gi * v[1], gr * v[1] + gi * v[0]])


def block_orthonormalize_cf(nvb):
    """transfer._block_orthonormalize in cf (no decomposition capture):
    nvb (2, nvec, 2c, B, Yc, Xhc) -> same, per-block orthonormal."""
    nvec = nvb.shape[1]
    vs = [nvb[:, i] for i in range(nvec)]
    for i in range(nvec):
        for j in range(i):
            g = _bdot_cf(vs[j], vs[i])
            vs[i] = vs[i] - _site_smul_cf(g, vs[j])
        nrm = jnp.sqrt(jnp.sum(vs[i] * vs[i], axis=(0, 2)))
        vs[i] = vs[i] / nrm[None, :, None]
    return jnp.stack(vs, axis=1)


def restrict_f2c_cf(nvb, fine_cf, fine_lat, coarse_lat):
    """coarse[v] = sum_b conj(NV[v]) fine[b] -> (2, 2c, nvec, Yc, Xhc)."""
    fb = to_blocked_cf(fine_cf, fine_lat, coarse_lat)
    re = (jnp.einsum("vcbyx,cbyx->cvyx", nvb[0], fb[0])
          + jnp.einsum("vcbyx,cbyx->cvyx", nvb[1], fb[1]))
    im = (jnp.einsum("vcbyx,cbyx->cvyx", nvb[0], fb[1])
          - jnp.einsum("vcbyx,cbyx->cvyx", nvb[1], fb[0]))
    return jnp.stack([re, im])


def prolong_c2f_cf(nvb, coarse_cf, fine_lat, coarse_lat):
    """fine[b] = sum_v NV[v, b] coarse[v] (no conj)."""
    re = (jnp.einsum("vcbyx,cvyx->cbyx", nvb[0], coarse_cf[0])
          - jnp.einsum("vcbyx,cvyx->cbyx", nvb[1], coarse_cf[1]))
    im = (jnp.einsum("vcbyx,cvyx->cbyx", nvb[0], coarse_cf[1])
          + jnp.einsum("vcbyx,cvyx->cbyx", nvb[1], coarse_cf[0]))
    return from_blocked_cf(jnp.stack([re, im]), fine_lat, coarse_lat)


# ---------------------------------------------------------------------------
# Matrix-coefficient stencils in cf (the coarse levels): per-site
# clover/hopping matmuls as 4 real einsums, with the three scalar
# shifts (shift, eo_shift, dof_shift) applied as in stencil.apply_shift.
# ---------------------------------------------------------------------------


def mat_planes_to_cf(p):
    """clover planes (2p, Y, Xh, no, ni, 2) -> (2, 2p, no, ni, Y, Xh)."""
    return jnp.moveaxis(p, (5, 3, 4), (0, 2, 3))


def hop_planes_to_cf(p):
    """hopping planes (4, 2p, Y, Xh, no, ni, 2) ->
    (2, 4, 2p, no, ni, Y, Xh)."""
    return jnp.moveaxis(p, (6, 4, 5), (0, 3, 4))


def site_matvec_cf(m, x):
    """Per-site complex matmul: m (2, 2p, no, ni, Y, Xh) x
    (2, 2p, ni, Y, Xh) -> (2, 2p, no, Y, Xh)."""
    re = (jnp.einsum("pijyx,pjyx->piyx", m[0], x[0])
          - jnp.einsum("pijyx,pjyx->piyx", m[1], x[1]))
    im = (jnp.einsum("pijyx,pjyx->piyx", m[0], x[1])
          + jnp.einsum("pijyx,pjyx->piyx", m[1], x[0]))
    return jnp.stack([re, im])


def _pair_smul(pair, v):
    """(complex scalar as a (2,) pair) * cf array."""
    return jnp.stack([pair[0] * v[0] - pair[1] * v[1],
                      pair[0] * v[1] + pair[1] * v[0]])


def apply_shift_cf(shifts, x):
    """stencil.apply_shift in cf: shifts (2, 3) pair-scalars
    [shift, eo_shift, dof_shift]; x (2, 2p, nc, Y, Xh)."""
    nc = x.shape[2]
    even = _pair_smul(shifts[:, 0] + shifts[:, 1], x[:, 0])
    odd = _pair_smul(shifts[:, 0] - shifts[:, 1], x[:, 1])
    out = jnp.stack([even, odd], axis=1)
    half = nc // 2
    if nc % 2 == 0:
        sign = jnp.concatenate([jnp.ones((half,), x.dtype),
                                -jnp.ones((half,), x.dtype)])
        out = out + _pair_smul(shifts[:, 2],
                               x * sign[None, None, :, None, None])
    return out


def stencil_apply_cf(clover_cf, hopping_cf, shifts, x_cf):
    """Full M x for a matrix-coefficient stencil in cf
    (stencil.apply_M semantics, reference stencil_2d.h:912-936)."""
    out = apply_shift_cf(shifts, x_cf)
    if clover_cf is not None:
        out = out + site_matvec_cf(clover_cf, x_cf)
    for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
        out = out + site_matvec_cf(hopping_cf[:, d], cshift_cf(x_cf, d))
    return out


# ---------------------------------------------------------------------------
# Galerkin coarse build by probing (the cf form of
# operators/coarse.build_coarse_coeffs; reference operators/coarse.h:
# 137-444). ``hop_dir_apply(x_cf, d)`` applies one fine hopping
# direction; ``clover_apply`` the fine clover - or pass ``clover_init``
# when the fine clover's coarse image is known exactly (Wilson: the
# scalar 2w I, whose image through orthonormal blocks is 2w I).
# ---------------------------------------------------------------------------


def galerkin_cf(nvb, hop_dir_apply, fine_lat: Lattice2D,
                coarse_lat: Lattice2D, clover_apply=None,
                clover_init=None, chunk: int = 2):
    """Returns (clover_cf, hopping_cf): clover (2, 2c, row, col, Yc,
    Xhc), hopping (2, 4, 2c, row, col, Yc, Xhc). ``nvb`` is the
    block-orthonormalized cf null-vector tensor."""
    if coarse_lat.volume == 1 or coarse_lat.get_dim_mu(0) == 1 \
            or coarse_lat.get_dim_mu(1) == 1:
        raise ValueError(
            "cf Galerkin build does not fold point/line coarse "
            "lattices (use the standard path at these sizes)")
    ncc = coarse_lat.nc
    yc, xhc = coarse_lat.y_len, coarse_lat.xh
    dt = nvb.dtype
    clover = (clover_init if clover_init is not None
              else jnp.zeros((2, 2, ncc, ncc, yc, xhc), dtype=dt))
    hopping = jnp.zeros((2, 4, 2, ncc, ncc, yc, xhc), dtype=dt)

    colors = jnp.arange(ncc)
    _big = fine_lat.volume * fine_lat.nc >= (1 << 20)

    def _map_colors(fn):
        if _big:
            return jax.lax.map(fn, colors, batch_size=chunk)
        return jax.vmap(fn)(colors)

    if clover_apply is not None:
        def clover_probe(color):
            probe = jnp.zeros((2, 2, ncc, yc, xhc), dtype=dt)
            probe = probe.at[0, :, color].set(1.0)
            fine = prolong_c2f_cf(nvb, probe, fine_lat, coarse_lat)
            return restrict_f2c_cf(nvb, clover_apply(fine), fine_lat,
                                   coarse_lat)

        res = _map_colors(clover_probe)
        clover = clover + jnp.moveaxis(res, 0, 3)

    for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
        for parity in (0, 1):
            def hop_dir_probe(color, parity=parity, d=d):
                probe = jnp.zeros((2, 2, ncc, yc, xhc), dtype=dt)
                probe = probe.at[0, parity, color].set(1.0)
                fine = prolong_c2f_cf(nvb, probe, fine_lat, coarse_lat)
                afine = hop_dir_apply(fine, d)
                return restrict_f2c_cf(nvb, afine, fine_lat, coarse_lat)

            res = _map_colors(hop_dir_probe)  # (col, 2, 2c, row, Yc, Xhc)
            res = jnp.moveaxis(res, 0, 3)     # (2, 2c, row, col, Yc, Xhc)
            clover = clover.at[:, parity].add(res[:, parity])
            other = 1 - parity
            hopping = hopping.at[:, d, other].add(res[:, other])

    return clover, hopping


def level_outputs_cf(matvec, hop_dir_apply, gauss_cf,
                     fine_lat: Lattice2D, coarse_lat: Lattice2D,
                     nullvec_max_iter: int, nullvec_tol,
                     clover_apply=None, clover_init=None,
                     chunk: int = 2):
    """One whole n13 setup stage in cf arithmetic: null-vector
    BiCGstab(l) solves -> orthogonalize -> chiral double -> block +
    double block-ortho -> Galerkin coarse build (reference n13:338-384
    + transfer/coarse construction).

    ``gauss_cf``: (n_half, 2, 2p, nc, Y, Xh) gaussian seeds. Returns
    (nvb_cf, clover_cf, hopping_cf) in cf layouts. The chiral doubling
    rule (zero the bottom/top dof half, normalize) covers both the
    Wilson fine level (gamma5 = diag(1, -1) on spin) and the coarse
    levels (gamma5 = sign flip on the dof halves).
    """
    n_half = gauss_cf.shape[0]
    vecs = []
    for k in range(n_half):
        g = gauss_cf[k]
        for v in vecs:
            g = orthogonal_cf(g, v)
        rhs = -matvec(g)
        x, _, _, _ = bicgstab_l_cf(matvec, rhs,
                                   max_iter=nullvec_max_iter,
                                   tol=nullvec_tol)
        v = g + x
        for wv in vecs:
            v = orthogonal_cf(v, wv)
        vecs.append(v)
    half = fine_lat.nc // 2
    ups = [normalize_cf(v.at[:, :, half:].set(0.0)) for v in vecs]
    downs = [normalize_cf(v.at[:, :, :half].set(0.0)) for v in vecs]
    nvb = jnp.stack([to_blocked_cf(v, fine_lat, coarse_lat)
                     for v in ups + downs], axis=1)
    nvb = block_orthonormalize_cf(nvb)
    nvb = block_orthonormalize_cf(nvb)
    clover_c, hopping_c = galerkin_cf(
        nvb, hop_dir_apply, fine_lat, coarse_lat,
        clover_apply=clover_apply, clover_init=clover_init, chunk=chunk)
    return nvb, clover_c, hopping_c
