"""U(1) gauge-field toolkit: config I/O, field generation, gauge transforms,
APE smearing, observables (plaquette, topological charge, non-compact
action), instantons, and the non-compact heatbath.

JAX counterpart of reference u1/u1_utils.h:38-757.

Gauge fields here are eo-packed complex arrays of shape (2, 2, Y, X/2):
(mu in {+x,+y}, parity, y, xh) - the reference's LatticeGauge ordering
(README.md:5-13) with nc=1 so the color axes are dropped. Phase fields
(non-compact) use the same shape with real dtype.

Observables and smearing run on device (jnp); file I/O and the
site-sequential heatbath run on host (NumPy; optional C++ fast path in
native/), mirroring the reference's "can't be parallelized as is" comment
(u1/u1_utils.h:633-667).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .lattice import (Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1,
                      eo_pack, eo_unpack)
from .cshift import cshift_pull

__all__ = [
    "read_gauge_u1", "read_phase_u1", "write_gauge_u1", "write_phase_u1",
    "unit_gauge_u1", "rand_gauge_u1", "gauss_gauge_u1", "rand_trans_u1",
    "apply_gauge_trans_u1", "apply_ape_smear_u1", "get_plaquette_u1",
    "get_topo_u1", "get_noncompact_action_u1", "create_instanton_u1",
    "create_noncompact_instanton_u1", "heatbath_noncompact_update",
    "lorentz_gauge_fix_u1",
    "phases_to_links",
]


def _gauge_lat(lat: Lattice2D) -> Lattice2D:
    return lat if lat.nc == 1 else lat.with_nc(1)


# ---------------------------------------------------------------------------
# I/O. Plain-text phase files, one phase per line, x outer / y / mu inner -
# exactly the reference format (u1/u1_utils.h:38-99) so the shipped
# tests/common_cfgs_u1/*.dat fixtures load bit-identically.
# ---------------------------------------------------------------------------

def read_phase_u1(lat: Lattice2D, path: str) -> np.ndarray:
    """Load phases -> (2, 2, Y, Xh) real array."""
    lat = _gauge_lat(lat)
    vals = np.loadtxt(path).reshape(lat.x_len, lat.y_len, 2)
    grid = np.transpose(vals, (2, 1, 0))  # (mu, y, x)
    return np.stack([eo_pack(grid[mu], lat) for mu in range(2)])


def read_gauge_u1(lat: Lattice2D, path: str) -> np.ndarray:
    """Load phases and compactify -> (2, 2, Y, Xh) complex links."""
    return np.exp(1j * read_phase_u1(lat, path))


def write_phase_u1(phases: np.ndarray, lat: Lattice2D, path: str):
    lat = _gauge_lat(lat)
    grids = np.stack([eo_unpack(np.asarray(phases[mu]), lat)
                      for mu in range(2)])  # (mu, y, x)
    vals = np.transpose(grids, (2, 1, 0)).reshape(-1)  # x outer, y, mu inner
    with open(path, "w") as f:
        for v in vals:
            f.write(f"{v:.20f}\n")


def write_gauge_u1(gauge: np.ndarray, lat: Lattice2D, path: str):
    write_phase_u1(np.angle(np.asarray(gauge)), lat, path)


def phases_to_links(phases) -> jnp.ndarray:
    """polar_vector: compactify phases into U(1) links."""
    return jnp.exp(1j * jnp.asarray(phases))


# ---------------------------------------------------------------------------
# Field generation (reference :172-223).
# ---------------------------------------------------------------------------

def unit_gauge_u1(lat: Lattice2D, dtype=jnp.complex128):
    lat = _gauge_lat(lat)
    return jnp.ones((2, 2, lat.y_len, lat.xh), dtype=dtype)


def rand_gauge_u1(lat: Lattice2D, rng) -> np.ndarray:
    """Hot start: uniform phases in (-pi, pi) (reference :185-195)."""
    lat = _gauge_lat(lat)
    ph = rng.uniform((2, 2, lat.y_len, lat.xh), -np.pi, np.pi)
    return np.exp(1j * ph)


def gauss_gauge_u1(lat: Lattice2D, rng, beta: float) -> np.ndarray:
    """Gaussian phases with variance 1/beta (reference :200-223)."""
    lat = _gauge_lat(lat)
    beta = abs(beta)
    if beta == 0:
        return rand_gauge_u1(lat, rng)
    ph = rng.gaussian_real((2, 2, lat.y_len, lat.xh), 1.0 / np.sqrt(beta))
    return np.exp(1j * ph)


def rand_trans_u1(lat: Lattice2D, rng) -> np.ndarray:
    """Random per-site gauge transform g(x) (reference :227-237)."""
    lat = _gauge_lat(lat)
    ph = rng.uniform((2, lat.y_len, lat.xh), -np.pi, np.pi)
    return np.exp(1j * ph)


def apply_gauge_trans_u1(gauge, trans):
    """u_mu(x) -> g(x) u_mu(x) conj(g(x+mu)) (reference :241-272)."""
    gauge = jnp.asarray(gauge)
    trans = jnp.asarray(trans)
    ux = trans * gauge[0] * jnp.conj(cshift_pull(trans, DIR_XP1))
    uy = trans * gauge[1] * jnp.conj(cshift_pull(trans, DIR_YP1))
    return jnp.stack([ux, uy])


# ---------------------------------------------------------------------------
# Observables (reference :386-508).
# ---------------------------------------------------------------------------

def _plaquette_field(gauge):
    """Per-site plaquette U_x(s) U_y(s+x) conj(U_x(s+y)) conj(U_y(s))."""
    gauge = jnp.asarray(gauge)
    ux, uy = gauge[0], gauge[1]
    return (ux * cshift_pull(uy, DIR_XP1)
            * jnp.conj(cshift_pull(ux, DIR_YP1)) * jnp.conj(uy))


def get_plaquette_u1(gauge, lat: Lattice2D):
    """Volume-averaged plaquette (reference get_plaquette_u1, :424-463)."""
    return jnp.sum(_plaquette_field(gauge)) / _gauge_lat(lat).volume


def get_topo_u1(gauge, lat: Lattice2D):
    """Topological charge sum(arg(plaq))/2pi (reference :466-508)."""
    del lat
    return jnp.sum(jnp.angle(_plaquette_field(gauge))) * 0.5 / np.pi


def get_noncompact_action_u1(phases, beta: float, lat: Lattice2D):
    """0.5 beta sum_s (dA)^2 (reference :386-421)."""
    del lat
    phases = jnp.asarray(phases)
    ax, ay = phases[0], phases[1]
    f = (ax + cshift_pull(ay, DIR_XP1) - cshift_pull(ax, DIR_YP1) - ay)
    return 0.5 * beta * jnp.sum(f * f)


# ---------------------------------------------------------------------------
# APE smearing (reference :276-383).
# ---------------------------------------------------------------------------

def apply_ape_smear_u1(gauge, lat: Lattice2D, alpha: float, n_iter: int):
    """APE smear with staple weight alpha, re-unitarized each iteration."""
    del lat
    u = jnp.asarray(gauge)
    for _ in range(n_iter):
        ux, uy = u[0], u[1]
        # x staples.
        up_x = (uy * cshift_pull(ux, DIR_YP1)
                * jnp.conj(cshift_pull(uy, DIR_XP1)))
        uy_ym = cshift_pull(uy, DIR_YM1)  # U_y(s-y)
        dn_x = (jnp.conj(uy_ym) * cshift_pull(ux, DIR_YM1)
                * cshift_pull(uy_ym, DIR_XP1))
        new_x = ux + alpha * (up_x + dn_x)
        # y staples.
        rt_y = (ux * cshift_pull(uy, DIR_XP1)
                * jnp.conj(cshift_pull(ux, DIR_YP1)))
        ux_xm = cshift_pull(ux, DIR_XM1)  # U_x(s-x)
        lf_y = (jnp.conj(ux_xm) * cshift_pull(uy, DIR_XM1)
                * cshift_pull(ux_xm, DIR_YP1))
        new_y = uy + alpha * (rt_y + lf_y)
        u = jnp.stack([new_x, new_y])
        # Re-unitarize (arg then polar, reference :371-372).
        u = jnp.exp(1j * jnp.angle(u))
    return u


# ---------------------------------------------------------------------------
# Lorenz (Landau) gauge fixing. The reference DECLARES this
# (u1_utils.h:511-542, "Go to Lorentz gauge") but ships an empty
# iteration body; implemented here exactly via FFT. Host-side.
# ---------------------------------------------------------------------------

def _backward_divergence(theta_grids):
    """sum_mu [theta_mu(x) - theta_mu(x - mu)] on (2, Y, X) grids."""
    tx, ty = theta_grids
    return (tx - np.roll(tx, 1, axis=1)) + (ty - np.roll(ty, 1, axis=0))


def lorentz_gauge_fix_u1(gauge, lat: Lattice2D, tol: float = 1e-10,
                         max_iter: int = 100):
    """Fix ``gauge`` to Lorenz (Landau) gauge: sum_mu [theta_mu(x) -
    theta_mu(x - mu)] = 0 at every site. Returns (fixed_gauge,
    final_max_abs_divergence).

    The Landau condition is LINEAR in the gauge potential: the transform
    g = exp(i lambda) shifts theta'_mu = theta_mu + lambda(x+mu) -
    lambda(x), so div theta' = div theta + Lap lambda and the exact fix
    is lambda = +Lap^{-1} div theta (the transform convention here is
    u'_mu = g(x) u_mu conj(g(x+mu)), i.e. theta' = theta - grad lambda)
    - a closed-form FFT solve (lattice
    Laplacian eigenvalues -4 sum_mu sin^2(pi k_mu / L_mu), zero mode
    projected; the total divergence telescopes to zero so the system is
    consistent). Compact links re-wrap the principal-branch phases
    after a large transform, so the solve ITERATES to max|div| < tol
    (typically 2-3 passes at beta ~ 6). The reference's ``delta``
    relaxation parameter is unnecessary - the FFT solve is exact per
    pass. (Reference u1_utils.h:511-542, stub.)
    """
    glat = _gauge_lat(lat)
    g = np.asarray(gauge)
    yl, xl = glat.y_len, glat.x_len
    ky = np.arange(yl)
    kx = np.arange(xl)
    lap = -4.0 * (np.sin(np.pi * ky / yl)[:, None] ** 2
                  + np.sin(np.pi * kx / xl)[None, :] ** 2)
    lap[0, 0] = 1.0  # zero mode: projected out below
    resid = np.inf
    for _ in range(max_iter):
        theta = np.stack([eo_unpack(np.angle(g[mu]), glat)
                          for mu in range(2)])
        div = _backward_divergence(theta)
        resid = float(np.max(np.abs(div)))
        if resid < tol:
            break
        lam_hat = np.fft.fft2(div) / lap
        lam_hat[0, 0] = 0.0
        lam = np.real(np.fft.ifft2(lam_hat))
        trans = eo_pack(np.exp(1j * lam), glat)
        g = np.asarray(apply_gauge_trans_u1(g, trans))
    return g, resid


# ---------------------------------------------------------------------------
# Instantons (reference :545-603). Host-side construction.
# ---------------------------------------------------------------------------

def create_instanton_u1(gauge, lat: Lattice2D, q: float, x0: int, y0: int
                        ) -> np.ndarray:
    lat = _gauge_lat(lat)
    xl, yl = lat.x_len, lat.y_len
    g = np.stack([eo_unpack(np.asarray(jnp.asarray(gauge)[mu]), lat)
                  for mu in range(2)])  # (mu, y, x)
    for x in range(xl):
        for y in range(yl):
            rx = x - xl // 2 + 0.5
            ry = y - yl // 2 + 0.5
            xt = (x - xl // 2 + x0 + 3 * xl) % xl
            yt = (y - yl // 2 + y0 + 3 * yl) % yl
            g[0, yt, xt] *= np.exp(1j * q * ry / (rx * rx + ry * ry))
            g[1, yt, xt] *= np.exp(-1j * q * rx / (rx * rx + ry * ry))
    return np.stack([eo_pack(g[mu], lat) for mu in range(2)])


def create_noncompact_instanton_u1(phases, lat: Lattice2D, q: float
                                   ) -> np.ndarray:
    lat = _gauge_lat(lat)
    xl, yl = lat.x_len, lat.y_len
    g = np.stack([eo_unpack(np.asarray(phases[mu]), lat) for mu in range(2)])
    for x in range(xl):
        for y in range(yl):
            g[0, y, x] += -q * np.pi * y / (xl * yl)
            if y == yl - 1:
                g[1, y, x] += q * np.pi * x / xl
    return np.stack([eo_pack(g[mu], lat) for mu in range(2)])


# ---------------------------------------------------------------------------
# Non-compact heatbath (reference :607-757). Exact Gaussian heatbath on
# non-compact phases; site-sequential x-sweep then y-sweep per update, so it
# stays on host (NumPy loop; native/heatbath.cpp provides a C++ fast path).
# ---------------------------------------------------------------------------

def _heatbath_sweeps_numpy(ph, beta: float, n_update: int, rng):
    """ph: (mu, Y, X) phases on the full grid, updated in place."""
    width = np.sqrt(0.5 / beta)
    yl, xl = ph.shape[1], ph.shape[2]
    for _ in range(n_update):
        for x in range(xl):
            xp = (x + 1) % xl
            for y in range(yl):
                yp, ym = (y + 1) % yl, (y - 1) % yl
                staple = (ph[1, y, xp] - ph[0, yp, x] - ph[1, y, x]
                          - ph[1, ym, xp] - ph[0, ym, x] + ph[1, ym, x])
                ph[0, y, x] = rng.normal_scalar(width) - 0.5 * staple
        for x in range(xl):
            xp, xm = (x + 1) % xl, (x - 1) % xl
            for y in range(yl):
                yp = (y + 1) % yl
                staple = (ph[0, yp, x] - ph[1, y, xp] - ph[0, y, x]
                          - ph[0, yp, xm] - ph[1, y, xm] + ph[0, y, xm])
                ph[1, y, x] = rng.normal_scalar(width) - 0.5 * staple
    return ph


def heatbath_noncompact_update(phases, lat: Lattice2D, beta: float,
                               n_update: int, rng) -> np.ndarray:
    """Reference heatbath_noncompact_update (u1/u1_utils.h:607-757).

    phases: (2, 2, Y, Xh) eo-packed real phases. Returns the updated field.
    Uses the C++ fast path from native/ when built, else NumPy.
    """
    lat = _gauge_lat(lat)
    ph = np.stack([eo_unpack(np.asarray(phases[mu]), lat)
                   for mu in range(2)])  # (mu, Y, X)
    from . import native  # local import: optional compiled extension
    from .rng import StdMT19937
    if not native.have_heatbath():
        ph = _heatbath_sweeps_numpy(ph, beta, n_update, rng)
    elif isinstance(rng, StdMT19937):
        # Bit-exact std::mt19937/std::normal_distribution parity mode:
        # the C++ sweep continues the Python object's OWN stream (same
        # engine + polar normal on the shared state, heatbath.cpp),
        # so determinism parity no longer costs native speed
        # (~350x; equality asserted in tests/test_rng.py).
        ph = native.heatbath_sweeps_std(ph, beta, n_update, rng)
    else:
        ph = native.heatbath_sweeps(ph, beta, n_update, rng)
    return np.stack([eo_pack(ph[mu], lat) for mu in range(2)])
