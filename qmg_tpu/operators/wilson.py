"""2D Wilson-Dirac operator, Nc=2 (spin (x) U(1)).

JAX counterpart of reference operators/wilson.h:19-229.

Spin structure per direction (reference update_links, :179-209)::

    clover        = 2w * I
    hopping_{+x}  = 0.5 [[-w,  1], [ 1, -w]] U_x(s)
    hopping_{+y}  = 0.5 [[-w, -i], [ i, -w]] U_y(s)
    hopping_{-x}  = 0.5 [[-w, -1], [-1, -w]] conj(U_x(s-x))
    hopping_{-y}  = 0.5 [[-w,  i], [-i, -w]] conj(U_y(s-y))

mass in ``shift``; gamma5 = diag(1, -1); chirality = spin components.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality)
from .. import linalg


def wilson_spin_matrices(w: float, dtype):
    """The four 2x2 spin projectors of the 2D Wilson hopping term."""
    i = 1j
    sx_p = 0.5 * jnp.array([[-w, 1], [1, -w]], dtype=dtype)
    sy_p = 0.5 * jnp.array([[-w, -i], [i, -w]], dtype=dtype)
    sx_m = 0.5 * jnp.array([[-w, -1], [-1, -w]], dtype=dtype)
    sy_m = 0.5 * jnp.array([[-w, i], [-i, -w]], dtype=dtype)
    return sx_p, sy_p, sx_m, sy_m


def _wilson_coeff_arrays(lat: Lattice2D, gauge, w: float, dtype):
    gauge = jnp.asarray(gauge, dtype=dtype)
    ux, uy = gauge[0], gauge[1]
    sx_p, sy_p, sx_m, sy_m = wilson_spin_matrices(w, dtype)
    clover = 2.0 * w * linalg.identity_like(
        jnp.zeros(lat.cm_shape(), dtype=dtype))
    ux_m = jnp.conj(cshift_pull(ux, DIR_XM1))
    uy_m = jnp.conj(cshift_pull(uy, DIR_YM1))
    hopping = jnp.stack([
        ux[..., None, None] * sx_p,
        uy[..., None, None] * sy_p,
        ux_m[..., None, None] * sx_m,
        uy_m[..., None, None] * sy_m,
    ])
    return clover, hopping


def wilson_coeffs_numpy(lat: Lattice2D, gauge_eo, w: float = 1.0):
    """Host-side (pure NumPy) Wilson coefficient build. Returns (clover,
    hopping) complex128 ndarrays in the standard layouts."""
    import numpy as np
    from ..lattice import eo_pack, eo_unpack
    g = np.stack([eo_unpack(np.asarray(gauge_eo[mu]), lat.with_nc(1))
                  for mu in range(2)])  # (mu, Y, X)
    ux, uy = g[0], g[1]
    ux_m = np.conj(np.roll(ux, 1, axis=1))
    uy_m = np.conj(np.roll(uy, 1, axis=0))
    i = 1j
    spin = [0.5 * np.array(m) for m in (
        [[-w, 1], [1, -w]], [[-w, -i], [i, -w]],
        [[-w, -1], [-1, -w]], [[-w, i], [-i, -w]])]
    hopping_grid = np.stack([u[..., None, None] * s for u, s in
                             zip((ux, uy, ux_m, uy_m), spin)])
    hopping = np.stack([eo_pack(hopping_grid[d], lat.with_nc(1))
                        for d in range(4)])
    clover = np.zeros((2, lat.y_len, lat.xh, 2, 2), dtype=np.complex128)
    clover[..., 0, 0] = 2.0 * w
    clover[..., 1, 1] = 2.0 * w
    return clover, hopping


class Wilson2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, wilson_coeff: float = 1.0,
                 dtype=jnp.complex128):
        assert lat.nc == 2, "Wilson2D only supports Nc = 2"
        self._dtype = dtype
        self.wilson_coeff = wilson_coeff
        clover, hopping = _wilson_coeff_arrays(lat, gauge, wilson_coeff,
                                               dtype)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=mass, dtype=dtype))

    def update_links(self, gauge):
        clover, hopping = _wilson_coeff_arrays(self.lat, gauge,
                                               self.wilson_coeff, self._dtype)
        self.update_coeffs(clover=clover, hopping=hopping)

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 2

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """diag(1, -1) on spin (reference :74-93)."""
        return jnp.asarray(x).at[..., 1].multiply(-1.0)

    def sigma1(self, x):
        """Spin swap (reference :128-143)."""
        return x[..., ::-1]

    def chiral_projection(self, x, is_up: bool):
        """Spin-component projection (reference :96-125)."""
        if is_up:
            return x.at[..., 1].set(0.0)
        return x.at[..., 0].set(0.0)
