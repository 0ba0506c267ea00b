"""2D staggered Dslash, Nc=1.

JAX counterpart of reference operators/staggered.h:21-259.
Hopping-only stencil (mass carried in ``shift``): hopping_{+-x} =
-+ U_x / conj-pulled, hopping_{+-y} with the eta_y(x) = (-1)^x phase
(reference staggered_set_eta_y, :253-259).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality, apply_hopping_half)


def _staggered_hopping(lat: Lattice2D, gauge, dtype):
    gauge = jnp.asarray(gauge, dtype=dtype)
    ux, uy = gauge[0], gauge[1]
    # eta_y(x) = 1 - 2*(x % 2) over the eo-packed layout.
    eta = jnp.asarray(1.0 - 2.0 * (lat.x_coord_grid() % 2), dtype=dtype)
    hop = jnp.stack([
        -0.5 * ux,
        -0.5 * eta * uy,
        0.5 * jnp.conj(cshift_pull(ux, DIR_XM1)),
        0.5 * eta * jnp.conj(cshift_pull(uy, DIR_YM1)),
    ])
    return hop[..., None, None]


class Staggered2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, dtype=jnp.complex128):
        assert lat.nc == 1, "Staggered2D only supports Nc = 1"
        self._dtype = dtype
        hopping = _staggered_hopping(lat, gauge, dtype)
        super().__init__(make_coeffs(lat, clover=None, hopping=hopping,
                                     shift=mass, dtype=dtype))

    def update_links(self, gauge):
        self.update_coeffs(hopping=_staggered_hopping(self.lat, gauge,
                                                      self._dtype))

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """epsilon(x) = +1 on even, -1 on odd sites (reference :140-149)."""
        return jnp.stack([x[0], -x[1]])

    def chiral_projection(self, x, is_up: bool):
        """Chirality = parity halves (reference :152-181)."""
        zero = jnp.zeros_like(x[0])
        return jnp.stack([x[0], zero]) if is_up else jnp.stack([zero, x[1]])

    # --- custom eo-Schur trio (reference :188-240) ---
    def prepare_b(self, b):
        """b' = m b_e - D_eo b_o (reference :190-202)."""
        deo_bo = apply_hopping_half(self.coeffs, b[1], src_parity=1)
        return self.coeffs.shift * b[0] - deo_bo

    def apply_eo_prec_M(self, x_even):
        """(m^2 - D_eo D_oe) x_e (reference :206-224)."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        t_even = apply_hopping_half(self.coeffs, t_odd, src_parity=1)
        m = self.coeffs.shift
        return m * m * x_even - t_even

    def reconstruct_x(self, x_even, b):
        """x_o = (b_o - D_oe x_e)/m (reference :228-240)."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        x_odd = (b[1] - t_odd) / self.coeffs.shift
        return jnp.stack([x_even, x_odd])
