"""Free and U(1)-gauged 2D Laplace operators.

JAX counterparts of the reference FreeLaplace2D
(tests/n02_free_laplace_test/free_laplace.h:18-42) and GaugedLaplace2D
(operators/gaugedlaplace.h:18-213).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality, apply_hopping_half)
from .. import linalg


def _u1_hopping(gauge, scale, dtype):
    """Common nc=1 hopping build: forward links scaled, backward links are
    pulled-and-conjugated forward links (the cshift+conj pattern of
    operators/gaugedlaplace.h:55-68)."""
    gauge = jnp.asarray(gauge, dtype=dtype)
    ux, uy = gauge[0], gauge[1]
    hop = jnp.stack([
        scale[0] * ux,
        scale[1] * uy,
        scale[2] * jnp.conj(cshift_pull(ux, DIR_XM1)),
        scale[3] * jnp.conj(cshift_pull(uy, DIR_YM1)),
    ])
    return hop[..., None, None]  # add (nc=1, nc=1) axes


class FreeLaplace2D(Stencil2D):
    """Free Laplace: clover = 4 + m^2 shift, hopping = -1
    (reference tests/n02_free_laplace_test/free_laplace.h:18-42)."""

    def __init__(self, lat: Lattice2D, mass_sq, dtype=jnp.complex128):
        assert lat.nc == 1, "FreeLaplace2D only supports Nc = 1"
        clover = 4.0 * linalg.identity_like(
            jnp.zeros(lat.cm_shape(), dtype=dtype))
        hopping = jnp.full(lat.hopping_shape(), -1.0, dtype=dtype)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=mass_sq, dtype=dtype))

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.NO

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.NONE

    def chiral_projection(self, x, is_up: bool):
        return x


class GaugedLaplace2D(Stencil2D):
    """U(1)-gauged Laplace, Nc=1 (reference operators/gaugedlaplace.h).

    clover = 4; hopping_{+mu} = -U_mu(s), hopping_{-mu} = -conj(U_mu(s-mu));
    shift = m^2. Also provides the custom even-odd Schur trio
    (reference :154-204): the preconditioned op is
    (4+m^2)^2 - D_eo D_oe on the even half.
    """

    def __init__(self, lat: Lattice2D, mass_sq, gauge, dtype=jnp.complex128):
        assert lat.nc == 1, "GaugedLaplace2D only supports Nc = 1"
        self._dtype = dtype
        clover = 4.0 * linalg.identity_like(
            jnp.zeros(lat.cm_shape(), dtype=dtype))
        hopping = _u1_hopping(gauge, (-1.0, -1.0, -1.0, -1.0), dtype)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=mass_sq, dtype=dtype))

    def update_links(self, gauge):
        """Refill hopping from new links (reference :77-115)."""
        hopping = _u1_hopping(gauge, (-1.0, -1.0, -1.0, -1.0), self._dtype)
        self.update_coeffs(hopping=hopping)

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return 1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.NO

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.NONE

    def chiral_projection(self, x, is_up: bool):
        return x

    # --- custom eo-Schur trio (reference :154-204) ---
    def prepare_b(self, b):
        """b' = (4+m^2) b_e - D_eo b_o -> even-half array (reference :154-166)."""
        deo_bo = apply_hopping_half(self.coeffs, b[1], src_parity=1)
        return (4.0 + self.coeffs.shift) * b[0] - deo_bo

    def apply_eo_prec_M(self, x_even):
        """((4+m^2)^2 - D_eo D_oe) x_e (reference :170-188)."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        t_even = apply_hopping_half(self.coeffs, t_odd, src_parity=1)
        s = 4.0 + self.coeffs.shift
        return s * s * x_even - t_even

    def reconstruct_x(self, x_even, b):
        """x_o = (b_o - D_oe x_e)/(4+m^2) (reference :192-204)."""
        t_odd = apply_hopping_half(self.coeffs, x_even, src_parity=0)
        x_odd = (b[1] - t_odd) / (4.0 + self.coeffs.shift)
        return jnp.stack([x_even, x_odd])
