"""Shamir domain-wall operator as a 2D stencil with Nc = 2*Ls.

JAX counterpart of reference operators/dwf.h:19-293.

Structure (decoded from the strided fills at dwf.h:180-237): per site the
(2Ls x 2Ls) clover is

    block-diagonal: Ls copies of 3w * I_2 (Wilson clover w/ the s-hop
        contribution; M5 rides in ``shift``)
    off-diagonal:   -P_+ coupling s -> s+1 at (2j+2, 2j), j < Ls-1
                    -P_- coupling s -> s-1 at (2j+1, 2j+3), j < Ls-1
    mass terms:     +m at (2Ls-1, 1) (m P_-) and (0, 2Ls-2) (m P_+)

and the hopping term is Ls block-diagonal copies of the Wilson hopping.
Gamma_5 = gamma_5 (x) s-reflection (dwf.h:62-67).

The reference ships no DWF test (SURVEY.md 2.4); tests/test_dwf.py adds a
parity oracle against stacked Wilson blocks.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..lattice import Lattice2D, DIR_XM1, DIR_YM1
from ..cshift import cshift_pull
from ..stencil import (Stencil2D, make_coeffs, ChiralityState,
                       DefaultChirality)
from .wilson import wilson_spin_matrices

SUPPORTED_LS = (2, 4, 6, 8, 12, 16, 24, 32)


def _dwf_clover_block(ls: int, mass, w: float, dtype) -> np.ndarray:
    """The constant (2Ls x 2Ls) per-site clover matrix."""
    n = 2 * ls
    m = np.zeros((n, n), dtype=np.complex128)
    for j in range(ls):
        m[2 * j, 2 * j] = 3.0 * w
        m[2 * j + 1, 2 * j + 1] = 3.0 * w
    # Off-diagonal -P_+/-P_- between s-slices (signfix = -1, dwf.h:222-230).
    for j in range(ls - 1):
        m[2 * j + 2, 2 * j] = -1.0      # -P_+ (spin-up coupling s+1 <- s)
        m[2 * j + 1, 2 * j + 3] = -1.0  # -P_- (spin-down coupling s <- s+1)
    # Mass terms (dwf.h:232-237).
    m[n - 1, 1] = complex(mass)      # m P_- between last and first slice
    m[0, n - 2] = complex(mass)      # m P_+
    return m


class Dwf2D(Stencil2D):
    def __init__(self, lat: Lattice2D, mass, gauge, ls: int,
                 m5: float = -1.0, dtype=jnp.complex128):
        if ls not in SUPPORTED_LS:
            raise ValueError(f"unsupported Ls {ls} "
                             f"(reference dwf.h:261-293 supports "
                             f"{SUPPORTED_LS})")
        assert lat.nc == 2 * ls, "Dwf2D requires Nc = 2 Ls"
        self.ls = ls
        self.mass = mass
        self.m5 = m5
        self._dtype = dtype
        clover, hopping = self._build(lat, gauge)
        super().__init__(make_coeffs(lat, clover=clover, hopping=hopping,
                                     shift=m5, dtype=dtype))

    def _build(self, lat, gauge):
        dtype = self._dtype
        ls = self.ls
        w = 1.0
        gauge = jnp.asarray(gauge, dtype=dtype)
        ux, uy = gauge[0], gauge[1]
        block = jnp.asarray(_dwf_clover_block(ls, self.mass, w, dtype),
                            dtype=dtype)
        clover = jnp.broadcast_to(block, lat.cm_shape())

        # Hopping: Ls block-diagonal Wilson copies (dwf.h:181-218).
        sx_p, sy_p, sx_m, sy_m = wilson_spin_matrices(w, dtype)
        n = 2 * ls

        def expand(spin2):
            big = jnp.zeros((n, n), dtype=dtype)
            for j in range(ls):
                big = big.at[2 * j:2 * j + 2, 2 * j:2 * j + 2].set(spin2)
            return big

        ux_m = jnp.conj(cshift_pull(ux, DIR_XM1))
        uy_m = jnp.conj(cshift_pull(uy, DIR_YM1))
        hopping = jnp.stack([
            ux[..., None, None] * expand(sx_p),
            uy[..., None, None] * expand(sy_p),
            ux_m[..., None, None] * expand(sx_m),
            uy_m[..., None, None] * expand(sy_m),
        ])
        return clover, hopping

    def update_links(self, gauge):
        clover, hopping = self._build(self.lat, gauge)
        self.update_coeffs(clover=clover, hopping=hopping)

    def get_dof_instance(self) -> int:
        return 2 * self.ls

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.YES

    def get_default_chirality(self) -> DefaultChirality:
        return DefaultChirality.GAMMA_5

    def gamma5(self, x):
        """Gamma_5 = gamma_5 (x) s-reflection: out[s, spin] =
        (+-1)^spin in[Ls-1-s, spin] (reference dwf.h:62-67, :104-114)."""
        ls = self.ls
        v = x.reshape(x.shape[:-1] + (ls, 2))
        v = v[..., ::-1, :]  # s-reflection
        v = v.at[..., 1].multiply(-1.0)  # gamma5 on spin
        return v.reshape(x.shape)

    def chiral_projection(self, x, is_up: bool):
        """Stubbed in the reference (dwf.h:117-146); identity here too."""
        return x

    def chiral_projection_both(self, x):
        return x, jnp.zeros_like(x)


def create_dwf_ls(lat: Lattice2D, mass, gauge, ls: int, m5: float = -1.0,
                  dtype=jnp.complex128) -> Dwf2D:
    """Factory mirroring reference createDwfLs (dwf.h:261-293)."""
    return Dwf2D(lat, mass, gauge, ls, m5, dtype)
