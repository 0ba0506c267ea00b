"""Galerkin coarse operator built by probing.

JAX counterpart of reference operators/coarse.h:29-897.

The reference probes the fine operator with indicator vectors: for each
coarse color (and parity, and direction) it sets 1 on coarse sites,
prolongs, applies one fine stencil piece, restricts, and scatters the
result into the coarse clover (same-parity rows) or the coarse hopping
term (opposite-parity rows) - exact for distance-1 fine stencils
(operators/coarse.h:137-444). Here each probe family is vmapped over the
coarse colors, so the whole build is a handful of batched
prolong/apply/restrict einsum pipelines.

Special cases mirrored from the reference: coarse volume 1 folds
everything into the clover (:146-155, :195-205); a coarse dimension of 1
folds that direction's hopping into the clover (:226-233 etc.).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..lattice import Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from ..stencil import (Stencil2D, StencilCoeffs, make_coeffs, apply_clover,
                       apply_hopping, DefaultChirality, ChiralityState)
from ..transfer import TransferMG, DoublingType
from .. import linalg


class CoarseSigmaType:
    """Extended coarse chirality ops (reference QMGSigmaTypeCoarse,
    operators/coarse.h:19-25)."""
    SIGMA_1_L = 6
    SIGMA_1_R = 7
    SIGMA_1_L_RBJ = 8
    SIGMA_1_R_RBJ = 9


def build_coarse_coeffs(coarse_lat: Lattice2D, fine_coeffs: StencilCoeffs,
                        transfer: TransferMG) -> StencilCoeffs:
    """Probe-build the coarse clover + hopping from a fine coefficient set.

    Pure function: feed it ``stencil.coeffs`` for the original operator or
    ``stencil.rbjacobi.coeffs`` to coarsen the right-block-Jacobi operator
    (the reference's use_rbjacobi swap, operators/coarse.h:119-123).
    """
    if not fine_coeffs.is_distance1():
        # Same restriction as the reference builder ("exact for
        # distance-1 fine stencils", operators/coarse.h:183-186): the
        # parity-scatter below classifies probe responses into coarse
        # clover vs hopping by fine parity, which is only exact when
        # every fine coupling flips parity.
        raise ValueError("Galerkin probe build requires a distance-1 "
                         "fine stencil (twolink/corner pieces present)")
    nc = coarse_lat.nc
    cshape = coarse_lat.cv_shape()
    dtype = (fine_coeffs.clover.dtype if fine_coeffs.clover is not None
             else fine_coeffs.hopping.dtype)

    def probe_all(color):
        """Indicator 1 at every coarse site at dof ``color``."""
        v = jnp.zeros(cshape, dtype=dtype)
        return v.at[..., color].set(1.0)

    def probe_parity(color, parity):
        v = jnp.zeros(cshape, dtype=dtype)
        return v.at[parity, ..., color].set(1.0)

    colors = jnp.arange(nc)

    # Each probe materializes fine-lattice-sized prolong/apply/restrict
    # temporaries; vmapping all nc colors multiplies the peak working
    # set by nc. On large fine lattices (>= 2^19 sites) that exhausts
    # HBM inside the device-resident setup, so chunk the color loop
    # with lax.map instead - same results, nc/2 x smaller peak.
    _big = transfer.fine_lat.volume >= (1 << 19)

    def _map_colors(fn):
        if _big:
            return jax.lax.map(fn, colors, batch_size=2)
        return jax.vmap(fn)(colors)

    clover = jnp.zeros(coarse_lat.cm_shape(), dtype=dtype)
    hopping = jnp.zeros(coarse_lat.hopping_shape(), dtype=dtype)

    # Step 1: coarse clover from the fine clover (reference :137-172).
    def clover_probe(color):
        probe = probe_all(color)
        fine = transfer.prolong_c2f(probe)
        afine = apply_clover(fine_coeffs, fine)
        return transfer.restrict_f2c(afine)  # (..., row_color)

    res = _map_colors(clover_probe)  # (col_color, 2, Yc, Xhc, row)
    clover = clover + jnp.moveaxis(res, 0, -1)  # (..., row, col)

    if fine_coeffs.hopping is None:
        return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                           shift=fine_coeffs.shift, dtype=dtype)

    # Step 2: hopping probes (reference :183-444).
    if coarse_lat.volume == 1:
        def hop_probe(color):
            probe = probe_all(color)
            fine = transfer.prolong_c2f(probe)
            afine = apply_hopping(fine_coeffs, fine)
            return transfer.restrict_f2c(afine)

        res = _map_colors(hop_probe)
        clover = clover + jnp.moveaxis(res, 0, -1)
        return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                           shift=fine_coeffs.shift, dtype=dtype)

    dim_of_dir = {DIR_XP1: 0, DIR_YP1: 1, DIR_XM1: 0, DIR_YM1: 1}
    for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
        folds = coarse_lat.get_dim_mu(dim_of_dir[d]) == 1
        for parity in (0, 1):
            def hop_dir_probe(color, parity=parity, d=d):
                probe = probe_parity(color, parity)
                fine = transfer.prolong_c2f(probe)
                afine = apply_hopping(fine_coeffs, fine, direction=d)
                return transfer.restrict_f2c(afine)

            res = _map_colors(hop_dir_probe)
            res = jnp.moveaxis(res, 0, -1)  # (2, Yc, Xhc, row, col)
            # Same-parity responses -> clover (within-aggregate coupling).
            clover = clover.at[parity].add(res[parity])
            other = 1 - parity
            if folds:
                clover = clover.at[other].add(res[other])
            else:
                hopping = hopping.at[d, other].add(res[other])

    return make_coeffs(coarse_lat, clover=clover, hopping=hopping,
                       shift=fine_coeffs.shift, dtype=dtype)


class CoarseOperator2D(Stencil2D):
    """The built coarse operator, with coarse chirality machinery.

    Mirrors the reference constructor (operators/coarse.h:90-471):
    coarsens ``fine_stencil`` (or its rbjacobi form), learns the default
    chirality from the transfer's doubling type (:104-117), transfers the
    scalar shift (:131), and optionally pre-builds derived stencils.
    """

    BUILD_ORIGINAL = 0
    BUILD_DAGGER = 1
    BUILD_RBJACOBI = 2
    BUILD_DAGGER_RBJACOBI = 3
    BUILD_RBJDAGGER = 4
    BUILD_ALL = 5

    def __init__(self, coarse_lat: Lattice2D, fine_stencil: Stencil2D,
                 transfer: TransferMG, is_chiral: bool = False,
                 use_rbjacobi: bool = False, build_extra: int = 0):
        self.is_chiral = is_chiral
        self.use_rbjacobi = use_rbjacobi
        self.in_transfer = transfer
        doubling = transfer.get_doubling()
        if doubling == DoublingType.PROJECTION:
            self._default_chirality = DefaultChirality.GAMMA_5
        elif doubling == DoublingType.OPERATOR:
            self._default_chirality = DefaultChirality.SIGMA_1
        else:
            self._default_chirality = DefaultChirality.NONE

        if use_rbjacobi:
            fine_coeffs = fine_stencil.rbjacobi.coeffs
        else:
            fine_coeffs = fine_stencil.coeffs
        coeffs = build_coarse_coeffs(coarse_lat, fine_coeffs, transfer)
        super().__init__(coeffs)

        self._sigma_1_L = None
        self._sigma_1_R = None

        if build_extra in (self.BUILD_DAGGER, self.BUILD_DAGGER_RBJACOBI,
                           self.BUILD_ALL):
            self.build_dagger_stencil()
        if build_extra in (self.BUILD_RBJACOBI, self.BUILD_DAGGER_RBJACOBI,
                           self.BUILD_RBJDAGGER, self.BUILD_ALL):
            self.build_rbjacobi_stencil()
        if build_extra in (self.BUILD_RBJDAGGER, self.BUILD_ALL):
            self.build_rbj_dagger_stencil()

    @staticmethod
    def get_dof(i: int = 0) -> int:
        return -1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.UNKNOWN

    def get_default_chirality(self) -> DefaultChirality:
        return self._default_chirality

    # --- coarse chirality (reference :498-650) ---
    def gamma5(self, x):
        """Sign flip on the bottom dof half (reference :498-523)."""
        if not self.is_chiral:
            return x
        half = self.lat.nc // 2
        return x.at[..., half:].multiply(-1.0)

    def chiral_projection(self, x, is_up: bool):
        """Dispatches on default chirality (reference :562-587)."""
        if not self.is_chiral:
            return x
        if self._default_chirality == DefaultChirality.GAMMA_5:
            half = self.lat.nc // 2
            if is_up:
                return x.at[..., half:].set(0.0)
            return x.at[..., :half].set(0.0)
        if self._default_chirality == DefaultChirality.SIGMA_1:
            s = self.sigma1(x)
            return 0.5 * (x + s) if is_up else 0.5 * (x - s)
        return x

    # --- coarse sigma_1^{L/R} from the transfer decompositions
    #     (reference apply_sigma overload, :661-894) ---
    def _build_sigma_lr(self):
        if self._sigma_1_L is not None:
            return
        with jax.ensure_compile_time_eval():
            self._build_sigma_lr_impl()

    def _build_sigma_lr_impl(self):
        t = self.in_transfer
        if not t.has_decompositions():
            raise ValueError(
                "cannot apply coarse sigma ops without saved transfer "
                "factorizations (reference operators/coarse.h:663-667)")
        nc = self.lat.nc
        half = nc // 2
        s1 = jnp.zeros((nc, nc), dtype=self.coeffs.shift.dtype)
        s1 = s1.at[jnp.arange(half), jnp.arange(half) + half].set(1.0)
        s1 = s1.at[jnp.arange(half) + half, jnp.arange(half)].set(1.0)

        def pad_parity(m):
            """Transfer factors for a point coarse lattice live on a
            (1,1,1) site grid; broadcast to the (2,...) field layout."""
            if m.shape[0] == 1 and self.lat.volume == 1:
                return jnp.concatenate([m, m], axis=0)
            return m

        if t.is_symmetric():
            sigma = pad_parity(t.block_cholesky)
            sigma_inv = linalg.site_inv_qr(sigma)
            # Left-applied form: Sigma sigma_1 Sigma^{-1}
            # (reference :722-729).
            s_l = linalg.site_matmul(sigma,
                                     linalg.site_matmul(
                                         jnp.broadcast_to(s1, sigma.shape),
                                         sigma_inv))
            self._sigma_1_L = s_l
            self._sigma_1_R = s_l
        else:
            L = pad_parity(t.block_L)
            U = pad_parity(t.block_U)
            ldag = linalg.site_conjtrans(L)
            u_inv = linalg.site_inv_qr(U)
            ldag_inv = linalg.site_inv_qr(ldag)
            s1b = jnp.broadcast_to(s1, U.shape)
            # sigma_1^L applied = L^dag sigma_1 U^{-1} (reference :836-840).
            self._sigma_1_L = linalg.site_matmul(
                ldag, linalg.site_matmul(s1b, u_inv))
            # sigma_1^R = U sigma_1 L^{-dag} (reference :842-844).
            self._sigma_1_R = linalg.site_matmul(
                U, linalg.site_matmul(s1b, ldag_inv))

    def apply_coarse_sigma(self, x, ctype: int):
        """Extended sigma application (reference :661-894)."""
        self._build_sigma_lr()
        if ctype == CoarseSigmaType.SIGMA_1_L:
            return linalg.site_matvec(self._sigma_1_L, x)
        if ctype == CoarseSigmaType.SIGMA_1_R:
            return linalg.site_matvec(self._sigma_1_R, x)
        if ctype == CoarseSigmaType.SIGMA_1_L_RBJ:
            # B^{-dag} sigma_1^L (reference :864-875).
            y = linalg.site_matvec(self._sigma_1_L, x)
            return linalg.site_matvec(self.rbj_dagger.cinv, y)
        if ctype == CoarseSigmaType.SIGMA_1_R_RBJ:
            # B sigma_1^R (reference :877-890).
            y = linalg.site_matvec(self._sigma_1_R, x)
            out = apply_clover(self.coeffs, y)
            return out + self.coeffs.shift * y
        raise ValueError(f"invalid coarse sigma type {ctype}")
