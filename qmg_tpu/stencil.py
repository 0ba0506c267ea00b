"""Generic distance-1 stencil engine - "the rock of the code".

JAX counterpart of the reference ``Stencil2D``
(reference: stencil/stencil_2d.h:117-2716).

Design differences from the C++ (same behavior, idiomatic JAX):

  * Coefficients live in a ``StencilCoeffs`` pytree of device arrays
    (clover (2,Y,Xh,nc,nc); hopping (4,2,Y,Xh,nc,nc) with direction order
    {+x,+y,-x,-y}; complex scalar shift/eo_shift/dof_shift).
  * The matvec family (apply_M_{clover,eo,oe,hopping,shift}, reference
    :666-936) becomes pure jittable functions: each hopping term is a
    cshift pull fused with a batched (nc x nc) complex matvec - XLA fuses
    the shift+matmul+accumulate chain.
  * The reference's pointer-swap trick for dagger / right-block-Jacobi /
    rbj-dagger stencils (:1142-1178, :1604-1639, :2063-2098) becomes simply
    *selecting a different coefficient pytree*; the derived coefficient
    sets are computed by the pure functions build_dagger / build_rbjacobi /
    build_rbj_dagger (:1080-1139, :1452-1601, :1989-2060).
  * Even-odd (Schur) operators act on half-lattice arrays (Y,Xh,nc)
    directly instead of full-size buffers with a dead half.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .lattice import Lattice2D, DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .cshift import (cshift_pull, cshift_pull_half, ALL_DIRS,
                     TWOLINK_DIRS, CORNER_DIRS)
from . import linalg

# Opposite direction map: +x<->-x, +y<->-y. For the twolink and corner
# coefficient SLOTS the opposite pairing is likewise 0<->2, 1<->3
# (stencil_2d.h:28-39: {+2X,+2Y,-2X,-2Y}, {+X+Y,-X+Y,-X-Y,+X-Y}).
OPPOSITE_DIR = {DIR_XP1: DIR_XM1, DIR_XM1: DIR_XP1,
                DIR_YP1: DIR_YM1, DIR_YM1: DIR_YP1}
_OPPOSITE_SLOT = (2, 3, 0, 1)

# Global monotonic state-version source. Every mutable solver-state object
# (stencil coefficient sets, transfer null vectors, deflation bases) draws
# a fresh, never-reused version number at construction and on each
# mutation; compiled-solve caches key on these versions instead of id()s,
# which the garbage collector can recycle.
import itertools as _itertools
_STATE_VERSIONS = _itertools.count()


def next_state_version() -> int:
    return next(_STATE_VERSIONS)


class StencilType(enum.IntEnum):
    """Matvec variants (reference QMGStencilType, stencil_2d.h:63-74)."""
    ORIGINAL = 0
    DAGGER = 1
    RIGHT_JACOBI = 2
    RIGHT_SCHUR = 3
    M_MDAGGER = 4
    MDAGGER_M = 5
    RBJ_DAGGER = 6
    RBJ_M_MDAGGER = 7
    RBJ_MDAGGER_M = 8


class DefaultChirality(enum.IntEnum):
    """Reference QMGDefaultChirality (stencil_2d.h:77-82)."""
    NONE = 0
    GAMMA_5 = 1
    SIGMA_1 = 2


class SigmaType(enum.IntEnum):
    """Reference QMGSigmaType (stencil_2d.h:86-94)."""
    NONE = 0
    DEFAULT = 1
    GAMMA_5 = 2
    SIGMA_1 = 3
    GAMMA_5_L_RBJ = 4
    GAMMA_5_R_RBJ = 5


class ChiralityState(enum.IntEnum):
    """Reference chirality_state (stencil_2d.h:55-60)."""
    NO = 0
    YES = 1
    UNKNOWN = 2


@partial(jax.tree_util.register_dataclass,
         data_fields=["clover", "hopping", "shift", "eo_shift", "dof_shift",
                      "twolink", "corner"],
         meta_fields=["lat"])
@dataclasses.dataclass
class StencilCoeffs:
    """One coefficient set of a distance-<=2 stencil (a pytree).

    ``clover``/``hopping``/``twolink``/``corner`` may be None when the
    piece does not exist (reference QMG_PIECE_* allocation flags,
    stencil_2d.h:43-52, :213-252). The reference allocates twolink and
    corner but never APPLIES them (warnings at stencil_2d.h:925-933);
    here they are applied, daggered, and rbjacobi-derived like hopping.
    Slot orders follow stencil_2d.h:28-39: twolink (4, 2, Y, Xh, nc, nc)
    over {+2X,+2Y,-2X,-2Y}; corner likewise over {+X+Y,-X+Y,-X-Y,+X-Y}.
    """
    lat: Lattice2D
    clover: Optional[jax.Array]
    hopping: Optional[jax.Array]
    shift: jax.Array
    eo_shift: jax.Array
    dof_shift: jax.Array
    twolink: Optional[jax.Array] = None
    corner: Optional[jax.Array] = None

    def replace(self, **kw) -> "StencilCoeffs":
        return dataclasses.replace(self, **kw)

    def is_distance1(self) -> bool:
        return self.twolink is None and self.corner is None


def make_coeffs(lat: Lattice2D, clover=None, hopping=None, shift=0.0,
                eo_shift=0.0, dof_shift=0.0, dtype=jnp.complex128,
                twolink=None, corner=None) -> StencilCoeffs:
    c = jnp.asarray(shift, dtype=dtype)
    e = jnp.asarray(eo_shift, dtype=dtype)
    d = jnp.asarray(dof_shift, dtype=dtype)
    return StencilCoeffs(lat=lat, clover=clover, hopping=hopping, shift=c,
                         eo_shift=e, dof_shift=d, twolink=twolink,
                         corner=corner)


# ---------------------------------------------------------------------------
# Matvec family (reference stencil_2d.h:666-936). All are pure functions;
# unlike the reference they *return* results rather than accumulate.
# ---------------------------------------------------------------------------

def apply_clover(coeffs: StencilCoeffs, x):
    """lhs = clover * rhs on the full lattice (reference :694-703)."""
    if coeffs.clover is None:
        return jnp.zeros_like(x)
    return linalg.site_matvec(coeffs.clover, x)


def apply_hopping(coeffs: StencilCoeffs, x, direction: Optional[int] = None):
    """Hopping term on both parities: shift-then-matvec per direction.

    Equivalent to apply_M_eo + apply_M_oe (reference :706-841). With a
    ``direction``, only that term (used by the Galerkin coarse builder,
    operators/coarse.h:217 etc.).
    """
    if coeffs.hopping is None or coeffs.lat.volume == 1:
        return jnp.zeros_like(x)
    dirs = ALL_DIRS if direction is None else (direction,)
    out = jnp.zeros_like(x)
    for d in dirs:
        out = out + linalg.site_matvec(coeffs.hopping[d], cshift_pull(x, d))
    return out


def apply_hopping_half(coeffs: StencilCoeffs, x_half, src_parity: int,
                       direction: Optional[int] = None):
    """One parity of the hopping term from a half-lattice input.

    Computes (D_eo x_o) for src_parity=1, or (D_oe x_e) for src_parity=0,
    returning a (Y, Xh, nc) array on the destination parity. Mirrors
    apply_M_eo / apply_M_oe (reference :706-841) without dead halves.
    """
    dest = 1 - src_parity
    if coeffs.hopping is None or coeffs.lat.volume == 1:
        return jnp.zeros_like(x_half)
    if direction is not None:
        pulled = cshift_pull_half(x_half, src_parity, direction)
        return linalg.site_matvec(coeffs.hopping[direction, dest], pulled)
    # All four directions fuse into ONE stacked einsum (contraction over
    # 4*nc), mirroring apply_M's fused full-lattice form - the Schur
    # paths apply this twice per operator application, so the fusion
    # matters on the latency-bound coarse levels.
    pulled = jnp.stack([cshift_pull_half(x_half, src_parity, d)
                        for d in ALL_DIRS])
    return linalg.stacked_site_matvec(coeffs.hopping[:, dest], pulled)


def _apply_pulled_terms(mats, dirs, x, direction: Optional[int] = None):
    """sum_d mats[d] . pull(x, dirs[d]) (optionally one direction)."""
    sel = range(len(dirs)) if direction is None else (
        dirs.index(direction),)
    out = None
    for i in sel:
        term = linalg.site_matvec(mats[i], cshift_pull(x, dirs[i]))
        out = term if out is None else out + term
    return out


def apply_twolink(coeffs: StencilCoeffs, x, direction: Optional[int] = None):
    """Distance-2 term: lhs += sum_mu twolink_mu(s) rhs(s + 2mu).

    The reference allocates this piece but never applies it
    (stencil_2d.h:155-160 alloc, :925-928 'not yet supported' warning);
    here it is applied like hopping, over the parity-PRESERVING
    distance-2 pulls.
    """
    if coeffs.twolink is None or coeffs.lat.volume == 1:
        return jnp.zeros_like(x)
    return _apply_pulled_terms(coeffs.twolink, TWOLINK_DIRS, x, direction)


def apply_corner(coeffs: StencilCoeffs, x, direction: Optional[int] = None):
    """Corner term: lhs += sum_munu corner_munu(s) rhs(s + mu + nu).

    Reference allocates-but-never-applies (stencil_2d.h:162-164,
    :930-933); applied here over the parity-preserving corner pulls.
    """
    if coeffs.corner is None or coeffs.lat.volume == 1:
        return jnp.zeros_like(x)
    return _apply_pulled_terms(coeffs.corner, CORNER_DIRS, x, direction)


def apply_shift(coeffs: StencilCoeffs, x):
    """Mass/eo/dof shifts (reference apply_M_shift, :865-909)."""
    lat = coeffs.lat
    nc = lat.nc
    if lat.volume == 1:
        # Single site lives at parity 0 (reference :870-888).
        s = coeffs.shift + coeffs.eo_shift
        if nc % 2 == 0:
            half = nc // 2
            d = coeffs.dof_shift
            top = (s + d) * x[..., :half]
            bot = (s - d) * x[..., half:]
            out = jnp.concatenate([top, bot], axis=-1)
        else:
            out = s * x
        return out.at[1].set(0.0) if x.shape[0] == 2 else out
    even = (coeffs.shift + coeffs.eo_shift) * x[0]
    odd = (coeffs.shift - coeffs.eo_shift) * x[1]
    out = jnp.stack([even, odd])
    if nc % 2 == 0:
        half = nc // 2
        d = coeffs.dof_shift
        out = out.at[..., :half].add(d * x[..., :half])
        out = out.at[..., half:].add(-d * x[..., half:])
    return out


def apply_M(coeffs: StencilCoeffs, x):
    """Full operator lhs = M rhs (reference apply_M, :912-936).

    The clover, hopping, and (when present) twolink/corner terms fuse
    into ONE stacked einsum (contraction over n_terms*nc) - a single
    batched matvec instead of five-plus, which matters on the
    latency-bound small coarse levels. The coefficient stack is built
    from trace-time constants, so XLA hoists it out of solver loops.

    The ops run under the named scope ``apply_scope(lat)``, so a
    profiler trace can attribute device time to each level's apply.
    """
    with jax.named_scope(apply_scope(coeffs.lat)):
        return _apply_M(coeffs, x)


def apply_scope(lat: Lattice2D) -> str:
    """Named scope of ``apply_M`` on lattice ``lat``."""
    return f"apply_M_{lat.y_len}x{lat.x_len}_nc{lat.nc}"


def _apply_M(coeffs: StencilCoeffs, x):
    if coeffs.hopping is not None and coeffs.lat.volume > 1:
        nbrs = [cshift_pull(x, d) for d in ALL_DIRS]
        mats = [coeffs.hopping]
        if coeffs.clover is not None:
            nbrs = [x] + nbrs
            mats = [coeffs.clover[None]] + mats
        if coeffs.twolink is not None:
            nbrs += [cshift_pull(x, d) for d in TWOLINK_DIRS]
            mats.append(coeffs.twolink)
        if coeffs.corner is not None:
            nbrs += [cshift_pull(x, d) for d in CORNER_DIRS]
            mats.append(coeffs.corner)
        mats = mats[0] if len(mats) == 1 else jnp.concatenate(mats)
        out = linalg.stacked_site_matvec(mats, jnp.stack(nbrs))
        return out + apply_shift(coeffs, x)
    out = apply_clover(coeffs, x)
    out = out + apply_hopping(coeffs, x)
    out = out + apply_twolink(coeffs, x)
    out = out + apply_corner(coeffs, x)
    out = out + apply_shift(coeffs, x)
    return out


def build_gather_apply(coeffs: StencilCoeffs):
    """A minimum-op-count apply for small (coarse) lattices.

    The roll+select neighbor pulls cost ~10 sequential HLO ops per apply;
    on tiny coarse levels the K-cycle is bound by that op latency, not by
    FLOPs or memory bandwidth. Here the four pulls collapse into ONE gather
    against a static (precomputed, geometry-only) neighbor-index table,
    followed by one stacked einsum and the shift add - ~4 ops total:

        out[v] = sum_{s in {self, 4 nbrs}} M_s[v] . x[nbr_s(v)] + shifts

    Mathematically identical to apply_M (the indices are produced by
    cshift_pull itself applied to an iota field). Returns apply(x) or
    None when the stencil shape doesn't qualify (no hopping / volume 1).
    """
    lat = coeffs.lat
    if (coeffs.hopping is None or lat.volume <= 1 or coeffs.clover is None
            or not coeffs.is_distance1()):
        return None
    import numpy as np
    with jax.ensure_compile_time_eval():
        site_ids = jnp.arange(lat.volume, dtype=jnp.int32).reshape(
            (2, lat.y_len, lat.xh))
        nbr = [site_ids.reshape(-1)]
        for d in ALL_DIRS:
            nbr.append(cshift_pull(site_ids, d).reshape(-1))
        nbr_idx = jnp.stack(nbr)  # (5, vol) static constant

    def apply_fn(x):
        nc = lat.nc
        mats = jnp.concatenate([coeffs.clover[None], coeffs.hopping])
        mats = mats.reshape(5, lat.volume, nc, nc)
        xg = x.reshape(lat.volume, nc)[nbr_idx]          # (5, vol, nc)
        out = linalg.stacked_site_matvec(mats, xg).reshape(x.shape)
        return out + apply_shift(coeffs, x)

    return apply_fn


def apply_M_ee(coeffs: StencilCoeffs, x_even):
    """Clover+shift on the even half only (reference apply_M_ee, :666-677)."""
    out = jnp.zeros_like(x_even)
    if coeffs.clover is not None:
        out = linalg.site_matvec(coeffs.clover[0], x_even)
    return out + coeffs.shift * x_even


def apply_M_oo(coeffs: StencilCoeffs, x_odd):
    """Clover+shift on the odd half only (reference apply_M_oo, :680-692)."""
    out = jnp.zeros_like(x_odd)
    if coeffs.clover is not None:
        out = linalg.site_matvec(coeffs.clover[1], x_odd)
    return out + coeffs.shift * x_odd


# ---------------------------------------------------------------------------
# Derived coefficient sets.
# ---------------------------------------------------------------------------

def build_dagger(coeffs: StencilCoeffs) -> StencilCoeffs:
    """Coefficients of M^dagger (reference build_dagger_stencil, :1080-1139).

    dagger_clover(s) = clover(s)^dagger; the +mu dagger link at s is the
    conj-transpose of the -mu link at s+mu (and vice versa); shifts
    conjugate. The same neighbor-conjugation rule extends to the
    twolink/corner pieces: dagger coeff for direction D at s is the
    conj-transpose of the -D coefficient pulled from s+D (opposite slots
    pair 0<->2, 1<->3 in both families).
    """
    d_clover = (linalg.site_conjtrans(coeffs.clover)
                if coeffs.clover is not None else None)

    def _dagger_piece(mats, dirs):
        parts = []
        for i, d in enumerate(dirs):
            pulled = cshift_pull(mats[_OPPOSITE_SLOT[i]], d)
            parts.append(linalg.site_conjtrans(pulled))
        return jnp.stack(parts)

    d_hopping = (_dagger_piece(coeffs.hopping, ALL_DIRS)
                 if coeffs.hopping is not None else None)
    d_twolink = (_dagger_piece(coeffs.twolink, TWOLINK_DIRS)
                 if coeffs.twolink is not None else None)
    d_corner = (_dagger_piece(coeffs.corner, CORNER_DIRS)
                if coeffs.corner is not None else None)
    return coeffs.replace(clover=d_clover, hopping=d_hopping,
                          twolink=d_twolink, corner=d_corner,
                          shift=jnp.conj(coeffs.shift),
                          eo_shift=jnp.conj(coeffs.eo_shift),
                          dof_shift=jnp.conj(coeffs.dof_shift))


def mass_pattern(coeffs: StencilCoeffs):
    """Per-site diagonal mass matrix with eo/dof sign structure.

    Mirrors the even/odd mass patterns of build_rbjacobi_stencil
    (reference :1492-1528): diagonal entries shift +- eo_shift (by parity)
    +- dof_shift (by dof half, when nc is even).
    """
    lat = coeffs.lat
    nc = lat.nc
    diag_even = jnp.full((nc,), coeffs.shift + coeffs.eo_shift,
                         dtype=coeffs.shift.dtype)
    diag_odd = jnp.full((nc,), coeffs.shift - coeffs.eo_shift,
                        dtype=coeffs.shift.dtype)
    if nc % 2 == 0:
        half = nc // 2
        sgn = jnp.concatenate([jnp.ones(half), -jnp.ones(half)])
        diag_even = diag_even + coeffs.dof_shift * sgn
        diag_odd = diag_odd + coeffs.dof_shift * sgn
    if lat.volume == 1:
        diag_odd = diag_even  # single site is "even" (reference :1520-1523)
    me = jnp.diag(diag_even)
    mo = jnp.diag(diag_odd)
    pat = jnp.stack([me, mo])  # (2, nc, nc)
    return jnp.broadcast_to(pat[:, None, None, :, :], lat.cm_shape())


@dataclasses.dataclass
class RBJacobiSet:
    """rbjacobi coefficient set + the clover inverse needed for reconstruct
    (reference rbjacobi_clover/hopping/cinv, stencil_2d.h:191-199)."""
    coeffs: StencilCoeffs
    cinv: jax.Array  # (2, Y, Xh, nc, nc) = (clover + mass)^{-1}


def build_rbjacobi(coeffs: StencilCoeffs) -> RBJacobiSet:
    """Right block Jacobi A B^{-1}, B = clover + mass
    (reference build_rbjacobi_stencil, :1452-1601).

    rbj clover = identity; rbj +mu hopping at s = hopping_+mu(s) cinv(s+mu)
    (the reference computes this with a cshift-conjugation dance,
    :1556-1582; here it is a pull of cinv); shifts vanish. The same
    right-multiply-by-the-source-site's-B^{-1} rule extends to the
    twolink/corner pieces (pull cinv by the matching direction).
    """
    lat = coeffs.lat
    b = mass_pattern(coeffs)
    if coeffs.clover is not None:
        b = b + coeffs.clover
    cinv = linalg.site_inv_qr(b)
    rbj_clover = linalg.identity_like(b)

    def _rbj_piece(mats, dirs):
        parts = []
        for i, d in enumerate(dirs):
            pulled_cinv = cshift_pull(cinv, d)
            parts.append(linalg.site_matmul(mats[i], pulled_cinv))
        return jnp.stack(parts)

    rbj_hopping = (_rbj_piece(coeffs.hopping, ALL_DIRS)
                   if coeffs.hopping is not None else None)
    rbj_twolink = (_rbj_piece(coeffs.twolink, TWOLINK_DIRS)
                   if coeffs.twolink is not None else None)
    rbj_corner = (_rbj_piece(coeffs.corner, CORNER_DIRS)
                  if coeffs.corner is not None else None)
    zero = jnp.zeros_like(coeffs.shift)
    rbj = coeffs.replace(clover=rbj_clover, hopping=rbj_hopping,
                         twolink=rbj_twolink, corner=rbj_corner, shift=zero,
                         eo_shift=zero, dof_shift=zero)
    return RBJacobiSet(coeffs=rbj, cinv=cinv)


def build_rbj_dagger(rbj: RBJacobiSet) -> RBJacobiSet:
    """(A B^{-1})^dagger coefficients
    (reference build_rbj_dagger_stencil, :1989-2060)."""
    dag = build_dagger(rbj.coeffs)
    zero = jnp.zeros_like(dag.shift)
    dag = dag.replace(shift=zero, eo_shift=zero, dof_shift=zero)
    return RBJacobiSet(coeffs=dag, cinv=linalg.site_conjtrans(rbj.cinv))


# ---------------------------------------------------------------------------
# Schur (even-odd reduced) operators in the rbjacobi basis
# (reference :1886-1983). These act on even-half arrays (Y, Xh, nc).
# ---------------------------------------------------------------------------

def apply_rbj_schur(rbj: RBJacobiSet, x_even):
    """(1 - D_eo D_oo^{-1} D_oe D_ee^{-1}) on the even half
    (reference apply_M_rbjacobi_schur, :1886-1908).

    Requires a distance-1 stencil: the parity-preserving twolink/corner
    pieces would make D_ee/D_oo non-site-diagonal, so the eo Schur
    complement below would be wrong (same restriction as the reference,
    whose Schur paths predate any twolink/corner application).
    """
    if not rbj.coeffs.is_distance1():
        raise ValueError("eo-Schur requires a distance-1 stencil "
                         "(twolink/corner pieces present)")
    t_odd = apply_hopping_half(rbj.coeffs, x_even, src_parity=0)
    t_even = apply_hopping_half(rbj.coeffs, t_odd, src_parity=1)
    return x_even - t_even


@partial(jax.tree_util.register_dataclass,
         data_fields=["clover", "twolink", "corner"], meta_fields=[])
@dataclasses.dataclass
class SchurFused:
    """Precomposed even-sublattice coefficients of the rbj Schur
    complement S = 1 - D_eo D_oe (D_ee = D_oo = 1 in the rbjacobi
    basis, reference :1886-1908).

    Composing the two half-hopping products ONCE turns every Schur
    application into a single 9-point stencil on the even half - one
    stacked einsum + 8 half-lattice pulls - instead of two dependent
    4-term half-applies (2 einsums + 8 pulls, twice the latency chain).
    The coefficients are loop-invariant, so XLA hoists the composition
    out of the Krylov loops and each apply matches the standard fused
    apply_M's shape.

    Shapes (even half): clover (Y, Xh, nc, nc); twolink
    (4, Y, Xh, nc, nc) over {+2X,+2Y,-2X,-2Y}; corner likewise over
    {+X+Y,-X+Y,-X-Y,+X-Y} (slot orders as stencil_2d.h:28-39).
    """
    clover: jax.Array
    twolink: jax.Array
    corner: jax.Array


# (d2, d1) hopping-slot pairs contributing to each composed offset,
# d2 = the eo (second) hop, d1 = the oe (first) hop; slots {+x,+y,-x,-y}.
_SCHUR_ZERO_PAIRS = tuple((d2, _OPPOSITE_SLOT[d2]) for d2 in range(4))
_SCHUR_TWOLINK_PAIRS = (((0, 0),), ((1, 1),), ((2, 2),), ((3, 3),))
_SCHUR_CORNER_PAIRS = (((0, 1), (1, 0)), ((2, 1), (1, 2)),
                       ((2, 3), (3, 2)), ((0, 3), (3, 0)))


def build_rbj_schur_fused(rbj: RBJacobiSet) -> SchurFused:
    """Compose S = 1 - D_eo D_oe into even-half 9-point coefficients.

    (D_eo D_oe x)(s_e) = sum_{d2,d1} H[d2,even](s_e) H[d1,odd](s_e+d2)
    x(s_e+d2+d1); grouping path pairs by total offset gives a diagonal
    piece (d1 = -d2), four distance-2 pieces and four corner pieces -
    exactly the twolink/corner stencil families, on the even half.
    """
    if not rbj.coeffs.is_distance1():
        raise ValueError("eo-Schur requires a distance-1 stencil")
    H = rbj.coeffs.hopping  # (4, 2, Y, Xh, nc, nc)
    Heo = H[:, 0]           # even-destination rows
    # pulled[d2][d1]: H[d1, odd] at odd site s_e + d2, even-aligned.
    pulled = [[cshift_pull_half(H[d1, 1], 1, ALL_DIRS[d2])
               for d1 in range(4)] for d2 in range(4)]

    def compose(pairs):
        out = None
        for d2, d1 in pairs:
            term = linalg.site_matmul(Heo[d2], pulled[d2][d1])
            out = term if out is None else out + term
        return out

    eye = linalg.identity_like(Heo[0])
    clover = eye - compose(_SCHUR_ZERO_PAIRS)
    twolink = jnp.stack([-compose(p) for p in _SCHUR_TWOLINK_PAIRS])
    corner = jnp.stack([-compose(p) for p in _SCHUR_CORNER_PAIRS])
    return SchurFused(clover=clover, twolink=twolink, corner=corner)


def apply_rbj_schur_fused(fused: SchurFused, x_even):
    """S x_e as ONE stacked einsum over the 9 composed terms."""
    nbrs = [x_even]
    nbrs += [cshift_pull_half(x_even, 0, d) for d in TWOLINK_DIRS]
    nbrs += [cshift_pull_half(x_even, 0, d) for d in CORNER_DIRS]
    mats = jnp.concatenate([fused.clover[None], fused.twolink,
                            fused.corner])
    return linalg.stacked_site_matvec(mats, jnp.stack(nbrs))


def prepare_rbj_schur(rbj: RBJacobiSet, b):
    """b_r = b_e - D_eo D_oo^{-1} b_o (reference :1912-1928)."""
    t_even = apply_hopping_half(rbj.coeffs, b[1], src_parity=1)
    return b[0] - t_even


def reconstruct_rbj_schur(rbj: RBJacobiSet, y_even, b):
    """x_e = D_ee^{-1} y_e; x_o = D_oo^{-1}(b_o - D_oe D_ee^{-1} y_e)
    (reference :1932-1957)."""
    t_odd = apply_hopping_half(rbj.coeffs, y_even, src_parity=0)
    x_e = linalg.site_matvec(rbj.cinv[0], y_even)
    x_o = linalg.site_matvec(rbj.cinv[1], b[1] - t_odd)
    return jnp.stack([x_e, x_o])


# ---------------------------------------------------------------------------
# Stateful wrapper with the reference's full API surface.
# ---------------------------------------------------------------------------

class Stencil2D:
    """Holds an original coefficient set plus lazily-built derived sets.

    The reference's 9-variant dispatch (apply_M/prepare_M/reconstruct_M by
    QMGStencilType, stencil_2d.h:2418-2527) is reproduced; every apply is a
    pure function of (coefficient pytree, input array), so they can be
    passed to the jitted Krylov solvers directly.
    """

    def __init__(self, coeffs: StencilCoeffs):
        self.coeffs = coeffs
        self._dagger: Optional[StencilCoeffs] = None
        self._rbjacobi: Optional[RBJacobiSet] = None
        self._rbj_dagger: Optional[RBJacobiSet] = None
        self._rbj_schur_fused: Optional[SchurFused] = None
        self._version = next_state_version()
        # Optional replacement for the ORIGINAL apply (set by e.g. the
        # mesh-sharded planes solver to route the fine Dslash through
        # the shard_map halo exchange). Must compute the FULL apply_M.
        self._apply_override = None

    @property
    def version(self) -> int:
        """Monotonic state version: changes whenever the operator's
        coefficients (or apply override) change. Compiled-solve caches key
        on this (never-reused) value instead of buffer id()s."""
        return self._version

    @property
    def apply_override(self):
        return self._apply_override

    @apply_override.setter
    def apply_override(self, fn):
        self._apply_override = fn
        self._version = next_state_version()

    # --- construction / update ---
    @property
    def lat(self) -> Lattice2D:
        return self.coeffs.lat

    @property
    def shift(self):
        return self.coeffs.shift

    def update_shifts(self, shift=None, eo_shift=None, dof_shift=None):
        """Reference update_shift* (:640-660). Invalidates derived sets."""
        kw = {}
        if shift is not None:
            kw["shift"] = jnp.asarray(shift, dtype=self.coeffs.shift.dtype)
        if eo_shift is not None:
            kw["eo_shift"] = jnp.asarray(eo_shift,
                                         dtype=self.coeffs.shift.dtype)
        if dof_shift is not None:
            kw["dof_shift"] = jnp.asarray(dof_shift,
                                          dtype=self.coeffs.shift.dtype)
        self.coeffs = self.coeffs.replace(**kw)
        self.invalidate_derived()

    def update_coeffs(self, clover=None, hopping=None):
        kw = {}
        if clover is not None:
            kw["clover"] = clover
        if hopping is not None:
            kw["hopping"] = hopping
        self.coeffs = self.coeffs.replace(**kw)
        self.invalidate_derived()

    def clear_stencils(self):
        """Zero all coefficient pieces (reference clear_stencils,
        stencil_2d.h:339-375)."""
        kw = {}
        if self.coeffs.clover is not None:
            kw["clover"] = jnp.zeros_like(self.coeffs.clover)
        if self.coeffs.hopping is not None:
            kw["hopping"] = jnp.zeros_like(self.coeffs.hopping)
        self.coeffs = self.coeffs.replace(**kw)
        self.invalidate_derived()

    def prune_stencils(self, clover: bool = False, hopping: bool = False):
        """Drop coefficient pieces (reference prune_stencils,
        stencil_2d.h:379-404)."""
        kw = {}
        if clover:
            kw["clover"] = None
        if hopping:
            kw["hopping"] = None
        if kw:
            self.coeffs = dataclasses.replace(self.coeffs, **kw)
            self.invalidate_derived()

    def try_prune_stencils(self, tol: float, clover: bool = True,
                           hopping: bool = True):
        """Drop pieces whose max-norm is below tol (reference
        try_prune_stencils, stencil_2d.h:407-431)."""
        drop_c = (clover and self.coeffs.clover is not None and
                  float(jnp.max(jnp.abs(self.coeffs.clover))) < tol)
        drop_h = (hopping and self.coeffs.hopping is not None and
                  float(jnp.max(jnp.abs(self.coeffs.hopping))) < tol)
        self.prune_stencils(clover=drop_c, hopping=drop_h)

    def invalidate_derived(self):
        """Reference kills dagger/rbjacobi builds on update_links
        (e.g. operators/wilson.h:211-225)."""
        self._dagger = None
        self._rbjacobi = None
        self._rbj_dagger = None
        self._rbj_schur_fused = None
        self._version = next_state_version()

    # --- lazily built derived stencils ---
    @property
    def built_dagger(self) -> bool:
        return self._dagger is not None

    @property
    def built_rbjacobi(self) -> bool:
        return self._rbjacobi is not None

    @property
    def built_rbj_dagger(self) -> bool:
        return self._rbj_dagger is not None

    def build_dagger_stencil(self) -> StencilCoeffs:
        if self._dagger is None:
            # ensure_compile_time_eval: lazy builds may be triggered inside
            # a jit trace (omnistaging would otherwise stage the build and
            # leak tracers into this cache); the coefficients are concrete.
            with jax.ensure_compile_time_eval():
                self._dagger = build_dagger(self.coeffs)
        return self._dagger

    def build_rbjacobi_stencil(self) -> RBJacobiSet:
        if self._rbjacobi is None:
            def _zero(v):
                # Traced shifts (planes-solver patching) can't be compared
                # concretely; treat them as potentially nonzero.
                try:
                    return complex(v) == 0
                except Exception:
                    return False
            if (self.coeffs.clover is None
                    and _zero(self.coeffs.shift)
                    and _zero(self.coeffs.eo_shift)
                    and _zero(self.coeffs.dof_shift)):
                raise ValueError(
                    "rbjacobi requires a clover term or shift "
                    "(reference stencil_2d.h:1471-1475)")
            with jax.ensure_compile_time_eval():
                self._rbjacobi = build_rbjacobi(self.coeffs)
        return self._rbjacobi

    def build_rbj_dagger_stencil(self) -> RBJacobiSet:
        if self._rbj_dagger is None:
            rbj = self.build_rbjacobi_stencil()
            with jax.ensure_compile_time_eval():
                self._rbj_dagger = build_rbj_dagger(rbj)
        return self._rbj_dagger

    @property
    def dagger_coeffs(self) -> StencilCoeffs:
        return self.build_dagger_stencil()

    @property
    def rbjacobi(self) -> RBJacobiSet:
        return self.build_rbjacobi_stencil()

    @property
    def rbj_dagger(self) -> RBJacobiSet:
        return self.build_rbj_dagger_stencil()

    def prebuild_derived(self, stype: StencilType):
        """Materialize the lazy derived sets ``apply_M(x, stype)`` (and
        its prepare/reconstruct pair) will need.

        Order matters under jit with TRACED coefficients (the planes
        solver patches decoded state in): if the first build triggered
        inside a Krylov ``lax.while_loop`` body trace, the whole
        QR / B^-1 / Schur-composition chain would be traced INTO the
        loop body and recomputed EVERY iteration. Calling this
        at the top trace level caches the built arrays so loop bodies
        close over them as loop constants.
        """
        t = StencilType(stype)
        if t in (StencilType.DAGGER, StencilType.M_MDAGGER,
                 StencilType.MDAGGER_M):
            self.build_dagger_stencil()
        elif t == StencilType.RIGHT_JACOBI:
            self.build_rbjacobi_stencil()
        elif t == StencilType.RIGHT_SCHUR:
            rbj = self.build_rbjacobi_stencil()
            if rbj.coeffs.hopping is not None and self.lat.volume > 1:
                if self._rbj_schur_fused is None:
                    with jax.ensure_compile_time_eval():
                        self._rbj_schur_fused = build_rbj_schur_fused(rbj)
        elif t in (StencilType.RBJ_DAGGER, StencilType.RBJ_M_MDAGGER,
                   StencilType.RBJ_MDAGGER_M):
            self.build_rbj_dagger_stencil()

    # --- uniform dispatch (reference :2418-2527) ---
    def apply_M(self, x, stype: StencilType = StencilType.ORIGINAL):
        t = StencilType(stype)
        if t == StencilType.ORIGINAL:
            if self.apply_override is not None:
                return self.apply_override(x)
            return apply_M(self.coeffs, x)
        if t == StencilType.DAGGER:
            return apply_M(self.dagger_coeffs, x)
        if t == StencilType.RIGHT_JACOBI:
            return apply_M(self.rbjacobi.coeffs, x)
        if t == StencilType.RIGHT_SCHUR:
            rbj = self.rbjacobi
            if rbj.coeffs.hopping is None or self.lat.volume <= 1:
                return apply_rbj_schur(rbj, x)
            if self._rbj_schur_fused is None:
                with jax.ensure_compile_time_eval():
                    self._rbj_schur_fused = build_rbj_schur_fused(rbj)
            return apply_rbj_schur_fused(self._rbj_schur_fused, x)
        if t == StencilType.M_MDAGGER:
            return apply_M(self.coeffs, apply_M(self.dagger_coeffs, x))
        if t == StencilType.MDAGGER_M:
            return apply_M(self.dagger_coeffs, apply_M(self.coeffs, x))
        if t == StencilType.RBJ_DAGGER:
            return apply_M(self.rbj_dagger.coeffs, x)
        if t == StencilType.RBJ_M_MDAGGER:
            return apply_M(self.rbjacobi.coeffs,
                           apply_M(self.rbj_dagger.coeffs, x))
        if t == StencilType.RBJ_MDAGGER_M:
            return apply_M(self.rbj_dagger.coeffs,
                           apply_M(self.rbjacobi.coeffs, x))
        raise ValueError(f"invalid stencil type {stype}")

    def prepare_M(self, b, stype: StencilType = StencilType.ORIGINAL):
        """b -> b_prep for the chosen solve (reference :2455-2490)."""
        t = StencilType(stype)
        if t == StencilType.RIGHT_SCHUR:
            return prepare_rbj_schur(self.rbjacobi, b)
        if t == StencilType.MDAGGER_M:
            return apply_M(self.dagger_coeffs, b)
        if t == StencilType.RBJ_MDAGGER_M:
            return apply_M(self.rbj_dagger.coeffs, b)
        return b

    def reconstruct_M(self, y, b, stype: StencilType = StencilType.ORIGINAL):
        """y (solve result) -> x (solution of M x = b) (reference :2492-2527)."""
        t = StencilType(stype)
        if t == StencilType.RIGHT_JACOBI:
            return linalg.site_matvec(self.rbjacobi.cinv, y)
        if t == StencilType.RIGHT_SCHUR:
            return reconstruct_rbj_schur(self.rbjacobi, y, b)
        if t == StencilType.M_MDAGGER:
            return apply_M(self.dagger_coeffs, y)
        if t == StencilType.RBJ_M_MDAGGER:
            return linalg.site_matvec(self.rbjacobi.cinv,
                                      apply_M(self.rbj_dagger.coeffs, y))
        if t == StencilType.RBJ_MDAGGER_M:
            return linalg.site_matvec(self.rbjacobi.cinv, y)
        return y

    def get_apply_function(self, stype: StencilType = StencilType.ORIGINAL):
        """Closure analog of the reference's C function pointers
        (stencil_2d.h:2530-2566)."""
        t = StencilType(stype)
        return lambda x: self.apply_M(x, t)

    def solve_size_shape(self, stype: StencilType):
        """Shape of the Krylov vector for a given solve type."""
        lat = self.lat
        if StencilType(stype) == StencilType.RIGHT_SCHUR:
            return (lat.y_len, lat.xh, lat.nc)
        return lat.cv_shape()

    def print_stencil_site(self, x: int, y: int, prefix: str = "",
                           which: str = "original"):
        """Print the full stencil at one site (reference print_stencil_site,
        stencil_2d.h:447-635; dagger/rbjacobi variants :1182-1193,
        :1642-1667)."""
        import numpy as np
        if which == "original":
            coeffs, cinv = self.coeffs, None
        elif which == "dagger":
            coeffs, cinv = self.dagger_coeffs, None
        elif which == "rbjacobi":
            coeffs, cinv = self.rbjacobi.coeffs, self.rbjacobi.cinv
        elif which == "rbj_dagger":
            coeffs, cinv = self.rbj_dagger.coeffs, self.rbj_dagger.cinv
        else:
            raise ValueError(f"unknown stencil variant {which}")
        p, yy, xh = self.lat.coord_to_pyx(x, y)
        for name, val in (("Shift", coeffs.shift),
                          ("EO-Shift", coeffs.eo_shift),
                          ("DOF-Shift", coeffs.dof_shift)):
            if complex(val) != 0:
                print(f"{prefix}{name} {complex(val)}")
        if coeffs.clover is not None:
            print(f"{prefix}Clover")
            for row in np.asarray(coeffs.clover[p, yy, xh]):
                print(prefix + " ".join(str(v) for v in row))
        if coeffs.hopping is not None:
            for d, label in enumerate(("+x", "+y", "-x", "-y")):
                print(f"{prefix}Hopping {label}")
                for row in np.asarray(coeffs.hopping[d, p, yy, xh]):
                    print(prefix + " ".join(str(v) for v in row))
        if cinv is not None:
            print(f"{prefix}Right Block Jacobi Inv Clover")
            for row in np.asarray(cinv[p, yy, xh]):
                print(prefix + " ".join(str(v) for v in row))

    # --- chirality interface (reference :977-1073); operators override ---
    @staticmethod
    def get_dof(i: int = 0) -> int:
        return -1

    @staticmethod
    def has_chirality() -> ChiralityState:
        return ChiralityState.UNKNOWN

    def get_default_chirality(self) -> DefaultChirality:
        raise NotImplementedError

    def gamma5(self, x):
        """Default: identity (reference :978-987)."""
        return x

    def sigma1(self, x):
        """Default sigma1: swap dof halves (reference coarse sigma1 pattern,
        operators/coarse.h:526-541); identity for odd nc."""
        nc = self.lat.nc
        if nc % 2:
            return x
        half = nc // 2
        return jnp.concatenate([x[..., half:], x[..., :half]], axis=-1)

    def chiral_projection(self, x, is_up: bool):
        raise NotImplementedError

    def chiral_projection_both(self, x):
        """Returns (up, down) projections (reference :997)."""
        return (self.chiral_projection(x, True),
                self.chiral_projection(x, False))

    def apply_sigma(self, x, stype: SigmaType = SigmaType.DEFAULT):
        """Reference apply_sigma (:1015-1073)."""
        t = SigmaType(stype)
        if t == SigmaType.NONE:
            return x
        if t == SigmaType.DEFAULT:
            dc = self.get_default_chirality()
            if dc == DefaultChirality.GAMMA_5:
                return self.gamma5(x)
            if dc == DefaultChirality.SIGMA_1:
                return self.sigma1(x)
            return x
        if t == SigmaType.GAMMA_5:
            return self.gamma5(x)
        if t == SigmaType.SIGMA_1:
            return self.sigma1(x)
        if t == SigmaType.GAMMA_5_R_RBJ:
            # B gamma_5 (reference :1045-1058).
            g = self.gamma5(x)
            out = apply_clover(self.coeffs, g)
            return out + self.coeffs.shift * g
        if t == SigmaType.GAMMA_5_L_RBJ:
            # B^{-dagger} gamma_5 (reference :1059-1071).
            g = self.gamma5(x)
            return linalg.site_matvec(self.rbj_dagger.cinv, g)
        raise ValueError(f"invalid sigma type {stype}")
