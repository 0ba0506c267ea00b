"""Periodic nearest-neighbor shifts on eo-packed fields.

JAX counterpart of the reference cshift layer
(reference: cshift/cshift_2d.h:45-236), which is the reference's entire
communication story (its periodic-wrap loops are marked "Becomes MPI",
cshift/cshift_2d.h:72,89,101,114).

Semantics (decoded from cshift_2d.h): ``cshift(lhs, rhs, FROM_D, parity)``
is a *pull*: for destination sites (the opposite parity of the source for
distance-1 shifts), ``lhs[site] = rhs[site + D]`` with periodic wrap.

On the (2, Y, X/2, dof...) eo layout this lowers to pure rolls + row-parity
selects - no gathers, no halo indexing:

  * +-y shifts: a roll along the Y axis with a parity swap.
  * +-x shifts: within each destination row, either a direct copy or a
    roll by one along the packed-x axis, depending on the row parity
    (because eo-packing halves the x stride - the same alternation the
    reference hand-codes at cshift/cshift_2d.h:60-93).

When the lattice is sharded over a device mesh (parallel.py), XLA lowers
the wrapped rows/columns of these rolls to collective-permutes.
"""

from __future__ import annotations

import jax.numpy as jnp

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1

__all__ = [
    "cshift_pull", "cshift_pull_half", "DIR_XP1", "DIR_YP1", "DIR_XM1",
    "DIR_YM1", "ALL_DIRS", "DIR_XP2", "DIR_YP2", "DIR_XM2", "DIR_YM2",
    "DIR_XP1YP1", "DIR_XM1YP1", "DIR_XM1YM1", "DIR_XP1YM1",
    "TWOLINK_DIRS", "CORNER_DIRS",
]

ALL_DIRS = (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1)

# Distance-2 and corner shifts. The reference DECLARES these directions
# (cshift/cshift_2d.h:13-29: FROM_XP2/YP2/XM2/YM2 and the four corners)
# but leaves them unimplemented (hard errors at cshift_2d.h:120-129,
# :211-220); here they are first-class. Both families preserve parity
# (x+y changes by 0 or +-2), so the destination parity-q half is sourced
# from the SAME parity half - on the (2, Y, Xh) eo layout the distance-2
# shifts are pure rolls (eo-packing halves the x stride, so +-2x is one
# packed column), and the corners compose two distance-1 pulls.
#
# Codes 4..11 extend the per-piece 0..3 indices of lattice.py; the tuple
# orderings below match the reference coefficient layouts
# (stencil/stencil_2d.h:28-39: twolink {+2X,+2Y,-2X,-2Y}, corner
# {+X+Y,-X+Y,-X-Y,+X-Y}), so TWOLINK_DIRS[i]/CORNER_DIRS[i] is the pull
# for coefficient slot i.
DIR_XP2 = 4
DIR_YP2 = 5
DIR_XM2 = 6
DIR_YM2 = 7
DIR_XP1YP1 = 8
DIR_XM1YP1 = 9
DIR_XM1YM1 = 10
DIR_XP1YM1 = 11

TWOLINK_DIRS = (DIR_XP2, DIR_YP2, DIR_XM2, DIR_YM2)
CORNER_DIRS = (DIR_XP1YP1, DIR_XM1YP1, DIR_XM1YM1, DIR_XP1YM1)

# Corner pull = composition of two distance-1 pulls:
# (pull_D1 . pull_D2)(f)[s] = pull_D2(f)[s + D1] = f[s + D1 + D2].
_CORNER_PARTS = {
    DIR_XP1YP1: (DIR_XP1, DIR_YP1),
    DIR_XM1YP1: (DIR_XM1, DIR_YP1),
    DIR_XM1YM1: (DIR_XM1, DIR_YM1),
    DIR_XP1YM1: (DIR_XP1, DIR_YM1),
}


def _row_parity_mask(y_len: int, q: int, dof_ndim: int):
    """Boolean (Y, 1, [1]*dof_ndim) mask of rows with y % 2 == q."""
    y = jnp.arange(y_len) % 2 == (q % 2)
    return y.reshape((y_len, 1) + (1,) * dof_ndim)


def _pull_x_half(src, q: int, sign: int):
    """Pull along +-x from parity (1-q) source half into parity-q slots.

    src: (Y, Xh, dof...) array living on parity 1-q.
    Returns (Y, Xh, dof...) array of values at dest_site +- xhat, aligned to
    parity-q packed slots.

    Derivation: dest x = 2*xh + (y+q)%2. For +x (sign=+1) the source column
    is xh when (y+q)%2 == 0 (i.e. y%2 == q) else xh+1; for -x (sign=-1) it
    is xh when (y+q)%2 == 1 else xh-1.
    """
    y_len = src.shape[0]
    dof_ndim = src.ndim - 2
    if sign > 0:
        rolled = jnp.roll(src, -1, axis=1)
        direct_rows = _row_parity_mask(y_len, q, dof_ndim)
    else:
        rolled = jnp.roll(src, 1, axis=1)
        direct_rows = _row_parity_mask(y_len, 1 - q, dof_ndim)
    return jnp.where(direct_rows, src, rolled)


def cshift_pull(field, direction: int):
    """Full-lattice pull-shift: out[site] = field[site + direction].

    field: (2, Y, Xh, dof...) eo-packed array. Returns same shape. The
    destination parity-q half is sourced from the parity-(1-q) half, exactly
    as the reference's paired cshift_from_even/cshift_from_odd calls with
    QMG_EO_FROM_EVENODD (cshift/cshift_2d.h:225-236).
    """
    if direction == DIR_YP1:
        # out[q, y] = field[1-q, y+1]
        swapped = field[::-1]
        return jnp.roll(swapped, -1, axis=1)
    if direction == DIR_YM1:
        swapped = field[::-1]
        return jnp.roll(swapped, 1, axis=1)
    if direction == DIR_XP1:
        return jnp.stack(
            [_pull_x_half(field[1], 0, +1), _pull_x_half(field[0], 1, +1)])
    if direction == DIR_XM1:
        return jnp.stack(
            [_pull_x_half(field[1], 0, -1), _pull_x_half(field[0], 1, -1)])
    # Same-parity families (distance-2, corners).
    if direction == DIR_XP2:
        return jnp.roll(field, -1, axis=2)
    if direction == DIR_XM2:
        return jnp.roll(field, 1, axis=2)
    if direction == DIR_YP2:
        return jnp.roll(field, -2, axis=1)
    if direction == DIR_YM2:
        return jnp.roll(field, 2, axis=1)
    if direction in _CORNER_PARTS:
        d1, d2 = _CORNER_PARTS[direction]
        return cshift_pull(cshift_pull(field, d2), d1)
    raise ValueError(f"unsupported cshift direction {direction}")


def cshift_pull_half(src_half, src_parity: int, direction: int):
    """Half-lattice pull-shift for even-odd preconditioned operators.

    src_half: (Y, Xh, dof...) array on parity ``src_parity``. Returns the
    pulled values ``out[dest_site] = src[dest_site + direction]``, aligned
    to the destination parity's packed slots: parity ``1 - src_parity``
    for the distance-1 directions, parity ``src_parity`` for the
    parity-preserving distance-2 and corner directions.

    Used by the Schur/eo paths (e.g. apply_M_eo reads the odd half and
    writes the even half, reference stencil/stencil_2d.h:706-733) without
    materializing the unused half.
    """
    q = 1 - src_parity
    if direction == DIR_YP1:
        return jnp.roll(src_half, -1, axis=0)
    if direction == DIR_YM1:
        return jnp.roll(src_half, 1, axis=0)
    if direction == DIR_XP1:
        return _pull_x_half(src_half, q, +1)
    if direction == DIR_XM1:
        return _pull_x_half(src_half, q, -1)
    # Same-parity families: destination parity == src_parity.
    if direction == DIR_XP2:
        return jnp.roll(src_half, -1, axis=1)
    if direction == DIR_XM2:
        return jnp.roll(src_half, 1, axis=1)
    if direction == DIR_YP2:
        return jnp.roll(src_half, -2, axis=0)
    if direction == DIR_YM2:
        return jnp.roll(src_half, 2, axis=0)
    if direction in _CORNER_PARTS:
        # Corner on one half: y-roll to the source row, then the same
        # row-parity-conditional packed-x move as distance-1, but with
        # the mask parity q = src_parity (the dest row's packing offset
        # (y+p)%2 decides whether +-x crosses a packed-column boundary).
        dx, dy = _CORNER_PARTS[direction]
        rolled = jnp.roll(src_half, -1 if dy == DIR_YP1 else 1, axis=0)
        return _pull_x_half(rolled, src_parity, +1 if dx == DIR_XP1 else -1)
    raise ValueError(f"unsupported cshift direction {direction}")
