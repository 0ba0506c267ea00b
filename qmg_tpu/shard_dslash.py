"""Explicitly-sharded Dslash: shard_map + ppermute halo exchange.

The jit auto-sharding path (parallel.py) lets XLA's SPMD partitioner
derive the collectives from jnp.roll. This module is the hand-scheduled
production alternative: the lattice block lives per-device, boundary
slices move between devices with lax.ppermute (NCCL on GPUs), and the
interior math is the same stencil apply - the JAX realization of the
halo exchange the reference marks "Becomes MPI"
(cshift/cshift_2d.h:72,89,101,114).

The (Y, Xh) axes shard over a ("y", "x") mesh; local extents must keep
Y_loc even (so global row parity equals local row parity) and the
blocked MG transfer aligned. Works for any distance-1 stencil.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1
from .stencil import StencilCoeffs, apply_shift
from . import linalg


def _halo_roll(a, shift: int, axis: int, axis_name: str, n_shards: int):
    """Global periodic roll of a sharded axis: local roll + boundary
    slice exchanged with the ring neighbor."""
    rolled = jnp.roll(a, shift, axis=axis)
    if n_shards == 1:
        return rolled
    size = a.shape[axis]
    if shift == -1:
        # pull from +axis: my last slot needs the neighbor's first slice.
        edge = lax.slice_in_dim(a, 0, 1, axis=axis)
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = lax.ppermute(edge, axis_name, perm)
        return lax.dynamic_update_slice_in_dim(rolled, recv, size - 1,
                                               axis=axis)
    if shift == 1:
        edge = lax.slice_in_dim(a, size - 1, size, axis=axis)
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        recv = lax.ppermute(edge, axis_name, perm)
        return lax.dynamic_update_slice_in_dim(rolled, recv, 0, axis=axis)
    raise ValueError("only distance-1 shifts")


def _row_parity_mask(y_loc: int, q: int, dof_ndim: int):
    y = jnp.arange(y_loc) % 2 == (q % 2)
    return y.reshape((y_loc, 1) + (1,) * dof_ndim)


def _pull_x_half_sharded(src, q: int, sign: int, nx: int):
    """Sharded version of cshift._pull_x_half: the packed-x roll crosses
    the x-shard boundary. Valid when Y_loc is even (global row parity ==
    local row parity)."""
    dof_ndim = src.ndim - 2
    if sign > 0:
        rolled = _halo_roll(src, -1, 1, "x", nx)
        direct = _row_parity_mask(src.shape[0], q, dof_ndim)
    else:
        rolled = _halo_roll(src, 1, 1, "x", nx)
        direct = _row_parity_mask(src.shape[0], 1 - q, dof_ndim)
    return jnp.where(direct, src, rolled)


def _cshift_pull_sharded(field, direction: int, ny: int, nx: int):
    """cshift.cshift_pull on a local (2, Y_loc, Xh_loc, dof...) block with
    ppermute halo exchange on the wrapped rows/columns."""
    if direction == DIR_YP1:
        return _halo_roll(field[::-1], -1, 1, "y", ny)
    if direction == DIR_YM1:
        return _halo_roll(field[::-1], 1, 1, "y", ny)
    if direction == DIR_XP1:
        return jnp.stack([_pull_x_half_sharded(field[1], 0, +1, nx),
                          _pull_x_half_sharded(field[0], 1, +1, nx)])
    if direction == DIR_XM1:
        return jnp.stack([_pull_x_half_sharded(field[1], 0, -1, nx),
                          _pull_x_half_sharded(field[0], 1, -1, nx)])
    raise ValueError(f"unsupported direction {direction}")


def make_sharded_dslash(coeffs: StencilCoeffs, mesh: Mesh):
    """Returns a jittable x -> M x with explicit halo exchange.

    The returned function takes/returns global arrays (jit handles the
    device placement via the mesh shardings); inside, shard_map runs the
    per-device block stencil with ppermute for the four halos.
    """
    lat = coeffs.lat
    ny, nx = mesh.devices.shape
    if lat.y_len % ny or lat.xh % nx:
        raise ValueError(f"lattice ({lat.y_len}, {lat.xh}) does not tile "
                         f"the mesh {mesh.devices.shape}")
    if (lat.y_len // ny) % 2:
        raise ValueError("Y_loc must be even so local row parity equals "
                         "global row parity")

    fspec = P(None, "y", "x", None)
    cspec = P(None, "y", "x", None, None)
    hspec = P(None, None, "y", "x", None, None)

    def local_apply(clover, hopping, x):
        out = jnp.zeros_like(x)
        if clover is not None:
            out = out + linalg.site_matvec(clover, x)
        if hopping is not None:
            for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
                pulled = _cshift_pull_sharded(x, d, ny, nx)
                out = out + linalg.site_matvec(hopping[d], pulled)
        # Shifts are diagonal and parity-local: Y_loc even keeps the
        # global eo pattern intact per block.
        out = out + apply_shift(coeffs.replace(clover=None, hopping=None),
                                x)
        return out

    sharded = shard_map(
        local_apply, mesh=mesh,
        in_specs=(cspec if coeffs.clover is not None else P(),
                  hspec if coeffs.hopping is not None else P(),
                  fspec),
        out_specs=fspec)

    def apply_fn(x):
        return sharded(coeffs.clover, coeffs.hopping, x)

    return apply_fn
