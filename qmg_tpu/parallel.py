"""Device-mesh sharding: domain decomposition over the devices' links.

The reference is single-process; its halo-exchange story is the "Becomes
MPI" markers in cshift (cshift/cshift_2d.h:72,89,101,114 - never written).
Here distribution is first-class (SURVEY.md 2.10):

  * The lattice's (Y, Xh) axes shard over a 2D jax Mesh ("y", "x").
  * cshift stays written as rolls; under jit with sharded operands XLA's
    SPMD partitioner lowers the wrapped rows/columns to collective
    permutes (NCCL on GPUs) - the halo exchange the reference never
    wrote.
  * Global reductions (Krylov dots/norms) become all-reduces.
  * Coarse MG levels shrink below the shard grid; the intended operating
    mode replicates them (gather-to-replicated crossover), mirroring the
    reference's tiny coarsest lattices.

All shardings are data placements only - the math in stencil.py/
solvers.py is unchanged, which is exactly the XLA-native scaling recipe
(annotate shardings, let the compiler insert collectives).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .stencil import StencilCoeffs


def make_mesh(n_devices: Optional[int] = None, shape=None,
              devices=None) -> Mesh:
    """A 2D ("y", "x") mesh. With only a device count, factor it as
    close to square as possible (y-major, since Y rolls dominate)."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        ny = int(np.floor(np.sqrt(n_devices)))
        while n_devices % ny:
            ny -= 1
        shape = (n_devices // ny, ny) if ny < n_devices // ny else \
            (ny, n_devices // ny)
        shape = (max(shape), min(shape))  # more shards along y
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, axis_names=("y", "x"))


def field_spec(n_dof_axes: int) -> P:
    """PartitionSpec for a (2, Y, Xh, dof...) field."""
    return P(None, "y", "x", *([None] * n_dof_axes))


def shard_field(field, mesh: Mesh, n_dof_axes: Optional[int] = None):
    """Place a (2, Y, Xh, dof...) field on the mesh."""
    if n_dof_axes is None:
        n_dof_axes = field.ndim - 3
    return jax.device_put(field, NamedSharding(mesh, field_spec(n_dof_axes)))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_coeffs(coeffs: StencilCoeffs, mesh: Mesh) -> StencilCoeffs:
    """Place stencil coefficient arrays on the mesh: clover/hopping shard
    with the lattice; scalars replicate."""
    clover = coeffs.clover
    if clover is not None:
        clover = jax.device_put(
            clover, NamedSharding(mesh, P(None, "y", "x", None, None)))
    hopping = coeffs.hopping
    if hopping is not None:
        hopping = jax.device_put(
            hopping,
            NamedSharding(mesh, P(None, None, "y", "x", None, None)))
    return coeffs.replace(
        clover=clover, hopping=hopping,
        shift=replicate(coeffs.shift, mesh),
        eo_shift=replicate(coeffs.eo_shift, mesh),
        dof_shift=replicate(coeffs.dof_shift, mesh))


def shardable_dims(lat, mesh: Mesh) -> bool:
    """Whether (Y, Xh) divide the mesh shape."""
    my, mx = mesh.devices.shape
    return lat.y_len % my == 0 and lat.xh % mx == 0


def validate_mg_sharding(mg, mesh: Mesh, level: int = 0) -> None:
    """Check that the MG hierarchy can shard at ``level`` over ``mesh``:
    the lattice tiles the mesh with even local row count (so global row
    parity equals local row parity), and the transfer's aggregation
    blocks align with shard boundaries — every shard holds whole blocks
    (SURVEY.md hard part #2: 4x4 blocks and eo parity must tile the
    shard grid). Raises ValueError otherwise.
    """
    lat = mg.get_lattice(level)
    my, mx = mesh.devices.shape
    if lat.y_len % my or lat.xh % mx:
        raise ValueError(
            f"level-{level} lattice ({lat.y_len}, {lat.xh}) does not tile "
            f"the mesh {mesh.devices.shape}")
    if (lat.y_len // my) % 2:
        raise ValueError("Y_loc must be even so local row parity equals "
                         "global row parity")
    if level < mg.get_num_levels() - 1:
        coarse = mg.get_lattice(level + 1)
        by = lat.y_len // coarse.y_len
        bx = lat.x_len // coarse.x_len
        if bx % 2:
            raise ValueError(
                f"x blocking {bx} must be even: an odd block splits the "
                "eo-packed x axis across parities")
        y_loc, xh_loc = lat.y_len // my, lat.xh // mx
        if y_loc % by or xh_loc % (bx // 2):
            raise ValueError(
                f"MG blocking ({by} x {bx}) does not align with the shard "
                f"grid: local extents ({y_loc}, {xh_loc}) must hold whole "
                "blocks so restrict/prolong stay shard-local")


def replication_crossover(mg, mesh: Mesh) -> int:
    """First level whose lattice no longer tiles the mesh — from there
    down, levels replicate (the gather-to-replicated crossover mirroring
    the reference's tiny coarsest lattices, SURVEY.md §2.10)."""
    my, mx = mesh.devices.shape
    for lvl in range(mg.get_num_levels()):
        lat = mg.get_lattice(lvl)
        if (lat.y_len % my or lat.xh % mx or (lat.y_len // my) % 2):
            return lvl
    return mg.get_num_levels()


def replicate_coarse_levels(mg, mesh: Mesh, from_level: int = 1) -> None:
    """Explicitly replicate every level >= ``from_level`` on the mesh:
    coarse stencil coefficients, transfer null-vector tensors, and the
    direct-coarsest inverse. Coarse lattices shrink below the shard grid;
    pinning them replicated keeps XLA's partitioner from inventing
    layouts and makes the crossover explicit."""
    rep = NamedSharding(mesh, P())
    for lvl in range(from_level, mg.get_num_levels()):
        st = mg.get_stencil(lvl)
        if st is None:
            continue
        kw = {}
        if st.coeffs.clover is not None:
            kw["clover"] = jax.device_put(st.coeffs.clover, rep)
        if st.coeffs.hopping is not None:
            kw["hopping"] = jax.device_put(st.coeffs.hopping, rep)
        if kw:
            st.coeffs = st.coeffs.replace(**kw)
            st.invalidate_derived()
    for lvl in range(max(0, from_level - 1), mg.get_num_levels() - 1):
        t = mg.get_transfer(lvl)
        t._nvb = jax.device_put(t._nvb, rep)
        if t._restrict_nvb is not None:
            t._restrict_nvb = jax.device_put(t._restrict_nvb, rep)
    dinv = getattr(mg, "coarsest_dinv", None)
    if dinv is not None:
        mg.coarsest_dinv = jax.device_put(dinv, rep)
