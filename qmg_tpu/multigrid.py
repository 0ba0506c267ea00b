"""Multigrid hierarchy: the level stack.

JAX counterpart of reference multigrid/multigrid.h:54-600.

Holds parallel per-level lists of (lattice, transfer, stencil, saved
global null vectors); supports push/pop/update of levels and applying a
level's stencil - emulated by prolong -> fine apply -> restrict when the
coarse stencil was not built (reference apply_stencil, :465-512).

The reference's ArrayStorageMG vector pool (storage/array_storage.h) is
unnecessary here - XLA owns buffer lifetimes - but a compatible shim
lives in storage.py for API parity.
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp

from .lattice import Lattice2D
from .stencil import Stencil2D, StencilType
from .transfer import TransferMG
from .operators.coarse import CoarseOperator2D

# Reference QMGMultigridPrecondStencil (multigrid/multigrid.h:92-96).
PRECOND_ORIGINAL = 0
PRECOND_RIGHT_BLOCK_JACOBI = 1


class MultigridMG:
    def __init__(self, lat: Lattice2D, stencil: Stencil2D):
        self.lattice_list: List[Lattice2D] = [lat]
        self.stencil_list: List[Optional[Stencil2D]] = [stencil]
        self.transfer_list: List[TransferMG] = []
        self.is_stencil_managed: List[bool] = [False]
        self.global_null_vectors: List[Optional[jnp.ndarray]] = []

    def get_num_levels(self) -> int:
        return len(self.lattice_list)

    def get_lattice(self, i: int) -> Lattice2D:
        return self.lattice_list[i]

    def get_transfer(self, i: int) -> TransferMG:
        return self.transfer_list[i]

    def get_stencil(self, i: int) -> Optional[Stencil2D]:
        return self.stencil_list[i]

    def get_global_null_vectors(self, i: int):
        return self.global_null_vectors[i]

    def push_level(self, new_lat: Lattice2D, new_transfer: TransferMG,
                   build_stencil: bool = False, is_chiral: bool = False,
                   build_stencil_from: int = PRECOND_ORIGINAL,
                   build_extra: int = CoarseOperator2D.BUILD_ORIGINAL,
                   nvecs=None):
        """Reference push_level (multigrid/multigrid.h:257-302)."""
        self.lattice_list.append(new_lat)
        self.transfer_list.append(new_transfer)
        if build_stencil:
            fine_stencil = self.stencil_list[-1]
            coarse = CoarseOperator2D(
                new_lat, fine_stencil, new_transfer, is_chiral=is_chiral,
                use_rbjacobi=(build_stencil_from
                              == PRECOND_RIGHT_BLOCK_JACOBI),
                build_extra=build_extra)
            self.stencil_list.append(coarse)
            self.is_stencil_managed.append(True)
        else:
            self.stencil_list.append(None)
            self.is_stencil_managed.append(False)
        self.global_null_vectors.append(
            None if nvecs is None else jnp.asarray(nvecs))

    def pop_level(self):
        """Reference pop_level (:324-372)."""
        if self.get_num_levels() == 1:
            raise ValueError("cannot pop the only level")
        self.lattice_list.pop()
        self.transfer_list.pop()
        self.stencil_list.pop()
        self.is_stencil_managed.pop()
        self.global_null_vectors.pop()

    def update_level(self, level: int, new_lat: Lattice2D,
                     new_transfer: TransferMG, build_stencil: bool = False,
                     is_chiral: bool = False,
                     build_stencil_from: int = PRECOND_ORIGINAL,
                     build_extra: int = CoarseOperator2D.BUILD_ORIGINAL,
                     nvecs=None):
        """Reference update_level (:375-450) - in-place pop+push, used by
        the adaptive setup."""
        if level < 1 or level >= self.get_num_levels():
            raise ValueError(f"cannot update level {level}")
        self.lattice_list[level] = new_lat
        self.transfer_list[level - 1] = new_transfer
        if build_stencil:
            self.stencil_list[level] = CoarseOperator2D(
                new_lat, self.stencil_list[level - 1], new_transfer,
                is_chiral=is_chiral,
                use_rbjacobi=(build_stencil_from
                              == PRECOND_RIGHT_BLOCK_JACOBI),
                build_extra=build_extra)
            self.is_stencil_managed[level] = True
        else:
            self.stencil_list[level] = None
            self.is_stencil_managed[level] = False
        self.global_null_vectors[level - 1] = (
            None if nvecs is None else jnp.asarray(nvecs))

    def apply_stencil(self, x, level: int,
                      app_type: StencilType = StencilType.ORIGINAL):
        """Apply the level's operator; emulate via transfer recursion when
        the stencil was not built (reference apply_stencil, :465-512)."""
        st = self.stencil_list[level]
        if st is not None:
            return st.apply_M(x, app_type)
        if StencilType(app_type) != StencilType.ORIGINAL:
            raise ValueError("emulated operator must be ORIGINAL "
                             "(reference multigrid/multigrid.h:478-482)")
        t = self.transfer_list[level - 1]
        fine = t.prolong_c2f(x)
        afine = self.apply_stencil(fine, level - 1)
        return t.restrict_f2c(afine)

    def prolong_c2f(self, coarse, i: int):
        return self.transfer_list[i].prolong_c2f(coarse)

    def restrict_f2c(self, fine, i: int):
        return self.transfer_list[i].restrict_f2c(fine)
