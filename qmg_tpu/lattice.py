"""Lattice geometry and even-odd index algebra.

JAX counterpart of the reference ``Lattice2D``
(reference: lattice/lattice.h:12-396).

The reference stores every field as a flat ``complex<double>*`` over an
even-odd (checkerboard) partitioned 2D lattice:

    index = parity * (volume/2) + y * (X/2) + x//2,   parity = (x+y) % 2

(reference: lattice/lattice.h:75-81 ``coord_to_index`` and :199-205
``index_to_coord``).

In this framework the same ordering becomes an explicit array layout: a
field with ``dof`` degrees of freedom per site is a device array of shape

    (2, Y, X//2, dof...)        # parity-major, "eo-packed x"

so ``field.reshape(-1)`` reproduces the reference's flat ordering exactly
(with dof innermost). Within a row ``y`` at parity ``p`` the physical x
coordinate of packed column ``xh`` is::

    x = 2*xh + ((y + p) % 2)

All index conversions below are plain Python/NumPy (host-side metadata);
device code never materializes index maps - shifts are rolls and selects
(see cshift.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Direction indices for gauge/hopping arrays, matching
# reference stencil/stencil_2d.h:25-40 (QMG_DIR_INDEX_*).
DIR_XP1 = 0
DIR_YP1 = 1
DIR_XM1 = 2
DIR_YM1 = 3


@dataclasses.dataclass(frozen=True)
class Lattice2D:
    """Static metadata for a 2D even-odd lattice.

    Mirrors reference lattice/lattice.h:31-68 (sizes) and the coord/index
    conversion families (:75-282).
    """

    x_len: int
    y_len: int
    nc: int

    def __post_init__(self):
        if self.volume > 1:
            if self.x_len % 2 != 0:
                raise ValueError(
                    f"even-odd layout requires even X (got {self.x_len})")

    # --- sizes (reference lattice/lattice.h:31-42) ---
    @property
    def dims(self):
        return (self.x_len, self.y_len)

    @property
    def volume(self) -> int:
        return self.x_len * self.y_len

    @property
    def size_cv(self) -> int:
        return self.volume * self.nc

    @property
    def size_cm(self) -> int:
        return self.size_cv * self.nc

    @property
    def size_gauge(self) -> int:
        return self.size_cm * 2

    @property
    def size_hopping(self) -> int:
        return self.size_gauge * 2

    @property
    def size_corner(self) -> int:
        return self.size_gauge * 2

    @property
    def xh(self) -> int:
        """Packed x extent (X/2). For volume==1 lattices this is 1."""
        return max(self.x_len // 2, 1)

    def get_dim_mu(self, mu: int) -> int:
        return self.dims[mu] if 0 <= mu < 2 else -1

    def get_nc(self) -> int:
        return self.nc

    def get_volume(self) -> int:
        return self.volume

    def with_nc(self, nc: int) -> "Lattice2D":
        """Functional analog of reference update_nc (lattice/lattice.h:60-68)."""
        return Lattice2D(self.x_len, self.y_len, nc)

    # --- shapes for device arrays ---
    def cv_shape(self):
        """(2, Y, X/2, nc) color-vector field."""
        return (2, self.y_len, self.xh, self.nc)

    def cm_shape(self):
        """(2, Y, X/2, nc, nc) color-matrix field; [..., c1, c2], c1=row."""
        return (2, self.y_len, self.xh, self.nc, self.nc)

    def gauge_shape(self):
        """(2=mu, 2, Y, X/2, nc, nc) gauge field, mu in {+x,+y}."""
        return (2, 2, self.y_len, self.xh, self.nc, self.nc)

    def hopping_shape(self):
        """(4=dir, 2, Y, X/2, nc, nc), dir in {+x,+y,-x,-y}."""
        return (4, 2, self.y_len, self.xh, self.nc, self.nc)

    # --- coordinate conversions (host-side) ---
    def coord_to_pyx(self, x: int, y: int):
        """(x, y) -> (parity, y, xh). Reference coord_to_index semantics."""
        if self.volume == 1:
            return 0, 0, 0
        p = (x + y) % 2
        return p, y, (x // 2) % self.xh

    def coord_to_index(self, x: int, y: int) -> int:
        """Flat eo index of a site (reference lattice/lattice.h:75-81)."""
        p, y, xh = self.coord_to_pyx(x, y)
        return p * (self.volume // 2) + y * self.xh + xh

    def index_to_coord(self, i: int):
        """Inverse flat-index map (reference lattice/lattice.h:199-205)."""
        if self.volume == 1:
            return 0, 0
        p = i // (self.volume // 2)
        y = i // self.xh - p * self.y_len
        x = 2 * (i % self.xh) + (y % 2 + p) % 2
        return x, y

    def cv_coord_to_flat(self, x: int, y: int, c: int) -> int:
        return self.nc * self.coord_to_index(x, y) + c

    def x_of(self, p, y, xh):
        """Physical x coordinate array for parity/row/packed-column arrays."""
        return 2 * np.asarray(xh) + (np.asarray(y) + np.asarray(p)) % 2

    def x_coord_grid(self) -> np.ndarray:
        """(2, Y, X/2) int array of physical x coordinates per packed slot."""
        p = np.arange(2)[:, None, None]
        y = np.arange(self.y_len)[None, :, None]
        xh = np.arange(self.xh)[None, None, :]
        if self.volume == 1:
            return np.zeros((2, 1, 1), dtype=np.int64)
        return 2 * xh + (y + p) % 2

    def y_coord_grid(self) -> np.ndarray:
        """(2, Y, X/2) int array of y coordinates per packed slot."""
        y = np.arange(self.y_len)[None, :, None]
        return np.broadcast_to(y, (2, self.y_len, self.xh)).copy()


def eo_pack(grid: np.ndarray, lat: Lattice2D) -> np.ndarray:
    """Convert a full-grid array (Y, X, dof...) to eo layout (2, Y, X/2, dof...).

    Host-side utility (I/O, tests); device code stays in eo layout.
    """
    grid = np.asarray(grid)
    dof_shape = grid.shape[2:]
    out = np.empty((2, lat.y_len, lat.xh) + dof_shape, dtype=grid.dtype)
    xc = lat.x_coord_grid()  # (2, Y, Xh)
    yc = lat.y_coord_grid()
    out[...] = grid[yc, xc]
    return out


def eo_unpack(field: np.ndarray, lat: Lattice2D) -> np.ndarray:
    """Convert an eo-layout array (2, Y, X/2, dof...) back to (Y, X, dof...)."""
    field = np.asarray(field)
    dof_shape = field.shape[3:]
    out = np.empty((lat.y_len, lat.x_len) + dof_shape, dtype=field.dtype)
    xc = lat.x_coord_grid()
    yc = lat.y_coord_grid()
    out[yc, xc] = field
    return out
