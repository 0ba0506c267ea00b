"""Timeslice reductions and wall sources (measurement support).

JAX counterpart of reference reductions/reductions.h:24-162.

On the (2, Y, Xh, nc) eo layout, a "timeslice" (fixed y) reduction is
simply a sum over the (parity, xh, color) axes - the reference has to
walk flat indices through cv_index_to_coord instead (reductions.h:35-40).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .lattice import Lattice2D

__all__ = ["norm2sq_timeslice", "redot_timeslice", "dot_timeslice",
           "gaussian_wall_source", "gaussian_wall_source_real",
           "gaussian_wall_source_complex"]


def norm2sq_timeslice(cv):
    """Per-y |cv|^2 sums -> (Y,) real (reference norm2sq_cv_timeslice)."""
    return jnp.sum(jnp.abs(cv) ** 2, axis=(0, 2, 3))


def redot_timeslice(cv1, cv2):
    """Per-y Re<cv1, cv2> -> (Y,) real (reference redot_cv_timeslice)."""
    return jnp.sum(jnp.real(jnp.conj(cv1) * cv2), axis=(0, 2, 3))


def dot_timeslice(cv1, cv2):
    """Per-y <cv1, cv2> -> (Y,) complex (reference dot_cv_timeslice)."""
    return jnp.sum(jnp.conj(cv1) * cv2, axis=(0, 2, 3))


def gaussian_wall_source(lat: Lattice2D, timeslice: int, color: int, rng,
                         deviation: float = 1.0, mean: float = 0.0
                         ) -> np.ndarray:
    """Real-valued gaussian source on one timeslice and color, in complex
    storage (reference's std::complex<T> gaussian_wall_source overload,
    reductions.h:125-162: draws go to the real part, imag is 0).

    Draws are made in flat eo order over the wall's sites, matching the
    reference's index-ordered fill; both reference overloads consume the
    generator identically.
    """
    if timeslice >= lat.y_len:
        raise ValueError("timeslice must be < Ny")
    if color >= lat.nc:
        raise ValueError("color must be < Nc")
    src = np.zeros(lat.cv_shape(), dtype=np.complex128)
    vals = rng.gaussian_real((2, lat.xh), deviation) + mean
    src[:, timeslice, :, color] = vals
    return src


def gaussian_wall_source_real(lat: Lattice2D, timeslice: int, color: int,
                              rng, deviation: float = 1.0,
                              mean: float = 0.0) -> np.ndarray:
    """Real-storage gaussian wall source (reference's T* overload,
    reductions.h:90-123).

    Identical normal stream as gaussian_wall_source (the two reference
    overloads differ only in storage dtype): returns float64.
    """
    return np.real(gaussian_wall_source(
        lat, timeslice, color, rng, deviation=deviation, mean=mean)
    ).astype(np.float64)


# Explicit name for the complex overload (reductions.h:125-162); the
# default gaussian_wall_source already has its semantics.
gaussian_wall_source_complex = gaussian_wall_source
