"""Mixed-precision iterative refinement: the fp64 1e-10 contract around
a complex64 device solve.

The reference's flagship contract is an outer FGCR to tol 1e-10 in
double precision (tests/n13_wilson_kcycle/wilson_kcycle.cpp:104-106).
The planes MG solve runs in complex64 and bottoms out near 1e-6
relative residual (PARITY.md "Precision domains").

Defect correction (classic iterative refinement) restores the fp64
contract around the c64 device solve:

    x = 0
    repeat:  r = b - A x        # fp64, HOST, fp64 coefficients
             d = MG_solve(r)    # complex64, DEVICE (planes solver)
             x = x + d          # fp64, HOST
    until ||r|| <= tol ||b||

Each outer pass gains the inner solver's digits (~5-6 for a c64 K-cycle
at tol 1e-5), so 2-3 passes reach 1e-10; correctness only needs the
inner solve to reduce the error, which flexible-GCR-preconditioned MG
does by construction. The fp64 residual is computed in NumPy on the
host - deliberately backend-free, so the same loop drives any device
solve and the CPU tests.

The host apply mirrors stencil.apply_M / cshift.cshift_pull exactly
(reference semantics: stencil/stencil_2d.h:912-936 via
cshift/cshift_2d.h:45-236), in float64 NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .lattice import DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1

__all__ = ["HostStencil", "host_apply_M", "refine_solve", "RefineResult"]


# ---------------------------------------------------------------------------
# fp64 host apply (NumPy mirror of cshift.cshift_pull + stencil.apply_M).
# ---------------------------------------------------------------------------

def _row_mask(y_len: int, q: int, dof_ndim: int):
    y = (np.arange(y_len) % 2) == (q % 2)
    return y.reshape((y_len, 1) + (1,) * dof_ndim)


def _pull_x_half(src, q: int, sign: int):
    dof_ndim = src.ndim - 2
    if sign > 0:
        rolled = np.roll(src, -1, axis=1)
        direct = _row_mask(src.shape[0], q, dof_ndim)
    else:
        rolled = np.roll(src, 1, axis=1)
        direct = _row_mask(src.shape[0], 1 - q, dof_ndim)
    return np.where(direct, src, rolled)


def _cshift_pull(field, direction: int):
    if direction == DIR_YP1:
        return np.roll(field[::-1], -1, axis=1)
    if direction == DIR_YM1:
        return np.roll(field[::-1], 1, axis=1)
    if direction == DIR_XP1:
        return np.stack([_pull_x_half(field[1], 0, +1),
                         _pull_x_half(field[0], 1, +1)])
    if direction == DIR_XM1:
        return np.stack([_pull_x_half(field[1], 0, -1),
                         _pull_x_half(field[0], 1, -1)])
    raise ValueError(f"unsupported cshift direction {direction}")


def host_apply_M(clover, hopping, x, shift=0.0, eo_shift=0.0,
                 dof_shift=0.0):
    """fp64 NumPy lhs = M rhs on a (2, Y, Xh, nc) field.

    ``clover``: (2, Y, Xh, nc, nc) or None; ``hopping``: (4, 2, Y, Xh,
    nc, nc) or None, indexed by the DIR_* constants. Shift semantics as
    stencil.apply_shift (reference apply_M_shift, stencil_2d.h:865-909).
    """
    out = np.zeros_like(x)
    if clover is not None:
        out = out + np.einsum("...ij,...j->...i", clover, x)
    if hopping is not None:
        for d in (DIR_XP1, DIR_YP1, DIR_XM1, DIR_YM1):
            out = out + np.einsum("...ij,...j->...i", hopping[d],
                                  _cshift_pull(x, d))
    even = (shift + eo_shift) * x[0]
    odd = (shift - eo_shift) * x[1]
    sh = np.stack([even, odd])
    nc = x.shape[-1]
    if dof_shift != 0.0 and nc % 2 == 0:
        half = nc // 2
        sh[..., :half] += dof_shift * x[..., :half]
        sh[..., half:] += -dof_shift * x[..., half:]
    return out + sh


class HostStencil:
    """fp64 host-side operator built from a Stencil2D (or raw arrays).

    Snapshots the coefficients as complex128 NumPy once; ``apply`` is
    then backend-free. This is the OUTER operator of the refinement loop
    - the fp64 ground truth the reference solves against.
    """

    def __init__(self, stencil=None, *, clover=None, hopping=None,
                 shift=0.0, eo_shift=0.0, dof_shift=0.0):
        if stencil is not None:
            c = stencil.coeffs
            clover = c.clover
            hopping = c.hopping
            shift, eo_shift, dof_shift = c.shift, c.eo_shift, c.dof_shift
        self.clover = (None if clover is None
                       else np.asarray(clover, np.complex128))
        self.hopping = (None if hopping is None
                        else np.asarray(hopping, np.complex128))
        self.shift = complex(np.asarray(shift))
        self.eo_shift = complex(np.asarray(eo_shift))
        self.dof_shift = complex(np.asarray(dof_shift))

    def apply(self, x):
        return host_apply_M(self.clover, self.hopping,
                            np.asarray(x, np.complex128), self.shift,
                            self.eo_shift, self.dof_shift)


# ---------------------------------------------------------------------------
# The refinement loop.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefineResult:
    x: np.ndarray               # fp64 solution
    converged: bool
    outer_iters: int            # defect-correction passes
    inner_iters: int            # summed device-solve iterations
    rel_resid: float            # TRUE fp64 relative residual
    history: list               # rel resid before each pass + final


def refine_solve(host_op: HostStencil, inner_solve: Callable, b,
                 tol: float = 1e-10, max_outer: int = 12,
                 x0: Optional[np.ndarray] = None) -> RefineResult:
    """Defect-correction to fp64 ``tol``.

    ``inner_solve(r) -> (d, iters)``: an approximate A^-1 in any reduced
    precision (the c64 planes K-cycle; see
    tpu_compat.make_refined_planes_solver for the packaged form).
    The residual it receives is pre-normalized to unit 2-norm - c64 has
    the range, but unit scaling keeps every inner solve in the regime
    the solver's relative stopping test was tuned for.

    Stops early (converged=False) if an outer pass fails to reduce the
    residual - the inner solver has hit ITS floor, so iterating further
    cannot help.
    """
    b = np.asarray(b, np.complex128)
    bnorm = float(np.linalg.norm(b.ravel()))
    if bnorm == 0.0:
        return RefineResult(np.zeros_like(b), True, 0, 0, 0.0, [0.0])
    x = (np.zeros_like(b) if x0 is None
         else np.asarray(x0, np.complex128).copy())
    history = []
    inner_total = 0
    outer = 0
    prev = np.inf
    while True:
        r = b - host_op.apply(x)
        rel = float(np.linalg.norm(r.ravel())) / bnorm
        history.append(rel)
        if rel <= tol:
            return RefineResult(x, True, outer, inner_total, rel, history)
        if outer >= max_outer or rel >= prev:
            return RefineResult(x, False, outer, inner_total, rel, history)
        prev = rel
        rnorm = float(np.linalg.norm(r.ravel()))
        d, iters = inner_solve(r / rnorm)
        inner_total += int(iters)
        x = x + rnorm * np.asarray(d, np.complex128)
        outer += 1
