"""Vector and batched per-site matrix primitives.

JAX counterpart of the quantum-linalg BLAS surface the reference
depends on (reconstructed from call sites; see SURVEY.md section 2.9:
blas/generic_vector.h, blas/generic_local_matrix.h). Most entries are thin
jnp one-liners; they exist so the rest of the framework reads like the
reference's math, and so reduction orders are centralized (Krylov
trajectories are sensitive to them).

Fields are arrays of any shape; "cv" fields are (2, Y, Xh, nc) and "cm"
fields (2, Y, Xh, nc, nc) with [..., c1, c2], c1 = row.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.custom_batching import custom_vmap

__all__ = [
    "vdot", "norm2sq", "norm", "diffnorm2sq", "norminf", "normalize",
    "orthogonal", "site_matvec", "site_matvec_accum", "site_matmul",
    "site_conjtrans", "site_inv", "site_inv_qr", "identity_like",
    "stacked_site_matvec",
]


# --- global reductions (blas/generic_vector.h equivalents) ---

def vdot(a, b):
    """<a, b> = sum conj(a) * b over all elements."""
    return jnp.sum(jnp.conj(a) * b)


def norm2sq(a):
    return jnp.sum(jnp.real(jnp.conj(a) * a))


def norm(a):
    return jnp.sqrt(norm2sq(a))


def diffnorm2sq(a, b):
    d = a - b
    return jnp.sum(jnp.real(jnp.conj(d) * d))


def norminf(a):
    return jnp.max(jnp.abs(a))


def normalize(a):
    return a / norm(a)


def orthogonal(a, b):
    """a -= <b, a>/<b, b> * b (quantum-linalg ``orthogonal``)."""
    return a - (vdot(b, a) / norm2sq(b)) * b


# --- batched per-site matrix ops (blas/generic_local_matrix.h equivalents) ---

# Batched-matvec rule selection: below this many unrolled channel terms
# the hand-written batching rule expands the matvec into elementwise
# multiply-adds over channel slices (each op elementwise over the
# site axes, full lane utilization, nothing for XLA to re-lower as a
# convolution); above it (e.g. DWF's nc = 2*Ls up to 64) it contracts
# as a per-site (i,j)@(j,batch) matmul with the batch axis minor.
_ELTWISE_MAX_TERMS = 512


def _matvec_eltwise(mat, vec_batched):
    """sum_j mat[..., i, j] * vec[:, ..., j], unrolled over (i, j)."""
    no, ni = mat.shape[-2], mat.shape[-1]
    cols = []
    for i in range(no):
        acc = None
        for j in range(ni):
            term = mat[..., i, j] * vec_batched[..., j]
            acc = term if acc is None else acc + term
        cols.append(acc)
    return jnp.stack(cols, axis=-1)


@custom_vmap
def site_matvec(mat, vec):
    """Per-site y = A x: (..., nc, nc) x (..., nc) -> (..., nc).

    Equivalent of cMATxy; cMATxpy is site_matvec_accum.

    Carries a hand-written jax.vmap batching rule: the default rule
    turns the batched per-site matvec into a dot_general that XLA may
    re-lower as convolutions, while the unrolled elementwise form
    batches at ~0 marginal cost; which wins on the GPU is not measured
    yet (ROADMAP "Speed"). The unbatched program is byte-identical to
    the plain einsum.
    """
    return jnp.einsum("...ij,...j->...i", mat, vec)


@site_matvec.def_vmap
def _site_matvec_vmap(axis_size, in_batched, mat, vec):
    mat_b, vec_b = in_batched
    if vec_b and not mat_b:
        if mat.shape[-2] * mat.shape[-1] <= _ELTWISE_MAX_TERMS:
            return _matvec_eltwise(mat, vec), True
        nb = jnp.moveaxis(vec, 0, -1)
        out = jnp.einsum("...ij,...jb->...ib", mat, nb)
        return jnp.moveaxis(out, -1, 0), True
    if mat_b and not vec_b:
        return jnp.einsum("b...ij,...j->b...i", mat, vec), True
    return jnp.einsum("b...ij,b...j->b...i", mat, vec), True


def site_matvec_accum(mat, vec, acc):
    """Per-site acc += A x (cMATxpy)."""
    return acc + site_matvec(mat, vec)


@custom_vmap
def stacked_site_matvec(mats, nbrs):
    """Fused multi-term matvec: out[..., i] = sum_{s,j} mats[s, ..., i, j]
    nbrs[s, ..., j] — the single stacked contraction the stencil apply
    uses for clover + 4 hopping (+ twolink/corner) terms.

    Same hand-written batching rule rationale as site_matvec. Unbatched
    callers get the byte-identical stacked einsum.
    """
    return jnp.einsum("s...ij,s...j->...i", mats, nbrs)


@stacked_site_matvec.def_vmap
def _stacked_site_matvec_vmap(axis_size, in_batched, mats, nbrs):
    mats_b, nbrs_b = in_batched
    if nbrs_b and not mats_b:
        ns, no, ni = mats.shape[0], mats.shape[-2], mats.shape[-1]
        if ns * no * ni <= _ELTWISE_MAX_TERMS:
            cols = []
            for i in range(no):
                acc = None
                for s in range(ns):
                    for j in range(ni):
                        term = mats[s, ..., i, j] * nbrs[:, s, ..., j]
                        acc = term if acc is None else acc + term
                cols.append(acc)
            return jnp.stack(cols, axis=-1), True
        nb = jnp.moveaxis(nbrs, 0, -1)
        out = jnp.einsum("s...ij,s...jb->...ib", mats, nb)
        return jnp.moveaxis(out, -1, 0), True
    if mats_b and not nbrs_b:
        return jnp.einsum("bs...ij,s...j->b...i", mats, nbrs), True
    return jnp.einsum("bs...ij,bs...j->b...i", mats, nbrs), True


def site_matmul(a, b):
    """Per-site C = A B (cMATxtMATyMATz_square)."""
    return jnp.einsum("...ij,...jk->...ik", a, b)


def site_conjtrans(mat):
    """Per-site conjugate transpose (cMATcopy_conjtrans_square)."""
    return jnp.conj(jnp.swapaxes(mat, -1, -2))


def site_inv(mat):
    """Per-site inverse of square matrices (batched)."""
    return jnp.linalg.inv(mat)


def site_inv_qr(mat):
    """Per-site inverse via batched QR.

    Mirrors the reference's cMATx_do_qr_square + cMATqr_do_xinv_square path
    (used for the rbjacobi clover inverse, stencil/stencil_2d.h:1532-1537)
    for numerical robustness on ill-conditioned site blocks.
    """
    q, r = jnp.linalg.qr(mat)
    n = mat.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=mat.dtype), mat.shape)
    rinv = jnp.linalg.solve_triangular(r, eye, lower=False) if hasattr(
        jnp.linalg, "solve_triangular") else jnp.linalg.solve(r, eye)
    return site_matmul(rinv, site_conjtrans(q))


def identity_like(mat_field):
    """Per-site identity matrices with the shape/dtype of a cm field."""
    n = mat_field.shape[-1]
    eye = jnp.eye(n, dtype=mat_field.dtype)
    return jnp.broadcast_to(eye, mat_field.shape)
