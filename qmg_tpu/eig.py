"""Eigensolvers: dense full-spectrum and iterative partial-spectrum.

JAX counterpart of the quantum-linalg ARPACK interface the
reference uses (interfaces/arpack/generic_arpack.h via SURVEY.md 2.9):
``arpack_dcn`` full-spectrum calls (get_entire_eigensystem) happen on
lattices small enough to densify, so the oracle here is vmapped
operator-densification + LAPACK eig; partial spectra use an implicitly
restarted Arnoldi in JAX (falls back to the dense path for small n).

Selectors mirror ARPACK_SMALLEST_REAL / SMALLEST_MAGNITUDE / LARGEST_REAL.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

SMALLEST_REAL = "SR"
SMALLEST_MAGNITUDE = "SM"
LARGEST_REAL = "LR"
LARGEST_MAGNITUDE = "LM"

_DENSE_CUTOFF = 4096


def densify(matvec, shape, dtype=jnp.complex128) -> np.ndarray:
    """Materialize the operator matrix by applying it to a basis (vmapped).

    Column j of the result is matvec(e_j) - the same probing idea as the
    reference coarse builder, over the full basis.
    """
    n = int(np.prod(shape))
    basis = jnp.eye(n, dtype=dtype).reshape((n,) + tuple(shape))
    cols = jax.lax.map(lambda v: matvec(v).reshape(n), basis,
                       batch_size=min(n, 256))
    return np.asarray(cols).T  # (n, n), columns = images


def dense_eigensystem(matvec, shape, dtype=jnp.complex128):
    """Full spectrum: returns (evals (n,), evecs (n, *shape)) sorted by
    ascending real part (the reference prints in that order)."""
    mat = densify(matvec, shape, dtype)
    evals, evecs = np.linalg.eig(mat)
    order = np.argsort(evals.real)
    evals = evals[order]
    evecs = evecs[:, order].T.reshape((-1,) + tuple(shape))
    return evals, evecs


def _select(evals, which, nev):
    if which in (SMALLEST_REAL, "SR"):
        order = np.argsort(evals.real)
    elif which in (LARGEST_REAL, "LR"):
        order = np.argsort(-evals.real)
    elif which in (SMALLEST_MAGNITUDE, "SM"):
        order = np.argsort(np.abs(evals))
    elif which in (LARGEST_MAGNITUDE, "LM"):
        order = np.argsort(-np.abs(evals))
    else:
        raise ValueError(f"unknown selector {which}")
    return order[:nev]


def make_arnoldi_sweep(matvec, shape, ncv: int, dtype=jnp.complex128):
    """One jitted Arnoldi factorization extension: ``sweep(V_p, H_p, k0)``
    runs steps k0..ncv-1 of classical-Gram-Schmidt-twice Arnoldi as a
    single on-device ``lax.fori_loop``. The Krylov basis V never leaves
    the device and every boundary array is a real pair (trailing size-2
    axis), the same boundary convention as tpu_compat.py.

    V_p: (ncv+1, *shape, 2), H_p: (ncv+1, ncv, 2), k0: scalar int32.
    The CGS projections are masked full-basis contractions (rows > j
    are zero), trading ~2x the triangular flop count for a fixed-shape
    loop body that XLA compiles once.
    """
    ncv = int(ncv)

    @jax.jit
    def sweep(V_p, H_p, k0):
        V = (V_p[..., 0] + 1j * V_p[..., 1]).astype(dtype)
        H = (H_p[..., 0] + 1j * H_p[..., 1]).astype(dtype)
        axes = tuple(range(1, V.ndim))
        idx = jnp.arange(ncv + 1)

        def body(j, carry):
            V, H = carry
            vj = jax.lax.dynamic_index_in_dim(V, j, 0, keepdims=False)
            w = matvec(vj)
            mask = (idx <= j).astype(V.dtype)
            h1 = jnp.sum(jnp.conj(V) * w, axis=axes) * mask
            w = w - jnp.tensordot(h1, V, axes=1)
            h2 = jnp.sum(jnp.conj(V) * w, axis=axes) * mask
            w = w - jnp.tensordot(h2, V, axes=1)
            h = h1 + h2
            beta = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2)).astype(V.dtype)
            col = h + beta * (idx == j + 1)
            H = H.at[:, j].set(col)
            safe = jnp.where(jnp.abs(beta) > 0, beta, 1.0)
            V = V.at[j + 1].set(w / safe)
            return V, H

        V, H = jax.lax.fori_loop(k0, ncv, body, (V, H))
        return (jnp.stack([V.real, V.imag], axis=-1),
                jnp.stack([H.real, H.imag], axis=-1))

    @jax.jit
    def rotate(V_p, Q_p):
        """Thick restart basis update: rows [Q @ V[:ncv], V[ncv], 0...],
        Q_p (k, ncv, 2)."""
        V = (V_p[..., 0] + 1j * V_p[..., 1]).astype(dtype)
        Q = (Q_p[..., 0] + 1j * Q_p[..., 1]).astype(dtype)
        k = Q.shape[0]
        Vk = jnp.tensordot(Q, V[:ncv], axes=1)
        Vnew = jnp.zeros_like(V).at[:k].set(Vk).at[k].set(V[ncv])
        return jnp.stack([Vnew.real, Vnew.imag], axis=-1)

    @jax.jit
    def ritz(V_p, S_p):
        """Normalized Ritz vectors S^T V[:ncv] -> (nev, *shape, 2)."""
        V = (V_p[..., 0] + 1j * V_p[..., 1]).astype(dtype)
        S = (S_p[..., 0] + 1j * S_p[..., 1]).astype(dtype)
        vecs = jnp.tensordot(S, V[:ncv], axes=1)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2,
                               axis=tuple(range(1, vecs.ndim)),
                               keepdims=True))
        vecs = vecs / nrm
        return jnp.stack([vecs.real, vecs.imag], axis=-1)

    return sweep, rotate, ritz


def _pair(a, rdt):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], axis=-1).astype(rdt)


def _krylov_schur(op, shape, nev, which, ncv, max_restarts, tol, seed,
                  dtype):
    """Thick-restart (Krylov-Schur) Arnoldi driver shared by
    arnoldi_eigensystem and shift_invert_eigensystem: device-resident
    basis (make_arnoldi_sweep), one Hessenberg sync per restart, host
    LAPACK on the tiny matrix. Returns (ritz_values (nev,),
    ritz_vectors (nev, *shape) complex)."""
    rdt = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    sweep, rotate, ritz = make_arnoldi_sweep(op, shape, ncv, dtype)

    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    v0 = v0 / np.sqrt(np.sum(np.abs(v0) ** 2))
    V_p = jnp.zeros((ncv + 1,) + tuple(shape) + (2,), rdt
                    ).at[0].set(jnp.asarray(_pair(v0, rdt)))
    H_p = jnp.zeros((ncv + 1, ncv, 2), rdt)

    def host_H(H_p):
        Hh = np.asarray(jax.device_get(H_p))
        return (Hh[..., 0] + 1j * Hh[..., 1]).astype(np.complex128)

    V_p, H_p = sweep(V_p, H_p, jnp.int32(0))
    for _ in range(max_restarts):
        H = host_H(H_p)
        Hm = H[:ncv, :ncv]
        evals, S = np.linalg.eig(Hm)
        sel = _select(evals, which, nev)
        resid = np.abs(H[ncv, ncv - 1]) * np.abs(S[ncv - 1, sel])
        if np.all(resid < tol * np.maximum(np.abs(evals[sel]), 1e-30)):
            break
        # Thick (Krylov-Schur) restart: keep the nev wanted Ritz vectors.
        # From A V = V H + f e_k^T with f = V[ncv] * H[ncv, ncv-1]:
        # A (V Q) = (V Q)(Q^H H Q) + f (e_k^T Q).
        Q = np.linalg.qr(S[:, sel])[0]
        newH = np.zeros_like(H)
        newH[:nev, :nev] = Q.conj().T @ Hm @ Q
        newH[nev, :nev] = H[ncv, ncv - 1] * Q[ncv - 1, :]
        V_p = rotate(V_p, jnp.asarray(_pair(Q.T, rdt)))
        H_p = jnp.asarray(_pair(newH, rdt))
        V_p, H_p = sweep(V_p, H_p, jnp.int32(nev))

    H = host_H(H_p)
    evals, S = np.linalg.eig(H[:ncv, :ncv])
    sel = _select(evals, which, nev)
    vecs_p = np.asarray(jax.device_get(
        ritz(V_p, jnp.asarray(_pair(S[:, sel].T, rdt)))))
    vecs = jnp.asarray(vecs_p[..., 0] + 1j * vecs_p[..., 1], dtype)
    return evals[sel], vecs


def shift_invert_eigensystem(solve, shape, nev: int, sigma=0.0,
                             ncv: int = None, max_restarts: int = 200,
                             tol: float = 1e-8, seed: int = 7,
                             dtype=jnp.complex128, matvec=None):
    """Interior/smallest eigenpairs via shift-invert Arnoldi: run the
    Krylov-Schur iteration on ``w = solve(v)`` (an approximate
    ``(M - sigma)^{-1} v`` - any Krylov/MG solve works) and select the
    LARGEST-magnitude Ritz values theta of the transformed operator,
    which map back to the eigenvalues of M CLOSEST to ``sigma`` as
    lambda = sigma + 1/theta. This is the standard cure for the slow
    convergence of plain Arnoldi on smallest-magnitude spectra
    (measured here: plain SM at 32^2 Wilson needs ncv=64 and hundreds
    of restarts; shift-invert converges at ncv=2-3x nev) - a
    capability beyond the reference's regular-mode ARPACK calls
    (interfaces/arpack/generic_arpack.h).

    If ``matvec`` (the ORIGINAL operator) is given, eigenvalues are
    refined by Rayleigh quotients of the returned vectors - this makes
    the eigenvalue accuracy independent of the inner solve tolerance.

    Returns (evals (nev,), evecs (nev, *shape)).
    """
    n = int(np.prod(shape))
    ncv = ncv or min(max(3 * nev, 20), n)
    thetas, vecs = _krylov_schur(solve, shape, nev, LARGEST_MAGNITUDE,
                                 ncv, max_restarts, tol, seed, dtype)
    lam = complex(sigma) + 1.0 / thetas
    if matvec is not None:
        # Rayleigh-quotient refinement on the original operator.
        lam = np.array([
            complex(jnp.sum(jnp.conj(vecs[i]) * matvec(vecs[i])))
            for i in range(len(lam))])
    order = np.argsort(np.abs(lam - complex(sigma)))
    return lam[order], vecs[jnp.asarray(order)]


def arnoldi_eigensystem(matvec, shape, nev: int, which=SMALLEST_MAGNITUDE,
                        ncv: int = None, max_restarts: int = 200,
                        tol: float = 1e-8, seed: int = 7,
                        dtype=jnp.complex128):
    """Partial spectrum via thick-restart (Krylov-Schur) Arnoldi - the
    JAX ARPACK equivalent. The ncv-step factorization runs as ONE
    compiled device loop per restart (make_arnoldi_sweep); the Krylov
    basis stays device-resident and only the (ncv+1, ncv) Hessenberg
    matrix crosses to the host per restart, where the small dense eig /
    Schur restart decisions run (LAPACK on a tiny matrix). All jit
    boundaries carry real pairs.

    For small problems (n <= 4096) defers to the dense path - the
    reference's coarsest deflation targets exactly such sizes.

    Returns (evals (nev,), evecs (nev, *shape)).
    """
    n = int(np.prod(shape))
    if n <= _DENSE_CUTOFF:
        evals, evecs = dense_eigensystem(matvec, shape, dtype)
        sel = _select(evals, which, nev)
        return evals[sel], evecs[sel]

    ncv = ncv or min(max(3 * nev, 20), n)
    return _krylov_schur(matvec, shape, nev, which, ncv, max_restarts,
                         tol, seed, dtype)
