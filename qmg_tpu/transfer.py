"""Aggregation-based transfer operators (prolong / restrict).

JAX counterpart of reference transfer/transfer.h:42-818.

The reference builds a one-to-many ``coarse_map`` (sorted fine cv indices
per coarse site, transfer/transfer.h:410-448) and loops over it. Here the
map becomes a static *permutation*: a host-precomputed gather that
reorders a fine field (2, Y, Xh, nc) into blocked form
(2c, B, Yc, Xhc) with B = By*Bx*nc fine dof per coarse site. Then

    restrict_f2c: coarse[s, v] = sum_b conj(NV[v, s, b]) fine[s, b]
    prolong_c2f:  fine[s, b]  = sum_v NV[v, s, b] coarse[s, v]

are einsums against the blocked null-vector tensor NV, contracted over
the b axis with the coarse lattice (Yc, Xhc) axes kept MINOR.

Layout note: the blocked b axis sits in the MIDDLE, not minor, so the
large coarse lattice axes (Yc, Xhc) are minor, matching the
channels-first setup layouts (cf.py); a B-minor layout (B = 32 at 4x4
Wilson blocking) is padded by compilers that tile the minor dims.

Block (bi-)orthonormalization follows the reference's Osborn-style
restrict/prolong Gram-Schmidt (transfer/transfer.h:514-769) vectorized
over blocks, capturing the block Cholesky (symmetric) or LU (asymmetric)
factors the coarse chirality machinery needs (operators/coarse.h:669-892).
"""

from __future__ import annotations

import enum
import numpy as np
import jax
import jax.numpy as jnp

from .lattice import Lattice2D


class DoublingType(enum.IntEnum):
    """How chiral doubling of the null vectors was done
    (reference QMGDoublingType, transfer/transfer.h:35-40)."""
    NONE = 0
    PROJECTION = 1
    OPERATOR = 2


def _block_permutation(fine_lat: Lattice2D, coarse_lat: Lattice2D):
    """Flat gather indices mapping fine eo layout -> blocked layout.

    Returns (perm, inv_perm, B): perm has shape (2c, B, Yc, Xhc) with
    values indexing the flattened fine cv field; the b axis is ordered by
    ascending fine flat index within each block - the same ordering as the
    reference's merge-sorted coarse_map (transfer/transfer.h:440).
    """
    bx = fine_lat.x_len // coarse_lat.x_len
    by = fine_lat.y_len // coarse_lat.y_len
    if bx * coarse_lat.x_len != fine_lat.x_len or \
       by * coarse_lat.y_len != fine_lat.y_len:
        raise ValueError("fine dims must divide evenly by coarse dims "
                         "(reference transfer/transfer.h:130-133)")
    nc = fine_lat.nc
    B = bx * by * nc

    # Fine flat cv index for every (x, y, c).
    xs = np.arange(fine_lat.x_len)
    ys = np.arange(fine_lat.y_len)
    cs = np.arange(nc)
    xg, yg, cg = np.meshgrid(xs, ys, cs, indexing="ij")  # (X, Y, nc)
    p = (xg + yg) % 2
    flat = ((p * (fine_lat.volume // 2)
             + yg * fine_lat.xh + (xg // 2) % fine_lat.xh) * nc + cg)

    # Coarse flat site index for every fine (x, y).
    cxg, cyg = xg // bx, yg // by
    cp = (cxg + cyg) % 2
    if coarse_lat.volume == 1:
        cflat = np.zeros_like(cxg)
    else:
        cflat = (cp * (coarse_lat.volume // 2) + cyg * coarse_lat.xh
                 + (cxg // 2) % coarse_lat.xh)

    # Group fine flat indices by coarse site, sorted ascending.
    perm = np.empty((coarse_lat.volume, B), dtype=np.int64)
    order = np.lexsort((flat.ravel(), cflat.ravel()))
    perm[...] = flat.ravel()[order].reshape(coarse_lat.volume, B)

    cshape = (2, coarse_lat.y_len, coarse_lat.xh, B)
    if coarse_lat.volume == 1:
        cshape = (1, 1, 1, B)
    # b-MID layout: (2c, B, Yc, Xhc) keeps the lattice axes minor.
    perm = np.moveaxis(perm.reshape(cshape), -1, 1)
    inv_perm = np.empty(fine_lat.size_cv, dtype=np.int64)
    inv_perm[perm.ravel()] = np.arange(fine_lat.size_cv)
    return perm, inv_perm, B


class TransferMG:
    """Transfer between a fine and a coarse lattice from null vectors.

    Arguments mirror the reference constructors (transfer/transfer.h:118,
    :185): ``null_vectors`` is (nvec, 2, Y, Xh, nc) (nvec = coarse nc);
    pass ``restrict_null_vectors`` for an asymmetric R != P^dagger pair.
    """

    def __init__(self, fine_lat: Lattice2D, coarse_lat: Lattice2D,
                 null_vectors, do_block_ortho: bool = True,
                 save_decomp: bool = False,
                 doubling: DoublingType = DoublingType.NONE,
                 restrict_null_vectors=None):
        self.fine_lat = fine_lat
        self.coarse_lat = coarse_lat
        self.doubling = DoublingType(doubling)
        nvec = coarse_lat.nc
        nv = jnp.asarray(null_vectors)
        if nv.shape[0] != nvec:
            raise ValueError(f"need {nvec} null vectors, got {nv.shape[0]}")

        self._init_geometry()

        # Blocked null vectors: (nvec, 2c, B, Yc, Xhc) - b MID, lattice
        # axes minor (module docstring).
        nvb = self._to_blocked_batch(nv)
        self.block_cholesky = None  # (2c,Yc,Xhc,nvec,nvec), [i,j]=row i col j
        self.block_L = None
        self.block_U = None

        if restrict_null_vectors is None:
            self._restrict_nvb = None
            if do_block_ortho:
                nvb, chol = _block_orthonormalize(nvb)
                if save_decomp:
                    self.block_cholesky = chol
                # Reference re-orthonormalizes a second time for numerical
                # quality, keeping the first pass's decomposition
                # (transfer/transfer.h:159-174).
                nvb, _ = _block_orthonormalize(nvb)
        else:
            rnv = jnp.asarray(restrict_null_vectors)
            rnvb = self._to_blocked_batch(rnv)
            if do_block_ortho:
                nvb, rnvb, L, U = _block_bi_orthonormalize(nvb, rnvb)
                if save_decomp:
                    self.block_L, self.block_U = L, U
                nvb, rnvb, _, _ = _block_bi_orthonormalize(nvb, rnvb)
            self._restrict_nvb = rnvb
        self._nvb = nvb
        # Rank-deficient null vectors (e.g. duplicated constants within a
        # block) make the Gram factorization produce NaN; fail loudly at
        # setup instead of silently degrading the coarse correction.
        # (Skipped when tracing - setup is normally eager.)
        import jax.core as _core
        if not isinstance(nvb, _core.Tracer) and bool(
                jnp.logical_not(jnp.isfinite(nvb).all())):
            raise ValueError(
                "block orthonormalization produced non-finite null "
                "vectors - the per-block Gram matrix is singular (null "
                "vectors are linearly dependent within a block)")

    @property
    def version(self) -> int:
        """Monotonic state version (see stencil.next_state_version).
        Transfers are immutable after construction, so the version is
        fixed per instance - but never reused across instances, unlike
        id(). Lazy so checkpoint's __new__ construction path works."""
        v = getattr(self, "_version", None)
        if v is None:
            from .stencil import next_state_version
            self._version = v = next_state_version()
        return v

    # --- layout plumbing ---
    def _init_geometry(self):
        """Blocking geometry. For even x-blocks (every production config)
        the fine<->blocked layout change is pure reshape/transpose/select
        - shard-LOCAL under (y, x) lattice sharding, so restrict/prolong
        never gather the fine field (the round-1 permutation gather
        forced an all-gather under SPMD). Odd x-blocks split the eo-packed
        x axis across parities and keep the gather fallback.
        """
        fine_lat, coarse_lat = self.fine_lat, self.coarse_lat
        by = fine_lat.y_len // coarse_lat.y_len
        bx = fine_lat.x_len // coarse_lat.x_len
        if (by * coarse_lat.y_len != fine_lat.y_len
                or bx * coarse_lat.x_len != fine_lat.x_len):
            raise ValueError(
                "fine dims must divide evenly by coarse dims "
                "(reference transfer/transfer.h:130-133)")
        self._by, self._bx = by, bx
        self.block_dof = by * bx * fine_lat.nc
        self._coarse_is_point = coarse_lat.volume == 1
        self._use_reshape = bx % 2 == 0 or self._coarse_is_point
        if not self._use_reshape:
            self._perm, self._inv_perm, _ = _block_permutation(
                fine_lat, coarse_lat)

    def _to_blocked(self, fine):
        """(2, Y, Xh, nc) -> (2c, B, Yc, Xhc).

        The b axis orders fine dof by ascending fine flat cv index within
        each block (parity-major, then y, then xh, then color) - the same
        ordering as the reference's merge-sorted coarse_map
        (transfer/transfer.h:440). The b axis sits MID, not minor: see
        the module docstring's layout note.
        """
        if not self._use_reshape:
            return fine.reshape(-1)[self._perm]
        fl, cl = self.fine_lat, self.coarse_lat
        by, bxh = self._by, max(self._bx // 2, 1)
        yc, xc = cl.y_len, cl.x_len
        nc = fl.nc
        # (2, Yc, By, Xc, Bxh, nc): each (cy, cx) slab is one block's
        # sites of one parity (fine xh of block cx = [cx*Bxh, (cx+1)*Bxh)
        # for BOTH parities because Bx is even).
        z = fine.reshape(2, yc, by, xc, bxh, nc)
        z = jnp.transpose(z, (1, 3, 0, 2, 4, 5))     # (Yc, Xc, 2, By, Bxh, nc)
        z = z.reshape(yc, xc, 2 * by * bxh * nc)     # parity-major b axis
        if self._coarse_is_point:
            return z.reshape(1, -1, 1, 1)
        # eo-pack the coarse (Yc, Xc) grid: coarse parity = (cy + cx) % 2,
        # so within each row the even/odd coarse sites alternate columns.
        zp = z.reshape(yc, cl.xh, 2, -1)
        row_odd = (jnp.arange(yc) % 2).astype(bool)[:, None, None]
        even = jnp.where(row_odd, zp[:, :, 1], zp[:, :, 0])
        odd = jnp.where(row_odd, zp[:, :, 0], zp[:, :, 1])
        return jnp.moveaxis(jnp.stack([even, odd]), -1, 1)

    def _from_blocked(self, blocked):
        """(2c, B, Yc, Xhc) -> (2, Y, Xh, nc) (inverse of _to_blocked)."""
        if not self._use_reshape:
            return blocked.reshape(-1)[self._inv_perm].reshape(
                self.fine_lat.cv_shape())
        fl, cl = self.fine_lat, self.coarse_lat
        by, bxh = self._by, max(self._bx // 2, 1)
        yc, xc = cl.y_len, cl.x_len
        nc = fl.nc
        if self._coarse_is_point:
            z = blocked.reshape(1, 1, -1)
        else:
            zb = jnp.moveaxis(blocked, 1, -1)        # (2c, Yc, Xhc, B)
            row_odd = (jnp.arange(yc) % 2).astype(bool)[:, None, None]
            k0 = jnp.where(row_odd, zb[1], zb[0])
            k1 = jnp.where(row_odd, zb[0], zb[1])
            z = jnp.stack([k0, k1], axis=2).reshape(yc, xc, -1)
        z = z.reshape(yc, xc, 2, by, bxh, nc)
        z = jnp.transpose(z, (2, 0, 3, 1, 4, 5))     # (2, Yc, By, Xc, Bxh, nc)
        return z.reshape(self.fine_lat.cv_shape())

    def _to_blocked_batch(self, fine_batch):
        return jax.vmap(self._to_blocked)(fine_batch)

    def _coarse_shape(self, blocked_like):
        if self._coarse_is_point:
            return (2, 1, 1, self.coarse_lat.nc)
        return self.coarse_lat.cv_shape()

    # --- public transfer ops (reference :283-294) ---
    def restrict_f2c(self, fine):
        """coarse += conj(NV) . fine per block (reference :487-511).
        Uses restrict vectors when R != P^dagger (reference :291-294)."""
        nvb = self._nvb if self._restrict_nvb is None else self._restrict_nvb
        fb = self._to_blocked(fine)
        coarse = jnp.einsum("vcbyx,cbyx->cyxv", jnp.conj(nvb), fb)
        if self._coarse_is_point:
            # blocked layout is (1,1,1,B); coarse field is (2,1,1,nvec)
            # with the single site at parity 0.
            out = jnp.zeros((2, 1, 1, self.coarse_lat.nc),
                            dtype=coarse.dtype)
            return out.at[0].set(coarse[0])
        return coarse

    def prolong_c2f(self, coarse):
        """fine = NV . coarse per block (reference :455-480)."""
        if self._coarse_is_point:
            coarse = coarse[0:1]
        fb = jnp.einsum("vcbyx,cyxv->cbyx", self._nvb, coarse)
        return self._from_blocked(fb)

    def is_symmetric(self) -> bool:
        return self._restrict_nvb is None

    def has_decompositions(self) -> bool:
        if self.is_symmetric():
            return self.block_cholesky is not None
        return self.block_L is not None and self.block_U is not None

    def get_doubling(self) -> DoublingType:
        return self.doubling

    @property
    def null_vectors(self):
        """Block-orthonormalized null vectors, (nvec, 2, Y, Xh, nc)."""
        return jax.vmap(self._from_blocked)(self._nvb)

    @property
    def restrict_null_vectors(self):
        if self._restrict_nvb is None:
            return None
        return jax.vmap(self._from_blocked)(self._restrict_nvb)


# ---------------------------------------------------------------------------
# Block (bi-)orthonormalization over the blocked layout. V has shape
# (nvec, 2c, B, Yc, Xhc); the contraction axis B is axis 1 of each
# per-vector slice, the site axes are (2c, Yc, Xhc). Decompositions keep
# the site-major shape (2c, Yc, Xhc, nvec, nvec) the coarse chirality
# machinery consumes (operators/coarse.py pad_parity).
# ---------------------------------------------------------------------------

def _bdot(a, b):
    """Per-block <a, b> = sum_b conj(a) b over the b axis (axis 1 of a
    (2c, B, Yc, Xhc) slice) -> (2c, Yc, Xhc)."""
    return jnp.sum(jnp.conj(a) * b, axis=1)


def _bsmul(g, v):
    """Per-site scalar (2c, Yc, Xhc) times blocked (2c, B, Yc, Xhc)."""
    return g[:, None] * v


def _block_orthonormalize(nvb):
    """Gram-Schmidt within each block (reference :514-607).

    Returns (orthonormalized nvb, cholesky) with cholesky[..., j, i] =
    <j, i> for j < i and [..., i, i] = block norm - the upper-triangular
    R factor the reference captures (transfer/transfer.h:554-594).
    """
    nvec = nvb.shape[0]
    site_shape = (nvb.shape[1],) + nvb.shape[3:]
    chol = jnp.zeros(site_shape + (nvec, nvec), dtype=nvb.dtype)
    vs = [nvb[i] for i in range(nvec)]
    for i in range(nvec):
        for j in range(i):
            g = _bdot(vs[j], vs[i])
            chol = chol.at[..., j, i].set(g)
            vs[i] = vs[i] - _bsmul(g, vs[j])
        nrm = jnp.sqrt(jnp.real(_bdot(vs[i], vs[i])))
        chol = chol.at[..., i, i].set(nrm.astype(nvb.dtype))
        vs[i] = vs[i] / nrm[:, None]
    return jnp.stack(vs), chol


def _block_bi_orthonormalize(pvb, rvb):
    """Bi-orthonormalization of prolong/restrict vector pairs
    (reference :610-769). Returns (pvb, rvb, L, U) with
    U[..., j, i] = <r_j, p_i>, L[..., i, j] = conj applied as in the
    reference (the conj_vector fix-up at :759-764), and the
    phase-preserving diagonal normalization of :694-755.
    """
    nvec = pvb.shape[0]
    site_shape = (pvb.shape[1],) + pvb.shape[3:]
    L = jnp.zeros(site_shape + (nvec, nvec), dtype=pvb.dtype)
    U = jnp.zeros_like(L)
    ps = [pvb[i] for i in range(nvec)]
    rs = [rvb[i] for i in range(nvec)]
    for i in range(nvec):
        for j in range(i):
            u = _bdot(rs[j], ps[i])
            U = U.at[..., j, i].set(u)
            ps[i] = ps[i] - _bsmul(u, ps[j])
            lt = _bdot(ps[j], rs[i])
            # conj fix-up applied immediately (reference defers to :763).
            L = L.at[..., i, j].set(jnp.conj(lt))
            rs[i] = rs[i] - _bsmul(lt, rs[j])
        d = _bdot(rs[i], ps[i])
        # Phase-preserving inverse-sqrt: f = |d|^{-1/2} e^{i arg d}.
        f = jnp.exp(1j * jnp.angle(d)) / jnp.sqrt(jnp.abs(d))
        rs[i] = _bsmul(f, rs[i])
        # L diagonal: conj(1/f) = |d|^{1/2} e^{i arg d}.
        L = L.at[..., i, i].set(jnp.conj(1.0 / f))
        f2 = 1.0 / jnp.sqrt(jnp.abs(d))
        ps[i] = ps[i] * f2[:, None]
        U = U.at[..., i, i].set((1.0 / f2).astype(U.dtype))
    return jnp.stack(ps), jnp.stack(rs), L, U
