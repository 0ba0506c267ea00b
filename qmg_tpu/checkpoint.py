"""Checkpoint / resume for MG hierarchies.

The reference checkpoints only gauge configs (text phase files,
u1/u1_utils.h:38-168); null vectors and coarse stencils are rebuilt from
scratch every run. Here the whole hierarchy state - per-level stencil
coefficients, shifts, blocked null vectors, solve configs - serializes to
a single .npz, so an expensive adaptive setup is paid once per gauge
config (the improvement SURVEY.md section 5 calls for).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax.numpy as jnp

from .lattice import Lattice2D
from .stencil import Stencil2D, make_coeffs, StencilType
from .transfer import TransferMG, DoublingType
from .stateful import StatefulMultigridMG, LevelSolveMG, CoarsestSolveMG
from .operators.coarse import CoarseOperator2D

# Version 3: blocked null vectors moved from the B-minor layout
# (nvec, 2c, Yc, Xhc, B) to the b-MID layout (nvec, 2c, B, Yc, Xhc)
# (transfer.py module docstring). Older checkpoints
# are converted on load.
FORMAT_VERSION = 3


def save_hierarchy(mg: StatefulMultigridMG, path: str):
    """Serialize a StatefulMultigridMG to ``path`` (.npz)."""
    arrays = {}
    meta = {"version": FORMAT_VERSION, "n_levels": mg.get_num_levels(),
            "lattices": [], "level_solves": [], "chirality": []}
    for lvl in range(mg.get_num_levels()):
        lat = mg.get_lattice(lvl)
        meta["lattices"].append([lat.x_len, lat.y_len, lat.nc])
        st = mg.get_stencil(lvl)
        c = st.coeffs
        if c.clover is not None:
            arrays[f"clover{lvl}"] = np.asarray(c.clover)
        if c.hopping is not None:
            arrays[f"hopping{lvl}"] = np.asarray(c.hopping)
        arrays[f"shifts{lvl}"] = np.asarray(
            [complex(c.shift), complex(c.eo_shift), complex(c.dof_shift)])
        is_chiral = bool(getattr(st, "is_chiral", False))
        dc = int(st.get_default_chirality()) if lvl > 0 else -1
        meta["chirality"].append([is_chiral, dc])
    for lvl in range(mg.get_num_levels() - 1):
        t = mg.get_transfer(lvl)
        arrays[f"nvb{lvl}"] = np.asarray(t._nvb)
        # Asymmetric restrict vectors and saved block decompositions
        # (needed by CoarseOperator2D.apply_coarse_sigma) round-trip too;
        # absent pieces simply aren't written.
        for name, val in (("rnvb", t._restrict_nvb),
                          ("chol", t.block_cholesky),
                          ("blockL", t.block_L),
                          ("blockU", t.block_U)):
            if val is not None:
                arrays[f"{name}{lvl}"] = np.asarray(val)
        meta.setdefault("doubling", []).append(int(t.get_doubling()))
        ls = mg.get_level_solve(lvl)
        meta["level_solves"].append(
            {k: (int(v) if isinstance(v, (StencilType, bool)) else v)
             for k, v in dataclasses.asdict(ls).items()})
    cs = mg.get_coarsest_solve()
    meta["coarsest"] = {k: (int(v) if isinstance(v, (StencilType, bool))
                            else v)
                        for k, v in dataclasses.asdict(cs).items()}
    if mg.coarsest_dinv is not None:
        arrays["coarsest_dinv"] = np.asarray(mg.coarsest_dinv)
    if mg.coarsest_evecs is not None:
        # Deflation eigenpairs (reference stateful_multigrid.h:613-696)
        # round-trip so a resumed stream keeps its deflated coarsest solve.
        arrays["coarsest_evals"] = np.asarray(mg.coarsest_evals)
        arrays["coarsest_evecs"] = np.asarray(mg.coarsest_evecs)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_hierarchy(path: str, fine_stencil: Stencil2D
                   ) -> StatefulMultigridMG:
    """Rebuild a hierarchy from ``path``. The fine operator is supplied by
    the caller (it owns the gauge field); coarse levels restore their
    built coefficients directly (no re-probing)."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] not in (1, 2, FORMAT_VERSION):
        raise ValueError(f"checkpoint version {meta['version']} not in "
                         f"(1, 2, {FORMAT_VERSION})")
    # Versions < 3 stored blocked null vectors B-minor; convert to the
    # b-MID layout (see FORMAT_VERSION note).
    _legacy_nvb = meta["version"] < 3
    n = meta["n_levels"]
    lat0 = Lattice2D(*meta["lattices"][0])
    if lat0 != fine_stencil.lat:
        raise ValueError("fine stencil lattice does not match checkpoint")

    cs = CoarsestSolveMG(**{
        **meta["coarsest"],
        "coarsest_stencil_app": StencilType(
            meta["coarsest"]["coarsest_stencil_app"])})
    mg = StatefulMultigridMG(lat0, fine_stencil, cs)

    for lvl in range(1, n):
        lat = Lattice2D(*meta["lattices"][lvl])
        lat_prev = Lattice2D(*meta["lattices"][lvl - 1])
        def _blocked(arr):
            a = jnp.asarray(arr)
            return jnp.moveaxis(a, -1, 2) if _legacy_nvb else a

        nvb = _blocked(data[f"nvb{lvl - 1}"])
        doubling = DoublingType(meta["doubling"][lvl - 1])
        # Rebuild the transfer around the saved (already orthonormalized)
        # blocked null vectors - skip re-orthonormalization.
        t = TransferMG.__new__(TransferMG)
        t.fine_lat = lat_prev
        t.coarse_lat = lat
        t.doubling = doubling
        t._init_geometry()
        t._nvb = nvb

        def _opt(name, blocked=False):
            k = f"{name}{lvl - 1}"
            if k not in data:
                return None
            return _blocked(data[k]) if blocked else jnp.asarray(data[k])
        t._restrict_nvb = _opt("rnvb", blocked=True)
        t.block_cholesky = _opt("chol")
        t.block_L = _opt("blockL")
        t.block_U = _opt("blockU")

        is_chiral, dc = meta["chirality"][lvl]
        st = CoarseOperator2D.__new__(CoarseOperator2D)
        shifts = data[f"shifts{lvl}"]
        coeffs = make_coeffs(
            lat,
            clover=(jnp.asarray(data[f"clover{lvl}"])
                    if f"clover{lvl}" in data else None),
            hopping=(jnp.asarray(data[f"hopping{lvl}"])
                     if f"hopping{lvl}" in data else None),
            shift=shifts[0], eo_shift=shifts[1], dof_shift=shifts[2],
            dtype=jnp.asarray(data[f"clover{lvl}"]).dtype
            if f"clover{lvl}" in data else jnp.complex128)
        Stencil2D.__init__(st, coeffs)
        st.is_chiral = is_chiral
        st.use_rbjacobi = False
        st.in_transfer = t
        st._default_chirality = dc
        st._sigma_1_L = None
        st._sigma_1_R = None

        lsd = meta["level_solves"][lvl - 1]
        lsd["fine_stencil_app"] = StencilType(lsd["fine_stencil_app"])
        ls = LevelSolveMG(**lsd)
        # Push without rebuilding the coarse stencil, then attach ours.
        mg.push_level(lat, t, ls, build_stencil=False)
        mg.stencil_list[lvl] = st
        mg.is_stencil_managed[lvl] = True
    if "coarsest_dinv" in data:
        mg.coarsest_dinv = jnp.asarray(data["coarsest_dinv"])
    if "coarsest_evecs" in data:
        mg.coarsest_evals = jnp.asarray(data["coarsest_evals"])
        mg.coarsest_evecs = jnp.asarray(data["coarsest_evecs"])
    return mg
