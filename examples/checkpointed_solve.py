"""End-to-end workflow: setup on the host CPU, checkpoint, solve on the
default device.

This is the production shape of the framework on accelerators - the
piece the reference (serial C++) has no counterpart for:

  1. gauge field + K-cycle hierarchy setup on the host CPU backend
     (complex64; null-vector solves, Galerkin coarse builds, optional
     dense coarsest inverse),
  2. checkpoint the hierarchy (qmg_tpu.checkpoint) so the setup is paid
     once per gauge configuration,
  3. jit the whole MG-preconditioned FGCR solve onto the device through
     the real-plane boundary (qmg_tpu.tpu_compat.make_planes_solver),
  4. validate the TRUE residual of the reconstructed solution on host.

Usage:
  python examples/checkpointed_solve.py 128 -0.06 --schur
  python examples/checkpointed_solve.py 256 -0.06 --ckpt mg256.npz

Configuration mirrors reference n13 (tests/n13_wilson_kcycle) by
default, or n19 (rbjacobi-Schur at every level) with --schur.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import Wilson2D
from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
from qmg_tpu.checkpoint import save_hierarchy, load_hierarchy
from qmg_tpu.stencil import StencilType
from qmg_tpu.tpu_compat import make_planes_solver, host_to_planes
from qmg_tpu.linalg import norm2sq
from qmg_tpu import u1
from qmg_tpu.rng import QMGRandom


def main():
    p = argparse.ArgumentParser()
    p.add_argument("L", type=int)
    p.add_argument("mass", type=float)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--n-refine", type=int, default=2)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--schur", action="store_true",
                   help="n19 rbjacobi-Schur configuration")
    p.add_argument("--ckpt", default=None,
                   help="hierarchy checkpoint path (reused if it exists)")
    args = p.parse_args()

    lat = Lattice2D(args.L, args.L, 2)
    rng = QMGRandom(1337)
    cpu = jax.devices("cpu")[0]

    ST = StencilType.RIGHT_SCHUR if args.schur else StencilType.ORIGINAL
    with jax.default_device(cpu):
        path = ("/root/reference/tests/common_cfgs_u1/"
                f"l{args.L}t{args.L}b{int(args.beta * 10)}_heatbath.dat")
        if os.path.exists(path):
            g = jnp.asarray(u1.read_gauge_u1(lat, path), jnp.complex64)
        else:
            g = jnp.asarray(u1.gauss_gauge_u1(lat, rng, args.beta),
                            jnp.complex64)
        op = Wilson2D(lat, args.mass, g, dtype=jnp.complex64)
        if args.ckpt and os.path.exists(args.ckpt):
            mg = load_hierarchy(args.ckpt, op)
            print(f"[QMG-SOLVE] restored hierarchy "
                  f"({mg.get_num_levels()} levels) from {args.ckpt}")
        else:
            t0 = time.time()
            cfg = KCycleConfig(
                n_refine=args.n_refine, coarse_dof=8, nullvec_tol=5e-4,
                nullvec_max_iter=300,
                coarsest_direct=not args.schur,
                fine_stencil_app=ST, coarsest_stencil_app=ST,
                precond_coarsen_rbjacobi=args.schur,
                build_extra=2 if args.schur else 0)
            mg = build_kcycle_hierarchy(lat, op, cfg, rng)
            print(f"[QMG-SOLVE] hierarchy setup {time.time() - t0:.0f} s "
                  f"({mg.get_num_levels()} levels)")
            if args.ckpt:
                save_hierarchy(mg, args.ckpt)
                print(f"[QMG-SOLVE] checkpointed to {args.ckpt}")
        b = np.asarray(rng.gaussian_cv(lat)).astype(np.complex64)

    solve, state = make_planes_solver(
        mg, tol=args.tol, max_iter=200, restart_freq=16,
        outer_type=ST if args.schur else None)
    solve = jax.jit(solve)
    dev = jax.devices()[0]
    state = jax.device_put(state, dev)
    bp = jax.device_put(host_to_planes(b), dev)

    t0 = time.perf_counter()
    jax.block_until_ready(solve(state, bp))
    print(f"[QMG-SOLVE] compile+first solve "
          f"{time.perf_counter() - t0:.1f} s on {dev.device_kind}")
    t0 = time.perf_counter()
    xp, iters, rsq = jax.block_until_ready(solve(state, bp))
    dt = time.perf_counter() - t0
    it = int(iters)
    xh = np.asarray(xp)
    with jax.default_device(cpu):
        x = jax.lax.complex(jnp.asarray(xh[..., 0]), jnp.asarray(xh[..., 1]))
        bj = jnp.asarray(b)
        resid = float(jnp.sqrt(norm2sq(bj - op.apply_M(x.astype(
            jnp.complex64))) / norm2sq(bj)))
    print(f"[QMG-SOLVE] solve: {it} outer iters, {dt * 1e3:.1f} ms, "
          f"true resid {resid:.2e}")
    if resid > 10 * args.tol:
        print("[QMG-SOLVE] WARNING: true residual exceeds tolerance")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
