"""Flagship scenario: MG K-cycle solve of the interacting Wilson operator.

Mirrors the reference CLI (tests/n13_wilson_kcycle/wilson_kcycle.cpp:33-41):

    python examples/wilson_kcycle.py L mass beta n_refine

e.g. ``python examples/wilson_kcycle.py 64 -0.075 6.0 2``. Loads the
shipped heatbath config when (L, beta) matches a fixture; otherwise runs
the non-compact heatbath. Prints [QMG-*]-tagged output like the reference,
including the per-level [QMG-OPS-STATS] report.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def find_config(L, beta):
    for root in ("/root/reference/tests/common_cfgs_u1",
                 os.path.join(os.path.dirname(__file__), "..", "configs")):
        b = {6.0: "b60", 10.0: "b100"}.get(beta)
        if b is None:
            return None
        path = os.path.join(root, f"l{L}t{L}{b}_heatbath.dat")
        if os.path.exists(path):
            return path
    return None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("L", type=int)
    p.add_argument("mass", type=float, help="try -0.075 for beta 6.0")
    p.add_argument("beta", type=float)
    p.add_argument("n_refine", type=int)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the default device")
    p.add_argument("--spectrum", action="store_true",
                   help="print the full fine + coarsened spectra "
                        "(reference n13 do_spectrum, wilson_kcycle.cpp:"
                        "482-522)")
    p.add_argument("--spectrum-nev", type=int, default=0,
                   help="with --spectrum: print only the nev smallest-"
                        "|lambda| eigenvalues per level via shift-invert "
                        "Arnoldi (usable at sizes where the dense "
                        "full-spectrum path is infeasible)")
    p.add_argument("--colinear-nev", type=int, default=64,
                   help="number of lowest-|lambda| eigenvectors in the "
                        "--colinear study (0 = the full spectrum, the "
                        "reference behavior; each vector costs a coarse "
                        "solve)")
    p.add_argument("--colinear", action="store_true",
                   help="per-eigenvector colinearity checks "
                        "||(1-PP^t)v|| and ||(1-P A_c^-1 P^t A)v|| "
                        "(reference n13 do_colinear, wilson_kcycle.cpp:"
                        "524-615)")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    # The reference contract is fp64 (tol 1e-10), on any backend.
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu.operators import Wilson2D
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu import u1, solvers
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.linalg import norm2sq

    lat = Lattice2D(args.L, args.L, 2)
    rng = QMGRandom(1337)

    cfg_path = find_config(args.L, args.beta)
    if cfg_path:
        gauge = u1.read_gauge_u1(lat, cfg_path)
        print(f"[QMG-GAUGE]: loaded {cfg_path}")
    else:
        print(f"[QMG-NOTE]: L = {args.L} beta = {args.beta} requires "
              "heatbath generation.")
        lat_g = lat.with_nc(1)
        ph = np.zeros((2, 2, lat_g.y_len, lat_g.xh))
        for i in range(0, 4000, 400):
            ph = u1.heatbath_noncompact_update(ph, lat_g, args.beta, 400,
                                               rng)
            g = u1.phases_to_links(ph)
            print(f"[QMG-HEATBATH]: Update {i} Plaq "
                  f"{float(jnp.real(u1.get_plaquette_u1(g, lat_g))):.6f} "
                  f"Topo {float(u1.get_topo_u1(g, lat_g)):.3f}")
        gauge = u1.phases_to_links(ph)
    plaq = complex(u1.get_plaquette_u1(gauge, lat))
    print(f"[QMG-GAUGE]: plaquette {plaq.real:.6f} topo "
          f"{float(u1.get_topo_u1(gauge, lat)):.3f}")

    op = Wilson2D(lat, args.mass, gauge)
    cfg = KCycleConfig(n_refine=args.n_refine, coarse_dof=8, tol=args.tol)
    t0 = time.time()
    mg = build_kcycle_hierarchy(lat, op, cfg, rng)
    print(f"[QMG-SETUP]: {mg.get_num_levels()} levels built in "
          f"{time.time()-t0:.1f}s")

    b = jnp.asarray(rng.gaussian_cv(lat))
    t0 = time.time()
    res = mg.solve(b, tol=args.tol, max_iter=cfg.max_iter,
                   restart_freq=cfg.restart_freq)
    dt = time.time() - t0
    resid = float(jnp.sqrt(norm2sq(b - op.apply_M(res.x)) / norm2sq(b)))
    print(f"Multigrid {'converged' if bool(res.converged) else 'failed'} "
          f"in {int(res.iters)} iterations with alleged tolerance "
          f"{float(jnp.sqrt(res.res_sq / norm2sq(b))):.3e}.")
    print(f"Check tolerance {resid:.3e}")
    print(f"[QMG-TIMING]: solve wall time {dt:.2f}s")

    # Ops/iteration report (reference n22:506-522 format).
    names = ["NULLVEC", "KRYLOV", "PRESMOOTH", "POSTSMOOTH"]
    total_flops = 0.0
    for lvl in range(mg.get_num_levels()):
        counts = [mg.get_tracker_count(t, lvl) for t in range(4)]
        print(f"[QMG-OPS-STATS]: Level {lvl} "
              + " ".join(f"{n} {c}" for n, c in zip(names, counts)))
        # Dslash flops: 5 site matvecs of nc x nc complex per apply.
        lat_l = mg.get_lattice(lvl)
        flops_per_apply = 5 * lat_l.volume * (8 * lat_l.nc ** 2
                                              - 2 * lat_l.nc)
        total_flops += sum(counts) * flops_per_apply
    print("[QMG-ITER-STATS]: avg iterations per level "
          + " ".join(f"{v:.2f}" for v in mg.query_average_iterations()))
    print(f"[QMG-FLOPS]: ~{total_flops/1e9:.2f} GFLOP of operator applies"
          f" ({total_flops/dt/1e9:.1f} GFLOP/s over the solve)")

    if args.spectrum:
        # Full spectra of the fine and coarsened operators, smallest real
        # part first (reference n13:482-522, [ORIG-SPECTRUM] /
        # [COARSE-SPECTRUM] tags).
        from qmg_tpu import eig
        for lvl, tag in ((0, "ORIG-SPECTRUM"), (1, "COARSE-SPECTRUM")):
            st = mg.get_stencil(lvl)
            mv = st.get_apply_function()
            if args.spectrum_nev > 0:
                def _solve(v, mv=mv):
                    return solvers.bicgstab_l(mv, v, max_iter=4000,
                                              tol=1e-10).x
                evals, _ = eig.shift_invert_eigensystem(
                    _solve, st.lat.cv_shape(), nev=args.spectrum_nev,
                    sigma=0.0, matvec=mv)
            else:
                evals, _ = eig.dense_eigensystem(mv, st.lat.cv_shape())
            for i, ev in enumerate(evals):
                print(f"[{tag}]: {i} {ev.real} + I {ev.imag}")

    if args.colinear:
        # Local colinearity of the fine eigenvectors with the coarse
        # space (reference n13:524-615): for each fine eigenvector v
        # (smallest magnitude first), report ||(1 - P P^dag) v|| and
        # ||(1 - P A_c^{-1} P^dag A) v|| relative to ||v||.
        from qmg_tpu import eig
        st0, st1 = mg.get_stencil(0), mg.get_stencil(1)
        transfer = mg.get_transfer(0)
        evals, evecs = eig.dense_eigensystem(st0.get_apply_function(),
                                             st0.lat.cv_shape())
        order = np.argsort(np.abs(evals))
        evals, evecs = evals[order], evecs[order]
        coarse_mv = st1.get_apply_function()
        nev = (evecs.shape[0] if args.colinear_nev == 0
               else min(args.colinear_nev, evecs.shape[0]))
        for i in range(nev):
            v = jnp.asarray(evecs[i])
            nv = float(jnp.sqrt(norm2sq(v)))
            pdag_v = transfer.restrict_f2c(v)
            one_pp = float(jnp.sqrt(
                norm2sq(v - transfer.prolong_c2f(pdag_v)))) / nv
            pdag_av = transfer.restrict_f2c(st0.apply_M(v))
            inv = solvers.bicgstab_l(coarse_mv, pdag_av, max_iter=1000,
                                     tol=1e-10, l=6)
            one_papa = float(jnp.sqrt(
                norm2sq(v - transfer.prolong_c2f(inv.x)))) / nv
            print(f"[QMG-OVERLAP]: {i} {evals[i].real} + I "
                  f"{evals[i].imag} {abs(evals[i])} | {one_pp} | "
                  f"{one_papa}")


if __name__ == "__main__":
    main()
