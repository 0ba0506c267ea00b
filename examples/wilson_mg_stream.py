"""Wilson MG measurement stream: n16 on the accelerator.

Mirrors reference test n16 (tests/n16_wilson_kcycle_heatbath/
wilson_kcycle_heatbath.cpp): non-compact heatbath evolution, and per
configuration a FULL multigrid setup rebuild followed by MG-solved
wall/point-source propagators and the folded per-timeslice pion
correlator.

The difference from the reference: the per-config setup rebuild runs
on the device through setup_planes.make_kcycle_setup_planes, compiled
once for the first configuration, where the reference redoes its whole
eager setup per configuration (wilson_kcycle_heatbath.cpp:361-441).

    python examples/wilson_mg_stream.py --L 32 --mass -0.06 --n-configs 10
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run_stream(L=32, beta=6.0, mass=-0.06, n_configs=10, n_therm=1000,
               n_update=100, n_refine=2, coarse_dof=8, tol=2e-6,
               seed=1337, verbose=True, batched=False):
    """Returns (pion_mean, pion_err, plaqs, iters_list).

    ``batched=True`` solves ALL sources of a configuration in ONE
    batched device program (make_batched_planes_solver). The
    reference streams one solve per source
    (wilson_kcycle_heatbath.cpp:468-499).
    """
    import jax
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu.operators import Wilson2D
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu.setup_planes import (make_kcycle_setup_planes,
                                      gauss_seed_planes)
    from qmg_tpu.tpu_compat import (make_planes_solver,
                                    make_batched_planes_solver,
                                    host_to_planes)
    from qmg_tpu import u1, measure
    from qmg_tpu.rng import QMGRandom

    lat = Lattice2D(L, L, 2)
    lat_g = lat.with_nc(1)
    rng = QMGRandom(seed)
    cfg = KCycleConfig(n_refine=n_refine, coarse_dof=coarse_dof,
                       nullvec_tol=5e-4, nullvec_max_iter=200,
                       coarsest_direct=True)

    # Shape-only scaffold once; per-config state comes from the
    # device-resident setup.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        g0 = jnp.asarray(u1.unit_gauge_u1(lat), jnp.complex64)
        op_shape = Wilson2D(lat, mass, g0, dtype=jnp.complex64)
        mg = build_kcycle_hierarchy(lat, op_shape, cfg, QMGRandom(1),
                                    structure_only=True)
        if batched:
            solve_planes, _ = make_batched_planes_solver(
                mg, tol=tol, max_iter=200, restart_freq=32)
        else:
            solve_planes, _ = make_planes_solver(mg, tol=tol, max_iter=200,
                                                 restart_freq=32)
    solve_jit = jax.jit(solve_planes)
    # Channels-first setup stages at 2048^2 and up, as bench.py.
    setup_fn = make_kcycle_setup_planes(lat, cfg, mass,
                                        channels_first=L >= 2048)

    # Point sources at the origin, one per spin (reference n16:468).
    srcs = []
    for c in range(2):
        s = np.zeros(lat.cv_shape(), dtype=np.complex128)
        pp, yy, xh = lat.coord_to_pyx(0, 0)
        s[pp, yy, xh, c] = 1.0
        srcs.append(host_to_planes(s))

    ph = np.zeros((2, 2, L, lat_g.xh))
    if verbose:
        print(f"[QMG-NOTE]: thermalizing {n_therm} heatbath updates")
    ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_therm, rng)

    pions, plaqs, iters_list = [], [], []
    t_start = time.time()
    for icfg in range(n_configs):
        ph = u1.heatbath_noncompact_update(ph, lat_g, beta, n_update, rng)
        gauge = np.exp(1j * ph)

        t0 = time.time()
        seeds = gauss_seed_planes(lat, cfg, rng)
        state = setup_fn(host_to_planes(gauge), *seeds)
        pion = np.zeros(L)
        ok = True
        if batched:
            # ONE device program solves every source of this config.
            X_p, iters_b, rsq = solve_jit(state, jnp.stack(srcs))
            it = int(np.max(np.asarray(iters_b)))
            if it >= 200:
                print(f"[QMG-WARNING]: config {icfg} MG solve hit "
                      "max_iter - skipping config")
                ok = False
            else:
                for k in range(len(srcs)):
                    prop_sq = np.sum(
                        np.asarray(X_p[k], dtype=np.float64) ** 2,
                        axis=(0, 2, 3, 4))
                    pion += measure.fold_correlator(prop_sq)
        else:
            for s in srcs:
                xpl, iters, rsq = solve_jit(state, s)
                it = int(iters)
                if it >= 200:
                    print(f"[QMG-WARNING]: config {icfg} MG solve hit "
                          "max_iter - skipping config")
                    ok = False
                    break
                prop_sq = np.sum(np.asarray(xpl, dtype=np.float64) ** 2,
                                 axis=(0, 2, 3, 4))
                pion += measure.fold_correlator(prop_sq)
        if not ok:
            continue
        pions.append(pion)
        iters_list.append(it)
        with jax.default_device(cpu):
            g = u1.phases_to_links(np.asarray(ph))
            plaqs.append(float(np.real(complex(
                u1.get_plaquette_u1(g, lat_g)))))
        if verbose:
            print(f"[QMG-MEAS]: config {icfg+1}/{n_configs} "
                  f"plaq {plaqs[-1]:.5f} mg-iters {it} "
                  f"(setup+solves {time.time()-t0:.2f}s, "
                  f"total {time.time()-t_start:.0f}s)")

    pions = np.array(pions)
    mean = pions.mean(axis=0)
    err = (pions.std(axis=0) / np.sqrt(max(len(pions), 1))
           if len(pions) > 1 else np.zeros(L))
    return mean, err, plaqs, iters_list, pions


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--mass", type=float, default=-0.06)
    p.add_argument("--n-configs", type=int, default=10)
    p.add_argument("--n-therm", type=int, default=1000)
    p.add_argument("--n-update", type=int, default=100)
    p.add_argument("--n-refine", type=int, default=2)
    p.add_argument("--tol", type=float, default=2e-6)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the default device")
    p.add_argument("--batched", action="store_true",
                   help="solve all sources of a config in ONE batched "
                        "device program")
    p.add_argument("--save", default=None,
                   help="save per-config folded correlators to this "
                        ".npz (for offline refits)")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    mean, err, plaqs, iters, pions = run_stream(
        L=args.L, beta=args.beta, mass=args.mass,
        n_configs=args.n_configs, n_therm=args.n_therm,
        n_update=args.n_update, n_refine=args.n_refine, tol=args.tol,
        batched=args.batched)

    from qmg_tpu import measure
    print(f"[QMG-MEAS]: mean plaquette {np.mean(plaqs):.6f} "
          f"(+/- {np.std(plaqs)/np.sqrt(max(len(plaqs),1)):.6f})")
    print("[QMG-PION]: t C(t) err")
    for t in range(len(mean)):
        print(f"[QMG-PION]: {t} {mean[t]:.8e} {err[t]:.3e}")
    masses = measure.effective_mass_acosh(mean)
    mid = len(masses) // 2
    print(f"[QMG-MASS]: effective masses around t=L/4..L/2: "
          f"{[f'{m:.4f}' for m in masses[mid - 4:mid + 1]]}")
    # Plateau + jackknifed cosh-fit extraction, same protocol as
    # examples/wilson_goldstone.py (reference critical_mass.txt values).
    L = args.L
    lo, hi = L // 4, L // 2 - 1
    if len(pions) > 2:
        jk = []
        for drop in range(len(pions)):
            sub = np.delete(pions, drop, axis=0).mean(axis=0)
            m = measure.effective_mass_acosh(sub)[lo:hi]
            jk.append(np.nanmean(m))
        jk = np.array(jk)
        m_pi = np.nanmean(jk)
        m_err = np.sqrt((len(jk) - 1) * np.nanvar(jk))
        print(f"[QMG-PION-MASS]: m = {args.mass} -> m_pi = {m_pi:.5f} "
              f"+/- {m_err:.5f} (plateau t in [{lo},{hi}))")
        try:
            m_fit, e_fit, _ = measure.fit_cosh_mass(pions, lo, hi)
            print(f"[QMG-PION-MASS-FIT]: m = {args.mass} -> m_pi = "
                  f"{m_fit:.5f} +/- {e_fit:.5f} (cosh fit t in "
                  f"[{lo},{hi}))")
        except Exception as e:
            print(f"[QMG-WARNING]: cosh fit failed ({e})")
    if args.save:
        np.savez(args.save, pions=pions, plaqs=np.array(plaqs),
                 mass=args.mass, beta=args.beta, L=L)
        print(f"[QMG-NOTE]: per-config correlators saved to {args.save}")


if __name__ == "__main__":
    main()
