"""Wilson goldstone (pion) mass measurement stream.

Mirrors reference test n15 (tests/n15_wilson_goldstone_u1_heatbath/
wilson_u1.cpp): non-compact heatbath evolution, per-config point-source
propagators for both spins, folded per-timeslice pion correlator, acosh
effective mass. Physics targets to reproduce: critical_mass.txt
(32^2, beta=6.0): m_pi(-0.06) = 0.1076(12), m_pi(-0.05) = 0.14087(81),
m_pi(-0.03) = 0.19324(62), m_pi(-0.01) = 0.23957(53), m_pi(+0.01) =
0.28205(47).

    python examples/wilson_goldstone.py --mass -0.06 --n-configs 40

Runs the propagator solves on the default JAX backend: fp64 BiCGstab(l)
by default, or the complex64 real-plane path with --c64.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--L", type=int, default=32)
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--mass", type=float, default=-0.06)
    p.add_argument("--n-configs", type=int, default=40)
    p.add_argument("--n-therm", type=int, default=1000)
    p.add_argument("--n-update", type=int, default=100)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--c64", action="store_true",
                   help="complex64 solves (tol 2e-6) instead of fp64")
    p.add_argument("--save", default=None,
                   help="save per-config folded correlators to this "
                        ".npz (for offline refits)")
    p.add_argument("--op", choices=["wilson", "staggered"],
                   default="wilson")
    args = p.parse_args()

    import jax
    if args.c64:
        dtype_c = "complex64"
        tol = args.tol or 2e-6
    else:
        jax.config.update("jax_enable_x64", True)
        dtype_c = "complex128"
        tol = args.tol or 1e-10
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu.operators.wilson import wilson_coeffs_numpy
    from qmg_tpu.stencil import apply_M, make_coeffs
    from qmg_tpu.tpu_compat import host_to_planes, from_planes, to_planes
    from qmg_tpu import u1, solvers, measure
    from qmg_tpu.rng import QMGRandom

    L = args.L
    nc = 2 if args.op == "wilson" else 1
    lat = Lattice2D(L, L, nc)
    lat_g = lat.with_nc(1)
    rng = QMGRandom(1337)
    cdt = jnp.dtype(dtype_c)
    fdt = np.float32 if dtype_c == "complex64" else np.float64

    mass = args.mass

    @jax.jit
    def _solve_one(cpl, hpl, bpl):
        coeffs = make_coeffs(lat,
                             clover=(from_planes(cpl) if cpl is not None
                                     else None),
                             hopping=from_planes(hpl), shift=mass,
                             dtype=cdt)
        res = solvers.bicgstab_l(lambda v: apply_M(coeffs, v),
                                 from_planes(bpl), max_iter=4000, tol=tol,
                                 l=6)
        return to_planes(res.x), res.iters, res.converged.astype("int32")

    # All dof sources solve in ONE batched device program (vmap over the
    # source axis; while_loop batching keeps per-source trajectories
    # exact) - the batched form of the reference's source loop
    # (n15:150). Returns stacked (nsrc, ...) planes/iters/flags.
    _solve_batch = jax.jit(jax.vmap(_solve_one, in_axes=(None, None, 0)))

    # Point sources at the origin, one per dof (reference n15:133,:150).
    srcs = []
    for c in range(nc):
        s = np.zeros(lat.cv_shape(), dtype=np.complex128)
        pp, yy, xh = lat.coord_to_pyx(0, 0)
        s[pp, yy, xh, c] = 1.0
        srcs.append(host_to_planes(s, dtype=fdt))

    ph = np.zeros((2, 2, L, lat_g.xh))
    print(f"[QMG-NOTE]: thermalizing {args.n_therm} heatbath updates")
    ph = u1.heatbath_noncompact_update(ph, lat_g, args.beta, args.n_therm,
                                       rng)

    pions, plaqs = [], []
    t_start = time.time()
    for cfg in range(args.n_configs):
        ph = u1.heatbath_noncompact_update(ph, lat_g, args.beta,
                                           args.n_update, rng)
        gauge = np.exp(1j * ph)
        if args.op == "wilson":
            clover, hopping = wilson_coeffs_numpy(lat, gauge)
            cpl = host_to_planes(clover, dtype=fdt)
        else:
            from qmg_tpu.operators import Staggered2D
            stag = Staggered2D(lat, mass, jnp.asarray(gauge), dtype=cdt)
            hopping = np.asarray(stag.coeffs.hopping)
            cpl = None
        hpl = host_to_planes(hopping, dtype=fdt)
        xpls, iters_all, convs = _solve_batch(cpl, hpl,
                                              jnp.stack(srcs))
        iters = iters_all[-1]
        if not all(int(c) for c in np.asarray(convs)):
            print(f"[QMG-WARNING]: config {cfg} solve did not "
                  f"converge (f32 breakdown?) - skipping config")
            continue
        pion = np.zeros(L)
        for xpl in np.asarray(xpls, dtype=np.float64):
            prop_sq = np.sum(xpl ** 2,
                             axis=(0, 2, 3, 4))  # per-y |prop|^2
            pion += measure.fold_correlator(prop_sq)
        pions.append(pion)
        g = u1.phases_to_links(np.asarray(ph))
        plaqs.append(float(np.real(complex(u1.get_plaquette_u1(g, lat_g)))))
        if (cfg + 1) % 10 == 0:
            print(f"[QMG-MEAS]: config {cfg+1}/{args.n_configs} "
                  f"plaq {plaqs[-1]:.5f} iters {int(iters)} "
                  f"({time.time()-t_start:.0f}s)")

    pions = np.array(pions)
    mean = pions.mean(axis=0)
    err = pions.std(axis=0) / np.sqrt(len(pions))
    print(f"[QMG-GAUGE-FINAL]: plaquette {np.mean(plaqs):.6f} +/- "
          f"{np.std(plaqs)/np.sqrt(len(plaqs)):.6f}")
    print("[QMG-BEGIN-PION]")
    for j in range(L):
        print(j, mean[j], "+/-", err[j])
    print("[QMG-END-PION]")
    meff = measure.effective_mass_acosh(mean)
    print("[QMG-BEGIN-PION-EFFMASS]")
    for j in range(1, L - 1):
        print(j, meff[j])
    print("[QMG-END-PION-EFFMASS]")
    # Plateau estimate: average over the middle third, jackknifed.
    lo, hi = L // 4, L // 2 - 1
    jk = []
    for drop in range(len(pions)):
        sub = np.delete(pions, drop, axis=0).mean(axis=0)
        m = measure.effective_mass_acosh(sub)[lo:hi]
        jk.append(np.nanmean(m))
    jk = np.array(jk)
    m_pi = np.nanmean(jk)
    m_err = np.sqrt((len(jk) - 1) * np.nanvar(jk))
    print(f"[QMG-PION-MASS]: m = {mass} -> m_pi = {m_pi:.5f} +/- "
          f"{m_err:.5f} (plateau t in [{lo},{hi}))")
    # Jackknifed weighted cosh FIT over the same window: uses every
    # timeslice coherently - near the critical mass this is far better
    # conditioned than the pointwise acosh plateau average (the
    # reference's reported form; both agree away from criticality).
    try:
        m_fit, e_fit, _ = measure.fit_cosh_mass(pions, lo, hi)
        print(f"[QMG-PION-MASS-FIT]: m = {mass} -> m_pi = {m_fit:.5f} "
              f"+/- {e_fit:.5f} (cosh fit t in [{lo},{hi}))")
    except Exception as e:  # fit breakdown: keep the plateau number
        print(f"[QMG-WARNING]: cosh fit failed ({e})")
    if args.save:
        np.savez(args.save, pions=pions, plaqs=np.array(plaqs),
                 mass=mass, beta=args.beta, L=L)
        print(f"[QMG-NOTE]: per-config correlators saved to {args.save}")


if __name__ == "__main__":
    main()
