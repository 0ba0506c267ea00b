"""Benchmarks of the Wilson Dslash and the n13 K-cycle on one accelerator.

Modes (``--mode``):

  dslash  the fine Wilson apply (stencil.apply_M, complex64, compiled by
          XLA) in a chain of ``--iters`` applies; reports ms/apply and
          effective bandwidth over the generic formulation's minimum
          traffic, and checks one apply against an fp64 NumPy reference
          at default and at "highest" matmul precision;
  kcycle  the n13 K-cycle solve: hierarchy setup (``--setup device`` runs
          it on the accelerator, ``host`` builds it eagerly on the CPU),
          then the planes FGCR solve with the K-cycle preconditioner;
  refine  the n13 fp64 contract: c64 K-cycle solves on the accelerator
          inside an fp64 defect correction on the host.

Every printed result names the device it ran on. Rates are divided by
the peaks in ``PEAKS``, keyed by ``device_kind``; a device missing from
the table is an error, not a default.

    python bench.py --size 2048                         # Dslash
    python bench.py --mode kcycle --setup device --size 512
    python bench.py --mode refine --setup device --size 256
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# Published peaks per device_kind as JAX reports it. Source: NVIDIA H100
# Tensor Core GPU datasheet, SXM5 part (HBM3 3.35 TB/s; 67 TFLOP/s FP32
# outside the tensor cores), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f32_tflops": 67.0},
}

MASS_DSLASH = -0.075
MASS_N13 = -0.06
TOL_N13 = 1e-5          # c64 K-cycle target (the fp64 1e-10 is --mode refine)
SEED = 1337


def device_peaks(kind: str) -> dict:
    """Peak rates of a device kind; unknown kinds raise."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks recorded for device kind "
                       f"{kind!r}; add them to bench.PEAKS") from None


def device_tag() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def peak_bytes_in_use():
    """Device high-water mark of the program's arrays (None where the
    backend keeps no statistics, as on the CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# fp64 NumPy reference of a distance-1 stencil apply, on the full (Y, X)
# grid. It is written independently of stencil.py/cshift.py (plain
# np.roll on the unpacked lattice) so that it can check them.
# ---------------------------------------------------------------------------

def reference_apply(lat, clover, hopping, x, shift=0.0, eo_shift=0.0,
                    dof_shift=0.0):
    """complex128 M x for eo-packed ``clover`` (2, Y, Xh, nc, nc),
    ``hopping`` (4, 2, Y, Xh, nc, nc) over the pulls (+x, +y, -x, -y)
    and field ``x`` (2, Y, Xh, nc); either coefficient may be None.
    ``shift`` is the mass, ``eo_shift`` adds +/- on even/odd sites,
    ``dof_shift`` +/- on the upper/lower half of the dof."""
    from qmg_tpu.lattice import eo_pack, eo_unpack

    def grid(a):
        return eo_unpack(np.asarray(a, np.complex128), lat)

    xg = grid(x)                                   # (Y, X, nc)
    out = np.zeros_like(xg)
    if clover is not None:
        out += np.einsum("yxij,yxj->yxi", grid(clover), xg)
    if hopping is not None:
        # hopping[d] multiplies x(s + d): pull = roll by -d.
        for d, (axis, step) in enumerate(((1, 1), (0, 1), (1, -1),
                                          (0, -1))):
            out += np.einsum("yxij,yxj->yxi", grid(hopping[d]),
                             np.roll(xg, -step, axis=axis))
    yy, xx = np.meshgrid(np.arange(lat.y_len), np.arange(lat.x_len),
                         indexing="ij")
    parity_sign = np.where((xx + yy) % 2 == 0, 1.0, -1.0)[..., None]
    out += (shift + eo_shift * parity_sign) * xg
    if dof_shift and lat.nc % 2 == 0:
        half = lat.nc // 2
        out[..., :half] += dof_shift * xg[..., :half]
        out[..., half:] -= dof_shift * xg[..., half:]
    return eo_pack(out, lat)


def rel_l2(a, ref) -> float:
    a = np.asarray(a, np.complex128).ravel()
    ref = np.asarray(ref, np.complex128).ravel()
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# Dslash.
# ---------------------------------------------------------------------------

def dslash_bytes_per_site(nc: int = 2, itemsize: int = 8) -> int:
    """Minimum traffic of one chained apply in the generic formulation:
    clover + 4 hopping matrices + x read + out write, plus the chain's
    renormalization (one more read and write of the field): 224 B/site
    for Wilson (nc=2) in complex64."""
    return (nc * nc + 4 * nc * nc + 2 * nc + 2 * nc) * itemsize


def run_dslash(L: int, iters: int, warmup: int = 1) -> dict:
    """Time a chain of ``iters`` c64 Wilson applies at L^2 and check one
    apply against ``reference_apply``. Returns the numbers."""
    import jax
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu.operators.wilson import wilson_coeffs_numpy
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.stencil import apply_M, make_coeffs
    from qmg_tpu.tpu_compat import from_planes, host_to_planes, to_planes
    from qmg_tpu import u1

    lat = Lattice2D(L, L, 2)
    rng = QMGRandom(SEED)
    gauge = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    clover, hopping = wilson_coeffs_numpy(lat, gauge)
    x = rng.gaussian_cv(lat)
    x = x / np.linalg.norm(x.ravel())
    dev = [jax.device_put(host_to_planes(a))
           for a in (clover, hopping, x)]

    def coeffs(clover_p, hopping_p):
        return make_coeffs(lat, clover=from_planes(clover_p),
                           hopping=from_planes(hopping_p),
                           shift=MASS_DSLASH, dtype=jnp.complex64)

    def one_apply(precision):
        @jax.jit
        def fn(clover_p, hopping_p, x_p):
            with jax.default_matmul_precision(precision):
                return to_planes(apply_M(coeffs(clover_p, hopping_p),
                                         from_planes(x_p)))
        return fn

    expect = reference_apply(lat, clover, hopping, x, shift=MASS_DSLASH)
    errs = {}
    for prec in ("default", "highest"):
        got = np.asarray(jax.device_get(one_apply(prec)(*dev)))
        errs[prec] = rel_l2(got[..., 0] + 1j * got[..., 1], expect)

    # No precision pin: on the H100 the default and "highest" applies
    # agree to the last digit (PERF.md, PR 1).
    @jax.jit
    def chain(clover_p, hopping_p, x_p):
        c = coeffs(clover_p, hopping_p)

        def body(_, v):
            y = apply_M(c, v)
            return y / jnp.sqrt(jnp.sum(jnp.abs(y) ** 2))

        out = jax.lax.fori_loop(0, iters, body, from_planes(x_p))
        return jnp.sum(jnp.abs(out))

    # The Krylov projections of the GCR direction store (R, n) @ (n,),
    # as solvers._gcr_impl forms them.
    r = np.random.default_rng(SEED)
    store = (r.normal(size=(16, x.size)) + 1j * r.normal(size=(16, x.size))
             ) / np.sqrt(x.size)
    v = x.reshape(-1)
    proj = np.conj(store) @ v

    def project(precision):
        @jax.jit
        def fn(a, b):
            with jax.default_matmul_precision(precision):
                return jnp.conj(a) @ b
        return fn

    store_c, v_c = (jax.device_put(np.asarray(a, np.complex64))
                    for a in (store, v))
    for prec in ("default", "highest"):
        errs["proj_" + prec] = rel_l2(
            np.asarray(project(prec)(store_c, v_c)), proj)

    for _ in range(warmup):
        jax.block_until_ready(chain(*dev))
    t0 = time.perf_counter()
    checksum = float(jax.block_until_ready(chain(*dev)))
    dt = time.perf_counter() - t0
    gbs = dslash_bytes_per_site(lat.nc) * lat.volume * iters / dt / 1e9
    return {"L": L, "iters": iters, "ms_per_apply": dt * 1e3 / iters,
            "gbs": gbs, "gsites_per_s": lat.volume * iters / dt / 1e9,
            "rel_err_default": errs["default"],
            "rel_err_highest": errs["highest"],
            "proj_err_default": errs["proj_default"],
            "proj_err_highest": errs["proj_highest"], "checksum": checksum}


def bench_dslash(args):
    r = run_dslash(args.size, args.iters, args.warmup)
    tag = device_tag()
    share = r["gbs"] / device_peaks(tag["kind"])["hbm_gbs"]
    print(f"# wilson dslash {args.size}^2 c64 (XLA): "
          f"{r['ms_per_apply']:.4f} ms/apply, {r['gsites_per_s']:.3f} "
          f"Gsites/s, {r['gbs']:.1f} GB/s = {100 * share:.1f}% of the "
          f"published HBM peak; rel err vs fp64 reference "
          f"{r['rel_err_default']:.3e} (default precision) / "
          f"{r['rel_err_highest']:.3e} (highest); Krylov projection "
          f"{r['proj_err_default']:.3e} / {r['proj_err_highest']:.3e} on "
          f"{tag['kind']}", file=sys.stderr)
    print(json.dumps({"metric": "wilson_dslash_effective_bandwidth",
                      "value": r["gbs"], "unit": "GB/s",
                      "hbm_peak_share": share,
                      "ms_per_apply": r["ms_per_apply"],
                      "rel_err_default": r["rel_err_default"],
                      "rel_err_highest": r["rel_err_highest"],
                      "proj_err_default": r["proj_err_default"],
                      "proj_err_highest": r["proj_err_highest"],
                      "device": tag}))
    return r


# ---------------------------------------------------------------------------
# n13 K-cycle.
# ---------------------------------------------------------------------------

def n13_depth(L: int) -> int:
    """Refinement depth that keeps the coarsest level tiny: the direct
    coarsest densifies by probing its full basis, and a 64^2 x nc8
    coarsest (L=1024 at depth 2) would mean 32768 probes and an 8 GB
    dense inverse."""
    return 2 if L <= 256 else (3 if L <= 1024 else 4)


def n13_restarts(L: int):
    """(outer/coarsest, inner) GCR restart lengths. Right-sized direction
    stores at 2048^2: the trajectories never reach deeper (~10 outer
    iterations; the inner solves at tol 0.2 stop in < 8)."""
    return (16, 8) if L >= 2048 else (32, 32)


def n13_scaffold(args, L, rng, **cfg_kw):
    """The fine Wilson operator and the K-cycle hierarchy, built on the
    host CPU device: complete for ``--setup host``, structure only for
    ``--setup device`` (the device setup supplies every array)."""
    import jax
    import jax.numpy as jnp
    from qmg_tpu.lattice import Lattice2D
    from qmg_tpu.operators import Wilson2D
    from qmg_tpu.setup import KCycleConfig, build_kcycle_hierarchy
    from qmg_tpu import u1

    lat = Lattice2D(L, L, 2)
    with jax.default_device(jax.devices("cpu")[0]):
        gauge = jnp.asarray(u1.gauss_gauge_u1(lat, rng, 6.0),
                            dtype=jnp.complex64)
        op = Wilson2D(lat, MASS_N13, gauge, dtype=jnp.complex64)
        cfg = KCycleConfig(n_refine=n13_depth(L), coarse_dof=8,
                           nullvec_tol=5e-4, nullvec_max_iter=200,
                           **cfg_kw)
        mg = build_kcycle_hierarchy(lat, op, cfg, rng,
                                    structure_only=args.setup == "device")
    return lat, np.asarray(gauge), cfg, mg


def device_setup(args, lat, cfg, gauge, rng):
    """Run the device-resident setup twice: cold (compile included) and
    warm (fresh seeds, the per-configuration rebuild cost)."""
    import jax
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.setup_planes import (make_kcycle_setup_planes,
                                      gauss_seed_planes)
    from qmg_tpu.tpu_compat import host_to_planes

    cf = (lat.y_len >= 2048 if args.channels_first == "auto"
          else args.channels_first == "on")
    setup_fn = make_kcycle_setup_planes(lat, cfg, MASS_N13,
                                        channels_first=cf,
                                        deflate_low=args.deflate)
    gauge_p = host_to_planes(gauge)
    seeds = gauss_seed_planes(lat, cfg, rng)
    t0 = time.perf_counter()
    state = jax.block_until_ready(setup_fn(gauge_p, *seeds))
    t_cold = time.perf_counter() - t0
    seeds2 = gauss_seed_planes(lat, cfg, QMGRandom(7))
    t0 = time.perf_counter()
    jax.block_until_ready(setup_fn(gauge_p, *seeds2))
    t_warm = time.perf_counter() - t0
    print(f"# kcycle {lat.y_len}^2 device setup: {t_cold:.2f} s cold "
          f"(compile included), {t_warm:.3f} s warm (per-configuration "
          "rebuild)", file=sys.stderr)
    return state, t_cold, t_warm


def n13_true_residual(lat, gauge, b, x) -> float:
    """fp64 ||b - M x|| / ||b|| on the host for the n13 Wilson operator
    built from ``gauge``, with ``reference_apply``."""
    from qmg_tpu.operators.wilson import wilson_coeffs_numpy
    clover, hopping = wilson_coeffs_numpy(lat, gauge)
    mx = reference_apply(lat, clover, hopping, x, shift=MASS_N13)
    return rel_l2(mx, b)


def bench_kcycle(args):
    """The n13 K-cycle solve through the planes whole-solver wrapper.
    Returns a dict of the measured numbers (single rhs)."""
    import jax
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.tpu_compat import make_planes_solver, host_to_planes

    L = args.size
    rng = QMGRandom(SEED)
    tol = TOL_N13
    if args.deflate and args.setup != "device":
        raise SystemExit("--deflate requires --setup device (deflation "
                         "is computed inside the device-resident setup)")
    restart, inner_restart = n13_restarts(L)
    outer_type = None
    cfg_kw = {}
    if args.outer == "schur":
        # n19 configuration (reference tests/n19_wilson_kcycle_precond/
        # wilson_kcycle_precond.cpp:107,171,290): rbjacobi null-vector
        # generation + coarsening, RIGHT_SCHUR solves at every level; the
        # Schur system lives on the even half-space, halving every coarse
        # level's active dimension.
        from qmg_tpu.stencil import StencilType
        from qmg_tpu.operators.coarse import CoarseOperator2D
        outer_type = StencilType.RIGHT_SCHUR
        cfg_kw = dict(fine_stencil_app=StencilType.RIGHT_SCHUR,
                      coarsest_stencil_app=StencilType.RIGHT_SCHUR,
                      nullvec_stype=StencilType.RIGHT_JACOBI,
                      nullvec_solver="gcr_restart",
                      precond_coarsen_rbjacobi=True,
                      build_extra=CoarseOperator2D.BUILD_RBJACOBI)
    if args.deflate:
        # Deflation projects the NORMAL coarsest op's low modes
        # (reference stateful_multigrid.h:613-696): the coarsest solve
        # becomes CG on Mdag M, and the dense inverse is off.
        from qmg_tpu.stencil import StencilType
        cfg_kw["coarsest_stencil_app"] = StencilType.MDAGGER_M
    lat, gauge, cfg, mg = n13_scaffold(
        args, L, rng, inner_restart_freq=inner_restart,
        coarsest_restart_freq=restart,
        coarsest_direct=not args.no_direct and not args.deflate, **cfg_kw)
    solver_kw = dict(tol=tol, restart_freq=restart,
                     coarse_apply=args.coarse_apply)

    if args.nrhs > 1:
        # Batched multi-RHS throughput mode.
        if args.calibrated:
            if args.fixed_schedule:
                raise SystemExit("--calibrated picks its own outer "
                                 "trip count; drop --fixed-schedule")
            from qmg_tpu.tpu_compat import (
                make_calibrated_batched_planes_solver)
            probe_b = host_to_planes(rng.gaussian_cv(lat))
            solve_planes, state, outer_cal = (
                make_calibrated_batched_planes_solver(
                    mg, probe_b, max_iter=200, **solver_kw))
            print(f"# calibrated fixed outer trips: {outer_cal}",
                  file=sys.stderr)
        elif args.fixed_schedule:
            from qmg_tpu.tpu_compat import make_fixed_batched_planes_solver
            parts = [int(p) for p in args.fixed_schedule.split(",")]
            masked_inner = len(parts) == 1
            if not masked_inner:
                # 'OUTER,INNER': trip-count every level.
                for lvl in range(1, mg.get_num_levels() - 1):
                    ls = mg.get_level_solve(lvl)
                    ls.fixed_trips = True
                    ls.intermediate_iters = parts[1]
            # 'OUTER' alone: fixed outer + adaptive (masked) inner.
            solve_planes, state = make_fixed_batched_planes_solver(
                mg, outer_iters=parts[0], allow_masked_inner=masked_inner,
                **solver_kw)
        else:
            from qmg_tpu.tpu_compat import make_batched_planes_solver
            solve_planes, state = make_batched_planes_solver(
                mg, max_iter=200, **solver_kw)
        b = np.stack([rng.gaussian_cv(lat) for _ in range(args.nrhs)])
    else:
        solve_planes, state = make_planes_solver(
            mg, max_iter=200, outer_type=outer_type, **solver_kw)
        b = rng.gaussian_cv(lat)
    b_p = host_to_planes(b)

    result = {"L": L, "setup": args.setup}
    if args.setup == "device":
        state, result["setup_cold_s"], result["setup_warm_s"] = (
            device_setup(args, lat, cfg, gauge, rng))
    state_dev = jax.device_put(state)
    b_dev = jax.device_put(b_p)
    solve_jit = jax.jit(solve_planes)
    t0 = time.perf_counter()
    jax.block_until_ready(solve_jit(state_dev, b_dev))
    result["solve_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xp, iters, res_sq = jax.block_until_ready(solve_jit(state_dev, b_dev))
    dt = time.perf_counter() - t0
    result["peak_bytes_in_use"] = peak_bytes_in_use()
    tag = device_tag()
    if args.trace:
        from qmg_tpu.stencil import apply_scope
        with jax.profiler.trace(args.trace):
            with jax.profiler.TraceAnnotation("solve"):
                jax.block_until_ready(solve_jit(state_dev, b_dev))
        hlo = solve_jit.lower(state_dev, b_dev).compile().as_text()
        with open(os.path.join(args.trace, "solve.hlo.txt"), "w") as f:
            f.write(hlo)
        result["trace"] = trace_summary(args.trace, hlo, apply_scope(lat))
        print(f"# trace: {json.dumps(result['trace'])}", file=sys.stderr)

    if args.nrhs > 1:
        sched = (f" fixed-schedule {args.fixed_schedule}"
                 if args.fixed_schedule else "")
        print(f"# wilson kcycle {L}^2 c64 x{args.nrhs} rhs{sched}: "
              f"per-rhs iters {np.asarray(iters).tolist()} "
              f"(worst res_sq {float(np.max(np.asarray(res_sq))):.2e}, "
              f"target {tol}) in {dt * 1e3:.1f} ms total = "
              f"{dt * 1e3 / args.nrhs:.1f} ms/rhs on {tag['kind']}",
              file=sys.stderr)
        if args.calibrated:
            # Calibration contract: every rhs meets the tolerance and
            # none overshoots it by more than a decade in residual norm
            # (res_sq is ||r||^2, target tol^2 * ||b||^2 per rhs).
            bsq = np.sum(np.abs(b) ** 2, axis=tuple(range(1, b.ndim)))
            rel = np.asarray(res_sq, np.float64) / (tol ** 2 * bsq)
            if not 1e-2 <= np.max(rel) <= 1.0:
                raise SystemExit(f"calibrated schedule off target: worst "
                                 f"rel res_sq {np.max(rel):.3e}x target")
            print(f"# calibrated: rel res_sq in [{np.min(rel):.3f}, "
                  f"{np.max(rel):.3f}] of target", file=sys.stderr)
        if args.chain > 1:
            per_solve = _chained_marginal(solve_planes, state_dev, b_dev,
                                          args.chain)
            print(f"# steady-state (chain {args.chain}): "
                  f"{per_solve * 1e3:.1f} ms/solve = "
                  f"{per_solve * 1e3 / args.nrhs:.2f} ms/rhs",
                  file=sys.stderr)
            print(json.dumps({
                "metric": "wilson_kcycle_batched_steady_ms_per_rhs",
                "value": per_solve * 1e3 / args.nrhs, "unit": "ms",
                "nrhs": args.nrhs, "device": tag}))
            return result
        print(json.dumps({"metric": "wilson_kcycle_batched_ms_per_rhs",
                          "value": dt * 1e3 / args.nrhs, "unit": "ms",
                          "nrhs": args.nrhs, "device": tag}))
        return result

    xp = np.asarray(jax.device_get(xp), np.float64)
    x = xp[..., 0] + 1j * xp[..., 1]
    result.update(solve_ms=dt * 1e3, iters=int(iters),
                  res_sq=float(res_sq),
                  true_resid=(n13_true_residual(lat, gauge, b, x)
                              if outer_type is None else None))
    peak = result["peak_bytes_in_use"]
    print(f"# wilson kcycle {L}^2 c64: {result['iters']} outer iters to "
          f"{tol} in {dt * 1e3:.2f} ms "
          f"({dt * 1e3 / max(result['iters'], 1):.2f} ms/iter), fp64 "
          f"true resid {result['true_resid']}, peak device memory "
          f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}"
          f" on {tag['kind']}", file=sys.stderr)
    print(json.dumps({"metric": "wilson_kcycle_solve_time",
                      "value": result["solve_ms"], "unit": "ms",
                      "outer_iters": result["iters"],
                      "true_resid": result["true_resid"],
                      "setup_cold_s": result.get("setup_cold_s"),
                      "setup_warm_s": result.get("setup_warm_s"),
                      "peak_bytes_in_use": peak, "device": tag}))
    return result


def trace_summary(trace_dir, hlo_text, scope) -> dict:
    """Reduce a jax.profiler trace of one solve.

    Device kernels are the events on the GPU planes' stream lines. Busy
    time is the union of their intervals; the idle share is 1 - busy
    over the traced ``solve`` annotation's window (the device span when
    the annotation is missing). Device time is attributed to ``scope``
    (a named scope, e.g. ``stencil.apply_scope`` of the fine lattice)
    through each kernel's fusion and its op_name metadata in the
    compiled module text ``hlo_text``; a fusion counts wholly for the
    scope of its root op.
    """
    import glob
    import re
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    pd = ProfileData.from_file(paths[-1])
    # Kernels of a fusion are named after its HLO instruction, with "."
    # and "-" written as "_".
    op_names = {re.sub(r"[.\-]", "_", name): op for name, op in re.findall(
        r'%?([\w.\-]+) = [^\n]*?metadata=\{[^}]*op_name="([^"]*)"',
        hlo_text)}
    kernels, window = [], None
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    kernels += list(line.events)
        elif plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == "solve":
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    if not kernels:
        raise RuntimeError(f"no device kernels in the trace {paths[-1]}")
    spans = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                   for ev in kernels)
    if window is None:
        window = (spans[0][0], max(e for _, e in spans))
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in spans:
        st, en = max(st, window[0]), min(en, window[1])
        if en <= st:
            continue
        if cur_e is None or st > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += 0 if cur_e is None else cur_e - cur_s
    in_scope = total = 0.0
    for ev in kernels:
        total += ev.duration_ns
        if scope in op_names.get(ev.name, ""):
            in_scope += ev.duration_ns
    span = window[1] - window[0]
    return {"window_ms": span / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / span, "kernel_ms": total / 1e6,
            "n_kernels": len(kernels), "scope": scope,
            "scope_share_of_kernel_time": in_scope / total}


def _chained_marginal(solve_planes, state, b, k):
    """Steady-state device cost of one batched solve: chain k solves in
    one program (each rhs perturbed by the previous solution) and take
    the k-vs-1 marginal, which removes dispatch and pipeline fill."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def chained(n):
        def run(state, b):
            def body(_, carry):
                b_cur, acc = carry
                x, _, rsq = solve_planes(state, b_cur)
                return b + jnp.float32(1e-3) * x, acc + jnp.sum(rsq)
            return lax.fori_loop(0, n, body, (b, jnp.float32(0.0)))[1]
        return jax.jit(run)

    c1, ck = chained(1), chained(k)
    jax.block_until_ready((c1(state, b), ck(state, b)))
    t0 = time.perf_counter()
    jax.block_until_ready(c1(state, b))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(ck(state, b))
    tk = time.perf_counter() - t0
    return (tk - t1) / (k - 1)


def bench_refine(args):
    """The n13 fp64 contract: c64 planes K-cycle solves on the device
    and host-fp64 defect correction to a TRUE relative residual of
    1e-10 (tpu_compat.make_refined_planes_solver). Returns the numbers."""
    import jax
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.tpu_compat import make_refined_planes_solver

    L = args.size
    rng = QMGRandom(SEED)
    lat, gauge, cfg, mg = n13_scaffold(
        args, L, rng, coarsest_direct=not args.no_direct)
    solve, state = make_refined_planes_solver(
        mg, tol=1e-10, inner_tol=1e-5, max_iter=200, restart_freq=32)
    b = np.asarray(rng.gaussian_cv(lat))
    if args.setup == "device":
        state, _, _ = device_setup(args, lat, cfg, gauge, rng)
    state_dev = jax.device_put(state)
    solve(b, state=state_dev)  # compile
    t0 = time.perf_counter()
    res = solve(b, state=state_dev)
    dt = time.perf_counter() - t0
    tag = device_tag()
    print(f"# wilson refined {L}^2: {res.outer_iters} outer passes, "
          f"{res.inner_iters} inner iters, TRUE fp64 resid "
          f"{res.rel_resid:.3e} (target 1e-10, converged={res.converged}) "
          f"in {dt * 1e3:.1f} ms on {tag['kind']}", file=sys.stderr)
    print(json.dumps({"metric": "wilson_refined_1e10_solve_time",
                      "value": dt * 1e3, "unit": "ms",
                      "outer_passes": res.outer_iters,
                      "true_resid": res.rel_resid, "device": tag}))
    return {"L": L, "solve_ms": dt * 1e3, "outer_passes": res.outer_iters,
            "inner_iters": res.inner_iters, "true_resid": res.rel_resid,
            "converged": res.converged}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--iters", type=int, default=400,
                   help="dslash mode: applies in the timed chain")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--mode", choices=["dslash", "kcycle", "refine"],
                   default="dslash")
    p.add_argument("--setup", default="host", choices=["host", "device"],
                   help="kcycle/refine: where the hierarchy setup runs. "
                        "'host' = eager CPU build; 'device' = the whole "
                        "setup jitted onto the accelerator (setup_planes) "
                        "on a structure-only host scaffold - the only "
                        "practical path at >= 1024^2")
    p.add_argument("--coarse-apply", default="jnp",
                   choices=["jnp", "gather"],
                   help="kcycle: coarse-level ORIGINAL apply formulation")
    p.add_argument("--no-direct", action="store_true",
                   help="kcycle: keep the iterative coarsest solve "
                        "instead of the dense-inverse direct one")
    p.add_argument("--nrhs", type=int, default=1,
                   help="kcycle: solve this many right-hand sides in ONE "
                        "batched device program "
                        "(make_batched_planes_solver); reports ms/rhs")
    p.add_argument("--fixed-schedule", type=str, default=None,
                   metavar="OUTER[,INNER]",
                   help="kcycle --nrhs: fixed-trip-count schedule. '12' = "
                        "fixed outer + adaptive masked inner; '12,4' = "
                        "trip-count every level")
    p.add_argument("--calibrated", action="store_true",
                   help="kcycle --nrhs: calibrate the fixed outer trip "
                        "count from ONE masked probe solve "
                        "(make_calibrated_batched_planes_solver) and "
                        "check the target is met within one decade")
    p.add_argument("--channels-first", default="auto",
                   choices=["auto", "on", "off"],
                   help="--setup device: run the setup stages in "
                        "channels-first real-pair arithmetic (cf.py); "
                        "auto = on at >= 2048^2")
    p.add_argument("--outer", default="original",
                   choices=["original", "schur"],
                   help="kcycle: outer operator formulation. 'schur' = "
                        "the n19 configuration (reference "
                        "tests/n19_wilson_kcycle_precond)")
    p.add_argument("--deflate", type=int, default=0,
                   help="kcycle --setup device: deflate this many low "
                        "eigenpairs of the coarsest normal operator "
                        "(reference stateful_multigrid.h:613-696)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="kcycle: after timing, trace one more solve with "
                        "jax.profiler into DIR and report the device idle "
                        "share and the fine apply's share of kernel time")
    p.add_argument("--chain", type=int, default=0,
                   help="kcycle --nrhs: also measure the steady-state "
                        "device cost by chaining this many solves in one "
                        "program; reports the marginal ms/rhs")
    return p.parse_args(argv)


def main_with_args(args):
    from qmg_tpu.cache import enable_persistent_cache
    enable_persistent_cache()
    if args.mode == "kcycle":
        return bench_kcycle(args)
    if args.mode == "refine":
        return bench_refine(args)
    return bench_dslash(args)


def main(argv=None):
    return main_with_args(parse_args(argv))


if __name__ == "__main__":
    main()
