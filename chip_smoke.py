"""Smoke test of the main path on one GPU, through the normal entry points.

Phases (one process, one card):

  device  JAX's first device must be a GPU; prints the card's name and
          power limit as nvidia-smi reports them;
  dslash  the c64 Wilson apply_M at 2048^2 against an fp64 NumPy
          reference apply (relative L2 error <= 1e-5); ms/apply, GB/s;
  kcycle  the n13 configuration at --size (default 512^2): device-resident
          setup, then the planes FGCR solve with the K-cycle
          preconditioner and a direct coarsest to 1e-5; the fp64 true
          residual, recomputed on the host, must be <= 2e-5;
  refine  the n13 fp64 contract at 256^2: c64 inner solves on the card,
          fp64 defect correction on the host, to a true residual of
          1e-10.

``--four`` runs only the multi-device path on four cards, with the
single-card runs it is compared against.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed. Any failure raises, so the exit code is then
non-zero and no such line is printed.

    python chip_smoke.py              # device, dslash, kcycle, refine
    python chip_smoke.py --size 2048  # the same, with the K-cycle at 2048^2
    python chip_smoke.py --four       # the four-card path only
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DSLASH_L = 2048
DSLASH_ITERS = 100
# ~100x complex64 roundoff on an apply, and well below the ~5e-4 a TF32
# contraction would give.
DSLASH_TOL = 1e-5
KCYCLE_L = 512
KCYCLE_RESID = 2e-5     # the solve's tolerance is 1e-5
REFINE_L = 256
REFINE_TOL = 1e-10
FOUR_L = 2048


def gpu_name_and_power_limit() -> str:
    """nvidia-smi's name and power limit of each card (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(n: int = 1) -> dict:
    import jax
    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {d.platform} "
                           f"({d.device_kind})")
    if len(devices) < n:
        raise RuntimeError(f"need {n} GPUs, JAX found {len(devices)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def phase_dslash(L: int = DSLASH_L, iters: int = DSLASH_ITERS) -> dict:
    import bench
    r = bench.run_dslash(L, iters)
    print(f"dslash {L}^2 c64: {r['ms_per_apply']:.4f} ms/apply, "
          f"{r['gbs']:.1f} GB/s ({bench.dslash_bytes_per_site()} B/site); "
          f"rel L2 error vs fp64 reference {r['rel_err_highest']:.3e} "
          f"(default matmul precision: {r['rel_err_default']:.3e}); "
          f"Krylov projection {r['proj_err_highest']:.3e} (default: "
          f"{r['proj_err_default']:.3e})")
    err = max(r["rel_err_default"], r["rel_err_highest"])
    if not err <= DSLASH_TOL:
        raise AssertionError(f"dslash error {err:.3e} > {DSLASH_TOL}")
    return r


def phase_kcycle(L: int = KCYCLE_L) -> dict:
    import bench
    r = bench.bench_kcycle(bench.parse_args(
        ["--mode", "kcycle", "--setup", "device", "--size", str(L)]))
    peak = r["peak_bytes_in_use"]
    print(f"kcycle {L}^2: setup {r['setup_cold_s']:.2f} s cold (compile "
          f"included), {r['setup_warm_s']:.3f} s warm; solve "
          f"{r['solve_ms']:.2f} ms, {r['iters']} outer iterations, fp64 "
          f"true residual {r['true_resid']:.3e}; peak device memory "
          f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if not r["iters"] < 200:
        raise AssertionError(f"kcycle did not converge in {r['iters']}")
    if not r["true_resid"] <= KCYCLE_RESID:
        raise AssertionError(f"kcycle true residual {r['true_resid']:.3e}"
                             f" > {KCYCLE_RESID}")
    return r


def phase_refine(L: int = REFINE_L) -> dict:
    import bench
    r = bench.bench_refine(bench.parse_args(
        ["--mode", "refine", "--setup", "device", "--size", str(L)]))
    print(f"refine {L}^2: {r['outer_passes']} outer passes, "
          f"{r['inner_iters']} inner iterations, fp64 true residual "
          f"{r['true_resid']:.3e} in {r['solve_ms']:.1f} ms")
    if not (r["converged"] and r["true_resid"] <= REFINE_TOL):
        raise AssertionError(f"refine true residual {r['true_resid']:.3e}"
                             f" > {REFINE_TOL}")
    return r


def phase_four(devices, L: int = FOUR_L) -> dict:
    """The multi-device legs of the dry run on ``devices``, then the c64
    planes solve at L^2 sharded over all of them against the same solve
    on the first device alone."""
    import jax
    import __graft_entry__
    import bench
    from qmg_tpu import parallel
    from qmg_tpu.rng import QMGRandom
    from qmg_tpu.tpu_compat import (host_to_planes, make_planes_solver,
                                    shard_planes_state)

    with jax.enable_x64(True):      # the legs' fp64 oracles
        __graft_entry__.multichip_legs(devices)

    args = bench.parse_args(["--mode", "kcycle", "--setup", "device",
                             "--size", str(L)])
    rng = QMGRandom(bench.SEED)
    restart, inner_restart = bench.n13_restarts(L)
    lat, gauge, cfg, mg = bench.n13_scaffold(
        args, L, rng, inner_restart_freq=inner_restart,
        coarsest_restart_freq=restart, coarsest_direct=True)
    state, _, _ = bench.device_setup(args, lat, cfg, gauge, rng)
    b = rng.gaussian_cv(lat)
    b_p = host_to_planes(b)
    kw = dict(tol=bench.TOL_N13, max_iter=200, restart_freq=restart)
    mesh = parallel.make_mesh(len(devices), devices=list(devices))
    out = {}
    for name, m in (("one card", None), (f"mesh {mesh.devices.shape}",
                                         mesh)):
        solve, _ = make_planes_solver(mg, mesh=m, **kw)
        st, bp = ((state, b_p) if m is None
                  else shard_planes_state(state, mesh, b_p))
        fn = jax.jit(solve)
        jax.block_until_ready(fn(st, bp))
        t0 = time.perf_counter()
        xp, iters, _ = jax.block_until_ready(fn(st, bp))
        dt = time.perf_counter() - t0
        xp = np.asarray(jax.device_get(xp), np.float64)
        resid = bench.n13_true_residual(lat, gauge, b,
                                        xp[..., 0] + 1j * xp[..., 1])
        print(f"four: c64 planes solve {L}^2 on {name}: {int(iters)} "
              f"outer iterations, {dt * 1e3:.2f} ms, fp64 true residual "
              f"{resid:.3e}")
        if not (int(iters) < 200 and resid <= KCYCLE_RESID):
            raise AssertionError(f"{name} solve failed: {int(iters)} "
                                 f"iterations, residual {resid:.3e}")
        out[name] = (int(iters), dt, resid)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=KCYCLE_L,
                   help="lattice extent of the kcycle phase")
    p.add_argument("--four", action="store_true",
                   help="run only the multi-device path, on four cards")
    args = p.parse_args(argv)

    import jax
    tag = require_gpu(4 if args.four else 1)
    from qmg_tpu.cache import enable_persistent_cache
    enable_persistent_cache()
    smi = gpu_name_and_power_limit()
    print(f"device: {tag['kind']} x{tag['count']}; nvidia-smi: {smi}")

    if args.four:
        devices = jax.devices()[:4]
        tag["count"] = len(devices)
        phases = [("four", lambda: phase_four(devices))]
    else:
        phases = [("dslash", phase_dslash),
                  ("kcycle", lambda: phase_kcycle(args.size)),
                  ("refine", phase_refine)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": tag}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
