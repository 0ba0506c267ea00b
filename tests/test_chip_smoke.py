"""chip_smoke.py's phases at a small size on the CPU, its four-card
phase on four virtual CPU devices, and its refusal to run without a
GPU. The card itself runs ``python chip_smoke.py``."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dslash_phase_small():
    r = chip_smoke.phase_dslash(L=32, iters=3)
    assert r["rel_err_highest"] <= chip_smoke.DSLASH_TOL
    assert r["ms_per_apply"] > 0


def test_kcycle_phase_small():
    r = chip_smoke.phase_kcycle(L=32)
    assert r["true_resid"] <= chip_smoke.KCYCLE_RESID
    assert r["setup_cold_s"] > 0 and r["setup_warm_s"] > 0


def test_refine_phase_small():
    r = chip_smoke.phase_refine(L=32)
    assert r["converged"] and r["true_resid"] <= chip_smoke.REFINE_TOL


def test_four_phase_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jax.clear_caches()  # big SPMD compiles: see test_sharded_dslash.py
    out = chip_smoke.phase_four(jax.devices()[:4], L=32)
    assert len(out) == 2
    for iters, _, resid in out.values():
        assert iters < 200 and resid <= chip_smoke.KCYCLE_RESID


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
