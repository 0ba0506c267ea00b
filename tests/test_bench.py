"""bench.py's host-side pieces: the fp64 NumPy reference apply against
the compiled complex64 stencil apply, and the table of device peaks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bench
from qmg_tpu import u1
from qmg_tpu.lattice import Lattice2D
from qmg_tpu.operators import GaugedLaplace2D, Staggered2D, Wilson2D
from qmg_tpu.rng import QMGRandom
from qmg_tpu.stencil import apply_M, make_coeffs

# complex64 roundoff of an apply that sums up to 5 x nc = 40 terms per
# output component is ~1e-7 relative; the reference is fp64.
C64_APPLY_TOL = 1e-6


def _operator(kind, L, rng):
    """(lattice, clover, hopping, shift, eo_shift, dof_shift) in fp64."""
    if kind == "coarse8":
        # A generic nc=8 coarse-level stencil with random coefficients
        # and all three shifts.
        lat = Lattice2D(L, L, 8)
        r = np.random.default_rng(L)

        def cplx(shape):
            return r.normal(size=shape) + 1j * r.normal(size=shape)
        return (lat, cplx(lat.cm_shape()),
                cplx((4,) + lat.cm_shape()), 0.3 - 0.1j, 0.05, -0.02j)
    nc = 2 if kind == "wilson" else 1
    lat = Lattice2D(L, L, nc)
    g = u1.gauss_gauge_u1(lat, rng, beta=6.0)
    op = {"wilson": lambda: Wilson2D(lat, -0.07, g),
          "staggered": lambda: Staggered2D(lat, 0.1, g),
          "gauged_laplace": lambda: GaugedLaplace2D(lat, 0.01, g)}[kind]()
    c = op.coeffs
    clover = None if c.clover is None else np.asarray(c.clover)
    return (lat, clover, np.asarray(c.hopping), complex(c.shift),
            complex(c.eo_shift), complex(c.dof_shift))


@pytest.mark.parametrize("L", [16, 32])
@pytest.mark.parametrize("kind", ["wilson", "staggered", "gauged_laplace",
                                  "coarse8"])
def test_c64_apply_matches_fp64_reference(kind, L):
    rng = QMGRandom(11)
    lat, clover, hopping, shift, eo_shift, dof_shift = _operator(kind, L,
                                                                 rng)
    x = np.asarray(rng.gaussian_cv(lat))
    coeffs = make_coeffs(
        lat, clover=None if clover is None else jnp.asarray(clover,
                                                            jnp.complex64),
        hopping=jnp.asarray(hopping, jnp.complex64), shift=shift,
        eo_shift=eo_shift, dof_shift=dof_shift, dtype=jnp.complex64)
    got = jax.jit(apply_M)(coeffs, jnp.asarray(x, jnp.complex64))
    assert got.dtype == jnp.complex64
    expect = bench.reference_apply(lat, clover, hopping, x, shift=shift,
                                   eo_shift=eo_shift, dof_shift=dof_shift)
    err = bench.rel_l2(np.asarray(got), expect)
    assert err <= C64_APPLY_TOL, f"{kind} L={L}: rel err {err:.3e}"


def test_peaks_table_resolves_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbs"] == 3350.0
    assert peaks["f32_tflops"] == 67.0


def test_peaks_table_rejects_unknown_kind():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_trace_summary_refuses_trace_without_device_kernels(tmp_path):
    """A traced run in which nothing ran on a GPU is refused, not
    reported as an idle device."""
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda x: x * 2.0)(jnp.ones(8)))
    with pytest.raises(RuntimeError, match="no device kernels"):
        bench.trace_summary(str(tmp_path), "", "apply_M_8x8_nc2")


def test_kcycle_deflation_needs_device_setup():
    args = bench.parse_args(["--mode", "kcycle", "--setup", "host",
                             "--size", "32", "--deflate", "2"])
    with pytest.raises(SystemExit, match="--deflate requires --setup"):
        bench.bench_kcycle(args)
