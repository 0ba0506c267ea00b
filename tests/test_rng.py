"""std::mt19937 stream parity (the reference determinism anchor,
tests/n13_wilson_kcycle/wilson_kcycle.cpp:64).

Oracle values produced by a g++-compiled program:

    std::mt19937 gen(1337u);                      // raw draws
    std::uniform_real_distribution<double>(-1, 2) // uniforms
    std::normal_distribution<double>(0, 1)        // normals
"""

import numpy as np

from qmg_tpu.rng import StdMT19937

ORACLE_RAW = [1125387415, 2407456957, 681542492, 913057000, 1194544295,
              2332513753, 1972751015, 145906010]
ORACLE_UNI = [0.68158925878491128, -0.36223705288114671,
              0.62924203552174851, -0.89808582901536704,
              -0.29383367510442582, 0.77633910476117851]
ORACLE_NRM = [-1.4274419926557007, 0.30062281890886849,
              -0.51204031918524262, 0.047334099056932206,
              0.50038387490525837, -1.4374424883598245]


def test_raw_stream_matches_libstdcxx():
    g = StdMT19937(1337)
    assert [g.raw() for _ in range(8)] == ORACLE_RAW


def test_uniform_real_matches_libstdcxx():
    g = StdMT19937(1337)
    got = [g.uniform(-1.0, 2.0) for _ in range(6)]
    np.testing.assert_allclose(got, ORACLE_UNI, rtol=0, atol=0)


def test_normal_matches_libstdcxx():
    # Exact: StdMT19937.normal uses math.log/math.sqrt (C libm) - the
    # same functions libstdc++'s normal_distribution calls.
    g = StdMT19937(1337)
    got = [g.normal() for _ in range(6)]
    np.testing.assert_allclose(got, ORACLE_NRM, rtol=0, atol=0)


def test_refill_boundary():
    """Stream stays exact across the 624-word refill boundary."""
    g = StdMT19937(42)
    vals = [g.raw() for _ in range(1300)]
    g2 = StdMT19937(42)
    assert [g2.raw() for _ in range(1300)] == vals
    assert len(set(vals)) > 1290  # sanity: no stuck state


def test_heatbath_bit_exact_vs_cxx_oracle():
    """The non-compact heatbath driven by StdMT19937 reproduces a C++
    std::mt19937 + std::normal_distribution implementation of the
    reference sweep (u1/u1_utils.h:607-757) bit-for-bit.

    Oracle: 4x4, beta=6, 2 updates, seed 1337 (g++ / libstdc++)."""
    from qmg_tpu.lattice import Lattice2D, eo_unpack
    from qmg_tpu import u1

    oracle_first_rows = [
        (0.26332565145996267, -0.020930124943424194),
        (0.46057326116245878, 0.36725073711624517),
        (-0.038260695492047136, 0.10991781466761363),
    ]
    lat = Lattice2D(4, 4, 1)
    rng = StdMT19937(1337)
    ph = np.zeros((2, 2, lat.y_len, lat.xh))
    ph = u1.heatbath_noncompact_update(ph, lat, 6.0, 2, rng)
    grid = np.stack([eo_unpack(ph[mu], lat) for mu in range(2)])
    got = [(grid[0, 0, 0], grid[1, 0, 0]),
           (grid[0, 0, 1], grid[1, 0, 1]),
           (grid[0, 0, 2], grid[1, 0, 2])]
    for (gx, gy), (ox, oy) in zip(got, oracle_first_rows):
        assert gx == ox and gy == oy


def test_native_std_sweep_bit_exact_and_stream_sync():
    """The C++ StdMT19937 continuation (native.heatbath_sweeps_std) is
    bit-identical to the pure-Python sweep AND leaves the rng object in
    the identical stream state."""
    from qmg_tpu import native
    if not native.have_heatbath():
        import pytest
        pytest.skip("native library not built (make -C qmg_tpu/native)")
    from qmg_tpu.u1 import _heatbath_sweeps_numpy
    host = np.random.default_rng(5)
    ph0 = host.standard_normal((2, 24, 16))
    r_py, r_cc = StdMT19937(1337), StdMT19937(1337)
    for _ in range(7):  # start mid-stream with a cached normal
        r_py.normal(), r_cc.normal()
    ph_py = _heatbath_sweeps_numpy(ph0.copy(), 6.0, 3, r_py)
    ph_cc = native.heatbath_sweeps_std(ph0.copy(), 6.0, 3, r_cc)
    assert np.array_equal(ph_py, ph_cc)
    assert r_py._idx == r_cc._idx
    assert np.array_equal(r_py._mt, r_cc._mt)
    assert [r_py.normal() for _ in range(64)] == \
        [r_cc.normal() for _ in range(64)]
