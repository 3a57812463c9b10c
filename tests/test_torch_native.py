"""The port's native host library (geomesa_tpu_torch/native) against its
numpy plain twins and the JAX package's public functions, on the same
seeded inputs, on the CPU: the z2/z3 encoders, the DAY/WEEK binning, the
range decomposition, the fused binned z3 encode, the two sorts and the
sorted-order gather. The cases follow tests/test_native_zencode.py,
test_native_zrange.py and test_native_zbuild.py: NaN and out-of-range
inputs, ties at the sizes where the sorts' radix and bucket passes run,
sizes past a million rows where they and the gather run on several
threads, empty inputs. A failed compile raises and runs no
numpy path.

Tolerance: exact (bit for bit; sort orders and tie order included)."""

import importlib
import os

import numpy as np
import pytest

from geomesa_tpu.curves import timebin as jax_timebin
from geomesa_tpu.curves.sfc import z2sfc as jax_z2sfc
from geomesa_tpu.curves.sfc import z3sfc as jax_z3sfc
from geomesa_tpu.index.zkeys import ZKeyIndex as JaxZKeyIndex
from geomesa_tpu_torch import native
from geomesa_tpu_torch.curves import timebin
from geomesa_tpu_torch.curves.sfc import z2sfc, z3sfc
from geomesa_tpu_torch.index import zkeys

jax_zr = importlib.import_module("geomesa_tpu.curves.zranges")
zr = importlib.import_module("geomesa_tpu_torch.curves.zranges")

PERIODS = ["day", "week", "month", "year"]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            # bit for bit (NaN included)
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-200, 200, n),
                        [-180.0, 180.0, 0.0, np.nan, 179.9999999,
                         -180.0000001, 1e300, -1e300, np.inf, -np.inf]])
    y = np.concatenate([rng.uniform(-100, 100, n),
                        [-90.0, 90.0, 0.0, 1.0, np.nan, 89.999999, -90.5,
                         0.0, -np.inf, np.inf]])
    return x, y


@pytest.mark.parametrize("period", PERIODS)
def test_z3_encode_matches_plain_and_reference(period):
    x, y = _coords(50_000, 2)
    sfc = z3sfc(period)
    tmax = float(sfc.time.max)
    t = np.concatenate([np.random.default_rng(3).uniform(-1e3, tmax * 1.1,
                                                         50_000),
                        [0.0, tmax, tmax / 2, 1.0, 2.0, np.nan, -5.0,
                         tmax + 100, np.inf, -np.inf]])
    got = sfc.index(x, y, t, lenient=True)
    assert got.dtype == np.uint64
    assert np.array_equal(got, sfc.index_plain(x, y, t, lenient=True))
    assert np.array_equal(got, jax_z3sfc(period).index(x, y, t,
                                                       lenient=True))


def test_z2_encode_matches_plain_and_reference():
    x, y = _coords(50_000, 4)
    got = z2sfc().index(x, y, lenient=True)
    assert got.dtype == np.uint64
    assert np.array_equal(got, z2sfc().index_plain(x, y, lenient=True))
    assert np.array_equal(got, jax_z2sfc().index(x, y, lenient=True))


def test_encoders_broadcast_and_strict_paths():
    """Scalars and broadcasts take the numpy path (the C loop would read
    out of bounds), mismatched lengths raise, the strict path raises on
    out-of-range values, empty columns give empty keys."""
    x = np.array([10.0, 20.0, 30.0])
    assert np.array_equal(z2sfc().index(x, 5.0, lenient=True),
                          jax_z2sfc().index(x, 5.0, lenient=True))
    sfc = z3sfc("week")
    assert np.array_equal(sfc.index(x, 5.0, 100.0, lenient=True),
                          sfc.index_plain(x, np.full(3, 5.0),
                                          np.full(3, 100.0), lenient=True))
    with pytest.raises(ValueError):
        z2sfc().index(np.array([1.0, 2.0]), np.array([1.0, 2.0, 3.0]),
                      lenient=True)
    with pytest.raises(ValueError):
        z2sfc().index(np.array([200.0]), np.array([0.0]))
    assert z2sfc().index(np.empty(0), np.empty(0), lenient=True).shape == (0,)
    assert sfc.index(np.empty(0), np.empty(0), np.empty(0),
                     lenient=True).shape == (0,)


@pytest.mark.parametrize("period", ["day", "week"])
@pytest.mark.parametrize("n", [4096, 100_000])
def test_binned_matches_plain_and_reference(period, n):
    rng = np.random.default_rng(7)
    hi = timebin.max_date_millis(period)
    ms = rng.integers(-10**9, hi + 10**9, n).astype(np.int64)
    ms[:7] = [0, 1, hi - 1, hi, hi + 5, -1, -hi]
    got = timebin.to_binned(ms, period, lenient=True)
    _equal(got, timebin.to_binned_plain(ms, period, lenient=True))
    _equal(got, jax_timebin.to_binned(ms, period, lenient=True))
    # below the native size, and the strict path, stay numpy's
    small = ms[:100]
    _equal(timebin.to_binned(small, period, lenient=True),
           jax_timebin.to_binned(small, period, lenient=True))
    with pytest.raises(ValueError):
        timebin.to_binned(ms, period)


@pytest.mark.parametrize("seed", range(6))
def test_zranges_match_plain_and_reference(seed):
    rng = np.random.default_rng(seed)
    for dims, bits in ((2, 31), (3, 21)):
        m = (1 << bits) - 1
        for _ in range(12):
            lo = rng.integers(0, m, dims)
            hi = np.minimum(lo + rng.integers(0, m // 3, dims), m)
            for mr, prec in ((16, 64), (200, 64), (2000, 48), (1, 64)):
                got = zr.zranges(lo, hi, bits, precision=prec, max_ranges=mr)
                plain = zr.zranges_plain(lo, hi, bits, precision=prec,
                                         max_ranges=mr)
                assert got.dtype == np.int64
                assert np.array_equal(got, plain)
                assert np.array_equal(got, jax_zr.zranges(
                    lo, hi, bits, precision=prec, max_ranges=mr))


def test_zranges_edges():
    m2 = (1 << 31) - 1
    for lo, hi in (([0, 0], [m2, m2]), ([5, 5], [5, 5]), ([0, 0], [0, m2]),
                   ([m2, m2], [m2, m2]), ([10, 10], [5, 20])):
        got = zr.zranges(lo, hi, 31, max_ranges=100)
        assert np.array_equal(got, zr.zranges_plain(lo, hi, 31,
                                                    max_ranges=100))
    assert zr.zranges([10, 10], [5, 20], 31).shape == (0, 2)
    with pytest.raises(ValueError, match="dims"):
        zr.zranges([1], [2], 31)
    # the curves' ranges run it: the same covers as the JAX package's
    boxes = [(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0)]
    assert np.array_equal(z2sfc().ranges(boxes), jax_z2sfc().ranges(boxes))
    assert np.array_equal(z3sfc("week").ranges(boxes, [(0, 100_000)]),
                          jax_z3sfc("week").ranges(boxes, [(0, 100_000)]))


@pytest.mark.parametrize("period", PERIODS)
def test_fused_encode_matches_plain_and_reference(period):
    rng = np.random.default_rng(11)
    n = 50_000
    x = rng.uniform(-200, 200, n)
    y = rng.uniform(-100, 100, n)
    lo = int(np.datetime64("1965-01-01", "ms").astype(np.int64))
    ms = rng.integers(lo, timebin.max_date_millis(period) + 10**9, n)
    ms[:4] = [-5, 0, 2**55, timebin.max_date_millis(period) - 1]
    x[:5] = np.nan
    got = zkeys.encode_binned_z3(x, y, ms, period)
    _equal(got, zkeys.encode_binned_z3_plain(x, y, ms, period))
    eb, eo = jax_timebin.to_binned(ms, period, lenient=True)
    ez = jax_z3sfc(period).index(x, y, eo.astype(np.float64),
                                 lenient=True).astype(np.int64)
    _equal(got, (eb, ez))
    _equal(zkeys.encode_binned_z3([], [], [], period),
           (np.empty(0, np.int32), np.empty(0, np.int64)))
    with pytest.raises(ValueError):
        zkeys.encode_binned_z3(x, y[:-1], ms, period)


def _check_threads(n: int):
    """The native sorts and gather run on one thread under 2^18 rows and
    on several past 2^21 where the host has cores."""
    threads = native.library().geomesa_host_threads(n)
    assert threads >= 1
    if n < 2**18:
        assert threads == 1
    elif n > 2**21 and (os.cpu_count() or 1) > 1:
        assert threads > 1


PARALLEL_ROWS = 2_500_000


@pytest.mark.parametrize("case", ["large_segments", "ties", "sparse",
                                  "one", "many_bins", "parallel",
                                  "parallel_ties"])
def test_sort_bin_z_matches_plain(case):
    rng = np.random.default_rng(5)
    if case == "large_segments":   # ~66k a segment: the radix passes
        bins = rng.integers(0, 3, 200_000).astype(np.int32)
        z = rng.integers(0, 2**62, 200_000).astype(np.int64)
    elif case == "ties":           # long runs of equal keys
        bins = rng.integers(0, 7, 300_000).astype(np.int32)
        z = rng.integers(0, 64, 300_000).astype(np.int64) << 30
    elif case == "parallel":       # the threaded scatter and segments
        bins = rng.integers(0, 5, PARALLEL_ROWS).astype(np.int32)
        z = rng.integers(0, 2**62, PARALLEL_ROWS).astype(np.int64)
    elif case == "parallel_ties":  # tie runs across the threads' chunks
        bins = rng.integers(0, 3, PARALLEL_ROWS).astype(np.int32)
        z = rng.integers(0, 16, PARALLEL_ROWS).astype(np.int64) << 40
    elif case == "sparse":         # empty bins between the present ones
        bins = np.array([5, 5, 900, 0, 900], dtype=np.int32)
        z = np.array([3, 1, 2, 9, 2], dtype=np.int64)
    elif case == "one":
        bins, z = np.array([4], np.int32), np.array([0], np.int64)
    else:
        bins = rng.integers(0, 32768, 100_000).astype(np.int32)
        z = rng.integers(0, 1000, 100_000).astype(np.int64)
    _check_threads(len(z))
    got = zkeys.sort_bin_z(bins, z)
    _equal(got, zkeys.sort_bin_z_plain(bins, z))
    assert np.array_equal(got[1], np.lexsort((z, bins)))


@pytest.mark.parametrize("n", [1, 1000, 32_769, 150_000, PARALLEL_ROWS])
def test_sort_z_matches_plain(n):
    rng = np.random.default_rng(9)
    z = rng.integers(0, 2**62, n).astype(np.int64)
    z[: n // 2] = z[n // 2: n // 2 * 2]   # duplicate half: tie runs
    _check_threads(n)
    got = zkeys.sort_z(z)
    _equal(got, zkeys.sort_z_plain(z))
    assert np.array_equal(got[1], np.argsort(z, kind="stable"))


def test_sorts_refuse_what_they_cannot_sort():
    _equal(zkeys.sort_bin_z(np.empty(0, np.int32), np.empty(0, np.int64)),
           zkeys.sort_bin_z_plain(np.empty(0, np.int32),
                                  np.empty(0, np.int64)))
    _equal(zkeys.sort_z(np.empty(0, np.int64)),
           zkeys.sort_z_plain(np.empty(0, np.int64)))
    with pytest.raises(ValueError, match="non-negative"):
        zkeys.sort_z(np.array([3, -1], np.int64))
    with pytest.raises(ValueError, match="non-negative"):
        zkeys.sort_bin_z(np.array([0, 0], np.int32), np.array([3, -1]))
    with pytest.raises(ValueError):
        zkeys.sort_bin_z(np.array([0, -2], np.int32), np.array([3, 1]))
    with pytest.raises(ValueError):
        zkeys.sort_bin_z(np.array([0], np.int32), np.array([3, 1]))


@pytest.mark.parametrize("n", [100_000, PARALLEL_ROWS])
@pytest.mark.parametrize("with_ms", [False, True])
def test_gather_xyz_matches_plain(with_ms, n):
    rng = np.random.default_rng(13)
    _check_threads(n)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    x[:3] = np.nan
    ms = rng.integers(-10**12, 10**12, n) if with_ms else None
    perm = rng.permutation(n).astype(np.int32)
    _equal(zkeys.gather_xyz(x, y, ms, perm),
           zkeys.gather_xyz_plain(x, y, ms, perm))
    # a subset, and none
    _equal(zkeys.gather_xyz(x, y, ms, perm[:77]),
           zkeys.gather_xyz_plain(x, y, ms, perm[:77]))
    _equal(zkeys.gather_xyz(x, y, ms, perm[:0]),
           zkeys.gather_xyz_plain(x, y, ms, perm[:0]))
    with pytest.raises(ValueError, match="outside"):
        zkeys.gather_xyz(x, y, ms, np.array([n], np.int32))
    with pytest.raises(ValueError):
        zkeys.gather_xyz(x, y, ms, perm.astype(np.int64))


@pytest.mark.parametrize("period", ["week", "month"])
def test_index_build_matches_reference(period):
    """The index's native build (fused encode, then the bin sort) gives
    the JAX index's sort order."""
    rng = np.random.default_rng(17)
    n = 60_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = rng.integers(0, 40 * 86_400_000, n) + 1_500_000_000_000
    port = zkeys.ZKeyIndex(x, y, ms, period)
    ref = JaxZKeyIndex(x, y, ms, period)
    port._build_z3()
    port._build_z2()
    ref._build_z3()
    ref._build_z2()
    for got, want in zip(port._z3 + port._z2, ref._z3 + ref._z2):
        assert np.array_equal(got, want)


def test_failed_compile_raises_and_runs_no_numpy_path(monkeypatch,
                                                      tmp_path):
    """With the compiler missing, every native entry raises the build
    error; no plain twin runs in its place."""
    monkeypatch.setattr(native, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cache", {})

    def refuse(*a, **k):
        raise AssertionError("a numpy path ran in place of the library")
    monkeypatch.setattr(zr, "zranges_plain", refuse)
    monkeypatch.setattr(timebin, "to_binned_plain", refuse)
    for name in ("encode_binned_z3_plain", "sort_bin_z_plain",
                 "sort_z_plain", "gather_xyz_plain"):
        monkeypatch.setattr(zkeys, name, refuse)
    monkeypatch.setattr(type(z2sfc()), "index_plain", refuse)
    monkeypatch.setattr(type(z3sfc("week")), "index_plain", refuse)
    x = np.zeros(5000)
    calls = [
        lambda: z2sfc().index(x, x, lenient=True),
        lambda: z3sfc("week").index(x, x, x, lenient=True),
        lambda: timebin.to_binned(x.astype(np.int64), "week",
                                  lenient=True),
        lambda: zr.zranges([0, 0], [5, 5], 31),
        lambda: zkeys.encode_binned_z3(x, x, x.astype(np.int64), "week"),
        lambda: zkeys.sort_bin_z(np.zeros(3, np.int32),
                                 np.zeros(3, np.int64)),
        lambda: zkeys.sort_z(np.zeros(3, np.int64)),
        lambda: zkeys.gather_xyz(x, x, None, np.zeros(3, np.int32)),
        lambda: zkeys.ZKeyIndex(x, x, x.astype(np.int64))._build_z3(),
    ]
    for call in calls:
        with pytest.raises(native.NativeBuildError, match="no-such-g"):
            call()
    assert not any(p.suffix == ".so" for p in tmp_path.rglob("*"))
