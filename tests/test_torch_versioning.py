"""Index versions of the port against the JAX package on the CPU: the
legacy z3 curve (index version 1), the z-key index's layout version, and
the store's reindex. The same seeded inputs go through both packages.

Tolerance: exact. Curve keys and ranges are equal int64 arrays, sort
orders equal arrays, query ids equal lists."""

import numpy as np
import pytest

from geomesa_tpu.curves.legacy import legacy_z3sfc as jax_legacy
from geomesa_tpu.features.sft import KNOWN_INDEX_VERSIONS as JAX_KNOWN
from geomesa_tpu.features.sft import check_index_version as jax_check
from geomesa_tpu.index.zkeys import ZKeyIndex as JaxZKeyIndex
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.curves import legacy_z3sfc
from geomesa_tpu_torch.features.sft import (CURRENT_INDEX_VERSION,
                                            KNOWN_INDEX_VERSIONS,
                                            check_index_version)
from geomesa_tpu_torch.index.zkeys import ZKeyIndex

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
SPEC_V1 = ("kind:String,dtg:Date,*geom:Point:srid=4326;"
           "geomesa.index.version='1'")
QUERIES = [
    "BBOX(geom, -10, -10, 10, 10) AND "
    "dtg DURING 2017-01-02T00:00:00Z/2017-01-05T00:00:00Z",
    "BBOX(geom, -120, 20, -70, 50) AND "
    "dtg DURING 2017-01-01T12:00:00Z/2017-01-15T00:00:00Z",
    "BBOX(geom, 100, -50, 140, -10)",
    "dtg DURING 2017-01-03T00:00:00Z/2017-01-04T00:00:00Z",
    "kind = 'b' AND BBOX(geom, -40, -40, 40, 40) AND "
    "dtg AFTER 2017-01-10T00:00:00Z",
]


def _sample(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(MS("2017-01-01"), MS("2017-01-20"), n)
    # edges of the domain, the legacy curve's ceil steps and null-like
    # coordinates
    x[:6] = [-180.0, 180.0, 0.0, -179.99999, 179.99999, 360.0 / (2**21 - 1)]
    y[:6] = [-90.0, 90.0, 0.0, 89.99999, -89.99999, 180.0 / (2**21 - 1)]
    return x, y, ms


@pytest.mark.parametrize("period", ["day", "week", "month", "year"])
def test_legacy_curve_matches_reference(period):
    rng = np.random.default_rng(1)
    port, ref = legacy_z3sfc(period), jax_legacy(period)
    n = 20_000
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    t = rng.uniform(0, port.time.hi, n)
    x[:4], y[:4], t[:4] = [-180, 180, 0, 1e-9], [-90, 90, 0, -1e-9], \
        [0, port.time.hi, 1, port.time.hi / 2]
    assert np.array_equal(port.index(x, y, t), ref.index(x, y, t))
    # lenient: far-out values alias through the 21-bit mask
    xo = np.concatenate([x, [-500.0, 500.0, -181.0, 1e6]])
    yo = np.concatenate([y, [-300.0, 300.0, 91.0, -1e6]])
    to = np.concatenate([t, [-10.0, 1e12, port.time.hi + 1, 0.0]])
    zp = port.index(xo, yo, to, lenient=True)
    assert np.array_equal(zp, ref.index(xo, yo, to, lenient=True))
    for got, want in zip(port.invert(zp), ref.invert(zp)):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        port.index(np.array([181.0]), np.array([0.0]), np.array([0.0]))
    with pytest.raises(ValueError):
        ref.index(np.array([181.0]), np.array([0.0]), np.array([0.0]))
    for boxes, times in (([(-10.0, -10.0, 10.0, 10.0)], [(0, 1000)]),
                         ([(-180.0, -90.0, 180.0, 90.0)],
                          [(0, int(port.time.hi))]),
                         ([(0.0, 0.0, 1e-5, 1e-5), (20.0, 5.0, 60.0, 70.0)],
                          [(100, 200), (0, 50_000)]),
                         ([], [(0, 10)])):
        for mr in (None, 16):
            got = port.ranges(boxes, times, max_ranges=mr)
            want = ref.ranges(boxes, times, max_ranges=mr)
            assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("period", ["week", "day"])
def test_index_sort_orders_and_rows_match_reference(version, period):
    """Both layout versions: the z3 and z2 sort orders, and the rows of
    both index tiers (exact on the host, candidates for the device)."""
    x, y, ms = _sample()
    port = ZKeyIndex(x, y, ms, period, version=version)
    ref = JaxZKeyIndex(x, y, ms, period, version=version)
    port._build_z3()
    port._build_z2()
    ref._build_z3()
    ref._build_z2()
    for got, want in zip(port._z3 + port._z2, ref._z3 + ref._z2):
        assert np.array_equal(got, want)
    boxes = [(-10.0, -10.0, 10.0, 10.0), (100.0, -50.0, 140.0, -10.0)]
    iv = [(MS("2017-01-02") + 1, MS("2017-01-05") - 1)]
    for name, ivs in (("z3", iv), ("z2", [])):
        for _ in range(3):   # the third query reads the sorted copies
            for caps in ((len(x), len(x)), (0, len(x)), (0, 10)):
                got = port.query_rows(name, boxes, ivs, *caps)
                want = ref.query_rows(name, boxes, ivs, *caps)
                assert got[0] == want[0]
                assert (got[1] is None and want[1] is None) or \
                    np.array_equal(got[1], want[1])
    assert port._z3_coords is not None and port._z2_coords is not None


def test_versions_sort_differently_and_extend_keeps_the_curve():
    x, y, ms = _sample(8_000)
    z1 = ZKeyIndex(x[:5000], y[:5000], ms[:5000], "week", version=1)
    z2 = ZKeyIndex(x[:5000], y[:5000], ms[:5000], "week", version=2)
    z1._build_z3()
    z1._build_z2()
    z2._build_z3()
    z2._build_z2()
    assert not np.array_equal(z1._z3[2], z2._z3[2])
    ext = z1.extend(x[5000:], y[5000:], ms[5000:])
    assert ext.version == 1
    whole = ZKeyIndex(x, y, ms, "week", version=1)
    whole._build_z3()
    whole._build_z2()
    for got, want in zip(ext._z3, whole._z3):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("to_version", [1, 2])
def test_with_version_rebuilds_z3_and_keeps_z2(to_version):
    """An index moved to a layout version has the z3 order of a new
    index at that version, and keeps the z2 order and its coordinate
    copies (the same arrays, not rebuilt)."""
    x, y, ms = _sample(6_000)
    old = ZKeyIndex(x, y, ms, "week", version=3 - to_version)
    old._build_z3()
    old._build_z2()
    for _ in range(ZKeyIndex._COORDS_AFTER + 1):   # the z2 copies
        old._coords(False, old._z2[1])
    new = old.with_version(to_version)
    fresh = ZKeyIndex(x, y, ms, "week", version=to_version)
    fresh._build_z3()
    assert new.version == to_version and new.n == old.n
    for got, want in zip(new._z3, fresh._z3):
        assert np.array_equal(got, want)
    assert new._z2 is old._z2 and new._z2_coords is old._z2_coords
    assert new._z2_coords is not None and new._z3_coords is None
    # a time-less index has no z3 order to build
    flat = ZKeyIndex(x, y, None, "week").with_version(1)
    assert flat.version == 1 and flat._z3 is None


def test_check_index_version_matches_reference():
    assert KNOWN_INDEX_VERSIONS == JAX_KNOWN
    for v in (None, 1, 2, "1", 2.0):
        assert check_index_version(v) == jax_check(v)
    assert check_index_version(None) == CURRENT_INDEX_VERSION
    for bad in (0, 3, "9"):
        with pytest.raises(ValueError):
            jax_check(bad)
        with pytest.raises(ValueError, match="unknown index version"):
            check_index_version(bad)
    s = InMemoryDataStore(device="cpu")
    s.create_schema("e", SPEC_V1)
    with pytest.raises(ValueError):
        s.reindex("e", 7)
    with pytest.raises(KeyError):
        s.reindex("missing")


def _stores(n=20_000, chunks=(0, 12_000, 20_000)):
    x, y, ms = _sample(n)
    kinds = np.array(["a", "b", "c"], dtype=object)[
        np.random.default_rng(5).integers(0, 3, n)]
    out = []
    for s in (InMemoryDataStore(device="cpu"), JaxStore()):
        s.create_schema("events", SPEC_V1)
        for lo, hi in zip(chunks[:-1], chunks[1:]):
            s.write_dict("events", [f"e{i}" for i in range(lo, hi)],
                         {"kind": list(kinds[lo:hi]), "dtg": ms[lo:hi],
                          "geom": (x[lo:hi], y[lo:hi])})
            s.query(QUERIES[0], "events")   # build, then extend
        out.append(s)
    return out


def _same(port, ref):
    for ecql in QUERIES:
        got, want = port.query(ecql, "events"), ref.query(ecql, "events")
        assert got.plan.index == want.plan.index
        assert list(got.ids) == list(want.ids)
        assert port.query_count(ecql, "events") == len(want.ids)


def test_memory_store_reindex_matches_reference():
    """The cases of tests/test_index_versioning.py's store migration: a
    version-1 store answers, reindexes to the current version and
    answers again, id for id with the JAX store; and back to 1."""
    port, ref = _stores()
    assert port.get_schema("events").index_version == 1
    assert port._state("events").zindex.version == 1
    _same(port, ref)
    pz, rz = port._state("events").zindex, ref._state("events").zindex
    for got, want in zip(pz._z3, rz._z3):
        assert np.array_equal(got, want)

    old = port._state("events").zindex
    port.reindex("events")
    ref.reindex("events")
    assert port.get_schema("events").index_version == CURRENT_INDEX_VERSION
    new = port._state("events").zindex
    assert new is not old and new.version == CURRENT_INDEX_VERSION
    # the z3 order was rebuilt under the new curve and swapped in whole;
    # the z2 order does not depend on the version and is kept
    assert new._z3 is not None and new._z2 is old._z2
    _same(port, ref)

    port.reindex("events", 1)
    ref.reindex("events", 1)
    assert port._state("events").zindex.version == 1
    _same(port, ref)
    port.reindex("events", 1)   # the same version: nothing to do
    assert port._state("events").zindex.version == 1


def test_reindex_before_the_index_is_built():
    """A type whose index is not built yet takes the new version at its
    first read; an empty type only records the version."""
    s = InMemoryDataStore(device="cpu")
    s.create_schema("events", SPEC_V1)
    s.reindex("events")
    assert s.get_schema("events").index_version == CURRENT_INDEX_VERSION
    x, y, ms = _sample(3_000)
    s.write_dict("events", [f"e{i}" for i in range(3_000)],
                 {"kind": ["a"] * 3_000, "dtg": ms, "geom": (x, y)})
    s.reindex("events", 1)
    res = s.query(QUERIES[0], "events")
    assert s._state("events").zindex.version == 1
    hit = ((x >= -10) & (x <= 10) & (y >= -10) & (y <= 10)
           & (ms > MS("2017-01-02")) & (ms < MS("2017-01-05")))
    assert list(res.rows) == list(np.flatnonzero(hit))
