"""The file store's partition schemes against the JAX package's: per-row
partition names (directory names both packages read, so byte-equal) and
the covering partitions of a filter battery, for every scheme and for
composites. Tolerance: exact."""

import numpy as np
import pytest

from geomesa_tpu.features import FeatureBatch as JBatch
from geomesa_tpu.features.sft import parse_spec as jparse
from geomesa_tpu.filters import parse_ecql as jecql
from geomesa_tpu.store import partitions as jpart
from geomesa_tpu_torch.features import FeatureBatch
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.store import partitions as tpart

SPEC = "kind:String,n:Integer,dtg:Date,*geom:Point"
EXT_SPEC = "kind:String,dtg:Date,*geom:Polygon"
MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))
MS_HOUR = 3_600_000

SCHEMES = {
    "daily": ("DateTimeScheme", ("daily",)),
    "hourly": ("DateTimeScheme", ("hourly",)),
    "monthly": ("DateTimeScheme", ("monthly",)),
    "julian": ("DateTimeScheme", ("julian-daily",)),
    "z2-1": ("Z2Scheme", (1,)),
    "z2-2": ("Z2Scheme", (2,)),
    "z2-4": ("Z2Scheme", (4,)),
    "z2-7": ("Z2Scheme", (7,)),
    "attr": ("AttributeScheme", ("kind",)),
}
COMPOSITES = {
    "monthly+z2": ("monthly", "z2-1"),
    "daily+attr": ("daily", "attr"),
    "attr+z2+hourly": ("attr", "z2-2", "hourly"),
}

FILTERS = [
    "INCLUDE",
    "BBOX(geom, -10, -10, 10, 10)",
    "BBOX(geom, 100, 40, 110, 50)",
    "BBOX(geom, -180, -90, 180, 90)",
    "BBOX(geom, 170, -5, -170, 5)",
    "dtg DURING 2017-01-05T00:00:00Z/2017-01-07T00:00:00Z",
    "dtg DURING 2017-01-05T10:30:00Z/2017-01-05T13:00:00Z",
    "dtg DURING 2016-12-30T00:00:00Z/2017-02-02T00:00:00Z",
    "dtg BETWEEN '2017-01-03T00:00:00Z' AND '2017-01-04T12:00:00Z'",
    "dtg AFTER 2017-01-10T00:00:00Z",
    "dtg BEFORE 2017-01-02T00:00:00Z",
    "BBOX(geom, -50, -30, 50, 30) AND "
    "dtg DURING 2017-01-05T00:00:00Z/2017-01-10T00:00:00Z",
    "BBOX(geom, -5, -5, 5, 5) OR BBOX(geom, 60, 60, 70, 70)",
    "(dtg DURING 2017-01-02T00:00:00Z/2017-01-03T00:00:00Z) OR "
    "(dtg DURING 2017-01-15T00:00:00Z/2017-01-16T00:00:00Z)",
    "NOT (BBOX(geom, -10, -10, 10, 10))",
    "NOT (dtg DURING 2017-01-05T00:00:00Z/2017-01-07T00:00:00Z)",
    "kind = 'k1'",
    "kind IN ('k0', 'k3')",
    "kind = 'k1' AND BBOX(geom, 0, 0, 40, 40)",
    "kind = 'k1' OR kind = 'k2'",
    "kind = 'k1' AND kind = 'k2'",
    "kind > 'k1'",
    "n = 3",
    "BBOX(geom, 0, 0, 1, 1) AND BBOX(geom, 5, 5, 6, 6)",
    "dtg DURING 2017-01-05T00:00:00Z/2017-01-06T00:00:00Z AND "
    "dtg DURING 2017-01-08T00:00:00Z/2017-01-09T00:00:00Z",
    "INTERSECTS(geom, POLYGON((0 0, 30 0, 30 30, 0 30, 0 0)))",
    "DWITHIN(geom, POINT(10 10), 500, kilometers)",
    "kind = 'k1' AND dtg DURING "
    "2017-01-05T00:00:00Z/2017-01-06T00:00:00Z",
]


def _scheme(mod, key):
    if key in COMPOSITES:
        return mod.CompositeScheme([_scheme(mod, k)
                                    for k in COMPOSITES[key]])
    cls, args = SCHEMES[key]
    return getattr(mod, cls)(*args)


def _rows(seed: int, n: int, wide_times: bool):
    rng = np.random.default_rng(seed)
    if wide_times:
        # before and after the epoch: the names' day, month and year
        # boundaries under floor division
        dtg = rng.integers(MS("1965-06-01"), MS("2031-03-01"), n)
        dtg[:8] = [0, -1, MS_HOUR - 1, -MS_HOUR, MS("2016-02-29"),
                   MS("2016-12-31T23:59:59.999"), MS("2000-03-01"),
                   MS("1969-12-31T23:00:00")]
    else:
        dtg = rng.integers(MS("2017-01-01"), MS("2017-01-20"), n)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    if n >= 4:
        x[:4] = [-180.0, 180.0, 0.0, 179.999]
        y[:4] = [-90.0, 90.0, 0.0, -0.0]
    return ([f"r{i}" for i in range(n)],
            {"kind": [f"k{i % 4}" if i % 11 else f"a/b{i % 3}"
                      for i in range(n)],
             "n": rng.integers(0, 6, n), "dtg": dtg, "geom": (x, y)})


def _batches(seed, n, wide_times, spec=SPEC):
    ids, data = _rows(seed, n, wide_times)
    return (JBatch.from_dict(jparse("t", spec), ids, data),
            FeatureBatch.from_dict(parse_spec("t", spec), ids, data))


@pytest.mark.parametrize("key", list(SCHEMES) + list(COMPOSITES))
@pytest.mark.parametrize("wide_times", [False, True])
def test_partition_names_equal(key, wide_times):
    jb, tb = _batches(3, 4000, wide_times)
    want = _scheme(jpart, key).partition_for_rows(jb.sft, jb)
    got = _scheme(tpart, key).partition_for_rows(tb.sft, tb)
    assert got.dtype == want.dtype
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("key", ["daily", "z2-4", "attr", "monthly+z2"])
def test_partition_names_of_an_empty_batch(key):
    jb, tb = _batches(0, 0, False)
    want = _scheme(jpart, key).partition_for_rows(jb.sft, jb)
    got = _scheme(tpart, key).partition_for_rows(tb.sft, tb)
    assert got.tolist() == want.tolist() == []


@pytest.mark.parametrize("key", ["z2-2", "z2-4", "attr+z2+hourly"])
def test_partition_names_of_extent_rows(key):
    """A Z2 scheme names an extent row by its bounding box's centre."""
    from geomesa_tpu.geometry import parse_wkt as jwkt
    from geomesa_tpu_torch.geometry import parse_wkt
    rng = np.random.default_rng(5)
    n = 300
    cx, cy = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
    w = rng.uniform(0.01, 9, n)
    wkts = [f"POLYGON(({a - d} {b - d}, {a + d} {b - d}, {a + d} {b + d}, "
            f"{a - d} {b + d}, {a - d} {b - d}))"
            for a, b, d in zip(cx, cy, w)]
    ids = [f"p{i}" for i in range(n)]
    dtg = rng.integers(MS("2017-01-01"), MS("2017-01-20"), n)
    kind = [f"k{i % 3}" for i in range(n)]
    jb = JBatch.from_dict(jparse("t", EXT_SPEC), ids, {
        "kind": kind, "dtg": dtg, "geom": [jwkt(s) for s in wkts]})
    tb = FeatureBatch.from_dict(parse_spec("t", EXT_SPEC), ids, {
        "kind": kind, "dtg": dtg, "geom": [parse_wkt(s) for s in wkts]})
    want = _scheme(jpart, key).partition_for_rows(jb.sft, jb)
    got = _scheme(tpart, key).partition_for_rows(tb.sft, tb)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("key", list(SCHEMES) + list(COMPOSITES))
@pytest.mark.parametrize("ecql", FILTERS)
def test_covering_partitions_equal(key, ecql):
    want = _scheme(jpart, key).covering_partitions(jparse("t", SPEC),
                                                   jecql(ecql))
    got = _scheme(tpart, key).covering_partitions(parse_spec("t", SPEC),
                                                  parse_ecql(ecql))
    assert got == want


@pytest.mark.parametrize("key", list(SCHEMES) + list(COMPOSITES))
def test_config_round_trips_across_packages(key):
    cfg = _scheme(tpart, key).to_config()
    assert cfg == _scheme(jpart, key).to_config()
    back = tpart.scheme_from_config(jpart.scheme_from_config(cfg)
                                    .to_config())
    assert back.to_config() == cfg and back.name == _scheme(jpart, key).name


def test_unknown_scheme_and_format_raise():
    with pytest.raises(ValueError):
        tpart.scheme_from_config({"scheme": "nope"})
    with pytest.raises(ValueError):
        tpart.DateTimeScheme("weekly")


@pytest.mark.parametrize("key", list(SCHEMES) + list(COMPOSITES))
@pytest.mark.parametrize("wide_times", [False, True])
def test_partition_groups_are_the_unique_names(key, wide_times):
    """The writer's groups: the distinct names sorted and each row's
    index into them, as ``np.unique`` gives them on the JAX package's
    per-row names."""
    jb, tb = _batches(5, 4000, wide_times)
    want = _scheme(jpart, key).partition_for_rows(jb.sft, jb)
    names, inverse = _scheme(tpart, key).partition_groups(tb.sft, tb)
    want_names, want_inverse = np.unique(want, return_inverse=True)
    assert names.tolist() == want_names.tolist()
    assert inverse.tolist() == want_inverse.ravel().tolist()
