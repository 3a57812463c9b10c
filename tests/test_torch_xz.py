"""The port's XZ2/XZ3 curves and XZ-key index against the JAX package:
tests/test_xz.py's and tests/test_xzkeys.py's cases run through both.
Index values, ranges and candidate rows must be equal (exact: they are
integer arrays)."""

import numpy as np
import pytest

from geomesa_tpu.curves.xz import xz2sfc as jxz2sfc
from geomesa_tpu.curves.xz import xz3sfc as jxz3sfc
from geomesa_tpu.features import parse_spec as jparse_spec
from geomesa_tpu.index.xzkeys import XZKeyIndex as JXZKeyIndex
from geomesa_tpu.index.zkeys import prune_candidates as jprune_candidates
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore, Query, parse_spec
from geomesa_tpu_torch.curves.timebin import TimePeriod, max_offset
from geomesa_tpu_torch.curves.xz import xz2sfc, xz3sfc
from geomesa_tpu_torch.index.xzkeys import XZKeyIndex
from geomesa_tpu_torch.index.zkeys import prune_candidates

MS_DAY = 86_400_000


def covers(ranges: np.ndarray, code: int) -> bool:
    return bool(np.any((ranges[:, 0] <= code) & (ranges[:, 1] >= code)))


def _outcome(fn):
    try:
        out = fn()
        return "ok", (out.tolist() if isinstance(out, np.ndarray) else out)
    except Exception as e:  # noqa: BLE001
        return "err", type(e).__name__


# tests/test_xz.py's boxes
CONTAINING = [(9.0, 9.0, 13.0, 13.0), (-180.0, -90.0, 180.0, 90.0),
              (0.0, 0.0, 180.0, 90.0), (0.0, 0.0, 20.0, 20.0)]
OVERLAPPING = [(11.0, 11.0, 13.0, 13.0), (9.0, 9.0, 11.0, 11.0),
               (10.5, 10.5, 11.5, 11.5), (11.0, 11.0, 11.0, 11.0)]
DISJOINT = [(-180.0, -90.0, 8.0, 8.0), (0.0, 0.0, 8.0, 8.0),
            (9.0, 9.0, 9.5, 9.5), (20.0, 20.0, 180.0, 90.0),
            (12.5, 12.5, 13.5, 13.5)]


@pytest.mark.parametrize("g", [8, 12, 16])
@pytest.mark.parametrize("bbox", CONTAINING + OVERLAPPING + DISJOINT
                         + [(-20.0, -20.0, 15.0, 25.0)])
def test_xz2_ranges_match_reference(g, bbox):
    """XZ2 ranges (start, end, contained) equal the reference's, at the
    default and at a capped range count; the polygon and point codes of
    XZ2SFCTest are covered exactly when the reference covers them."""
    sfc, jsfc = xz2sfc(g), jxz2sfc(g)
    for mr in (None, 30, 4000):
        r, jr = sfc.ranges([bbox], max_ranges=mr), jsfc.ranges(
            [bbox], max_ranges=mr)
        assert np.array_equal(r, jr), (bbox, mr)
    for box in ((10, 10, 12, 12), (11, 11, 11, 11)):
        code = int(sfc.index_boxes(*box)[0])
        assert code == int(jsfc.index_boxes(*box)[0])
        assert covers(sfc.ranges([bbox]), code) == covers(
            jsfc.ranges([bbox]), code)


def test_xz2_index_matches_reference():
    """Vectorized and scalar codes, lenient clamping and the errors of
    out-of-domain and unordered bounds, as the reference."""
    sfc, jsfc = xz2sfc(12), jxz2sfc(12)
    rng = np.random.default_rng(7)
    xmin = rng.uniform(-179, 178, 2000)
    ymin = rng.uniform(-89, 88, 2000)
    xmax = np.minimum(xmin + 10 ** rng.uniform(-6, 1.5, 2000), 180.0)
    ymax = np.minimum(ymin + 10 ** rng.uniform(-6, 1.5, 2000), 90.0)
    assert np.array_equal(sfc.index_boxes(xmin, ymin, xmax, ymax),
                          jsfc.index_boxes(xmin, ymin, xmax, ymax))
    for i in range(0, 2000, 397):
        assert int(sfc.index_boxes(xmin[i], ymin[i], xmax[i], ymax[i])[0]) \
            == int(jsfc.index_boxes(xmin[i], ymin[i], xmax[i], ymax[i])[0])
    for args, kw in (((-181, 0, 0, 0), {}), ((10, 10, 5, 12), {}),
                     ((-181, -91, 181, 91), {"lenient": True}),
                     ((-170, -80, 170, 80), {})):
        assert _outcome(lambda: sfc.index_boxes(*args, **kw)) == \
            _outcome(lambda: jsfc.index_boxes(*args, **kw))
    # multi-box ranges merge the same way
    boxes = [(-20.0, -20.0, 15.0, 25.0), (100.0, 10.0, 120.0, 11.0),
             (-179.5, -89.5, -179.0, -89.0)]
    assert np.array_equal(sfc.ranges(boxes), jsfc.ranges(boxes))


@pytest.mark.parametrize("period", ["day", "week", "month", "year"])
def test_xz3_matches_reference(period):
    """XZ3 codes and ranges of tests/test_xz.py's spatio-temporal boxes
    and of seeded ones equal the reference's, per time period."""
    sfc, jsfc = xz3sfc(12, period), jxz3sfc(12, period)
    span = float(max_offset(TimePeriod.parse(period)))
    f = span / 604_800   # test_xz.py's week offsets, scaled to the period
    boxes = [(10, 10, 1000 * f, 12, 12, 2000 * f),
             (11, 11, 1500 * f, 11, 11, 1500 * f)]
    queries = [(9, 9, 500 * f, 13, 13, 3000 * f),
               (-180, -90, 0, 180, 90, span),
               (9, 9, 100_000 * f, 13, 13, 200_000 * f),
               (50, 50, 500 * f, 60, 60, 3000 * f),
               (10, 10, 1000 * f, 12, 12, 2000 * f)]
    for b in boxes:
        assert int(sfc.index_boxes(*b)[0]) == int(jsfc.index_boxes(*b)[0])
    for q in queries:
        assert np.array_equal(sfc.ranges([q]), jsfc.ranges([q])), q
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-179, 170, 500)
    y0 = rng.uniform(-89, 80, 500)
    t0 = rng.uniform(0, span * 0.9, 500)
    args = (x0, y0, t0, x0 + rng.uniform(0, 5, 500),
            y0 + rng.uniform(0, 5, 500), t0 + rng.uniform(0, span * 0.1, 500))
    assert np.array_equal(sfc.index_boxes(*args), jsfc.index_boxes(*args))


def _bounds(seed, n, nulls=True, escape=True):
    rng = np.random.default_rng(seed)
    xmin = rng.uniform(-175, 165, n)
    ymin = rng.uniform(-85, 75, n)
    b = np.stack([xmin, ymin, xmin + 10 ** rng.uniform(-4, 0.7, n),
                  ymin + 10 ** rng.uniform(-4, 0.7, n)], axis=1)
    if nulls:
        b[rng.random(n) < 0.03] = np.nan
    if escape:
        b[:5, 0] = -190.0   # out of the domain: always a candidate
    ms = rng.integers(-10 * MS_DAY, 200 * MS_DAY, n)
    return b, ms


BOXES = [[(20.0, 20.0, 40.0, 35.0)], [(-10.0, -10.0, 10.0, 10.0)],
         [(0.5, 0.2, 1.5, 1.2), (100.0, -50.0, 140.0, -10.0)],
         [(-180.0, -90.0, 180.0, 90.0)], [(170.0, 80.0, 180.0, 90.0)]]
INTERVALS = [[], [(0, 30 * MS_DAY)], [(-5 * MS_DAY, 2 * MS_DAY),
                                      (100 * MS_DAY, 101 * MS_DAY)],
             [(40 * MS_DAY, 39 * MS_DAY)]]


@pytest.mark.parametrize("period", ["day", "week", "month"])
@pytest.mark.parametrize("max_rows", [None, 50, 4000])
def test_xzkeyindex_candidates_match_reference(period, max_rows):
    """XZKeyIndex's candidates (xz2, xz3 and prune_candidates' policy)
    equal the reference's row for row, with null rows, out-of-domain
    rows and caps that abort; every box-intersecting row is a
    candidate."""
    b, ms = _bounds(11, 5000)
    idx, jidx = XZKeyIndex(b, ms, period), JXZKeyIndex(b, ms, period)
    for boxes in BOXES:
        got = _outcome(lambda: idx.candidates_xz2(boxes, max_rows=max_rows))
        assert got == _outcome(lambda: jidx.candidates_xz2(
            boxes, max_rows=max_rows))
        if got[0] == "ok" and got[1] is not None:
            for box in boxes:
                hit = ((b[:, 0] <= box[2]) & (b[:, 2] >= box[0])
                       & (b[:, 1] <= box[3]) & (b[:, 3] >= box[1]))
                assert set(np.flatnonzero(hit)) <= set(got[1])
        for iv in INTERVALS:
            assert _outcome(lambda: idx.candidates_xz3(
                boxes, iv, max_rows=max_rows)) == _outcome(
                lambda: jidx.candidates_xz3(boxes, iv, max_rows=max_rows))
            for name in ("xz2", "xz3"):
                assert _outcome(lambda: prune_candidates(
                    idx, name, boxes, iv, max_rows)) == _outcome(
                    lambda: jprune_candidates(jidx, name, boxes, iv,
                                              max_rows))


def test_xzkeyindex_without_time_and_abort():
    """A time-less index has no xz3 order; a cap below the rows aborts
    (tests/test_xzkeys.py's unit cases)."""
    b, _ = _bounds(5, 5000, nulls=False, escape=False)
    idx, jidx = XZKeyIndex(b, None), JXZKeyIndex(b, None)
    box = [(20.0, 20.0, 40.0, 35.0)]
    rows = idx.candidates_xz2(box)
    assert np.array_equal(rows, jidx.candidates_xz2(box)) and len(rows) < 5000
    assert idx.candidates_xz3(box, [(0, MS_DAY)]) is None
    assert jidx.candidates_xz3(box, [(0, MS_DAY)]) is None
    same = np.tile([0.0, 0.0, 1.0, 1.0], (100, 1))
    assert XZKeyIndex(same, None).candidates_xz2(
        [(-10, -10, 10, 10)], max_rows=5) is None


# -- tests/test_xzkeys.py's store cases, through both stores ------------------

SPEC = "name:String,dtg:Date,*track:LineString"
MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
N = 20_000

QUERIES = [
    "BBOX(track, 10, 10, 14, 14)",
    "BBOX(track, -170, -80, -160, -70)",
    ("BBOX(track, 0, 0, 8, 8) AND "
     "dtg DURING 2018-02-01T00:00:00Z/2018-02-15T00:00:00Z"),
    "INTERSECTS(track, POLYGON ((20 20, 30 20, 25 30, 20 20)))",
    ("INTERSECTS(track, POLYGON ((20 20, 30 20, 25 30, 20 20))) AND "
     "dtg DURING 2018-03-01T00:00:00Z/2018-04-01T00:00:00Z"),
    "BBOX(track, -180, -90, 180, 90)",
]


def make_lines(rng, n, span=2.0):
    cx = rng.uniform(-175, 175, n)
    cy = rng.uniform(-85, 85, n)
    dx = rng.uniform(0.05, span, n)
    dy = rng.uniform(0.05, span, n)
    return [f"LINESTRING ({cx[i]-dx[i]} {cy[i]-dy[i]}, "
            f"{cx[i]} {cy[i]}, {cx[i]+dx[i]} {cy[i]+dy[i]})"
            for i in range(n)]


@pytest.fixture(scope="module")
def track_stores():
    rng = np.random.default_rng(77)
    data = {"name": [f"n{i % 7}" for i in range(N)],
            "dtg": rng.integers(MS("2018-01-01"), MS("2018-06-01"), N),
            "track": make_lines(rng, N)}
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s in (port, ref):
        s.create_schema("trk", SPEC)
        s.write_dict("trk", [f"t{i}" for i in range(N)], data)
    return port, ref


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ecql", QUERIES)
def test_pruned_and_dense_match_reference(track_stores, ecql, dense,
                                          monkeypatch):
    """The XZ-pruned host scan and the dense tristate (forced through
    geomesa.scan.index.threshold = 0 in both packages) give the JAX
    store's ids, explain tier and plan."""
    from geomesa_tpu.index.api import Query as JQuery
    port, ref = track_stores
    if dense:
        monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", "0.0")
    lines, jlines = [], []
    got = port.query(Query("trk", ecql), explain_out=lines.append)
    want = ref.query(JQuery("trk", ecql), explain_out=jlines.append)
    assert list(got.ids) == list(want.ids)
    assert (got.plan.index, got.plan.cost) == (want.plan.index,
                                               want.plan.cost)
    for tier in ("XZ-pruned host scan", "Device extent scan"):
        assert any(tier in ln for ln in lines) == any(
            tier in ln for ln in jlines), tier
    if dense:
        assert any("Device extent scan" in ln for ln in lines)
    assert port.query_count(ecql, "trk") == len(want.ids)


@pytest.mark.parametrize("tracks,query,want", [
    (["LINESTRING (-60 -40, 60 40)", "LINESTRING (1.0 1.0, 1.1 1.1)"],
     "BBOX(track, 0.5, 0.2, 1.5, 1.2)", {"t0", "t1"}),
    (["LINESTRING (-190 10, -170 12)", "LINESTRING (-171 11, -170.5 11.5)"],
     "BBOX(track, -175, 9, -169, 13)", {"t0", "t1"}),
])
def test_big_and_out_of_domain_extents_found(tracks, query, want):
    """A geometry much larger than the query box, and one crossing the
    domain's edge, stay candidates (as in the reference)."""
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s in (port, ref):
        s.create_schema(parse_spec("trk", SPEC) if s is port
                        else jparse_spec("trk", SPEC))
        s.write_dict("trk", ["t0", "t1"], {
            "name": ["a", "b"], "dtg": [MS("2018-01-05")] * 2,
            "track": tracks})
    got = set(port.query(query, "trk").ids.astype(str))
    assert got == want == set(ref.query(query, "trk").ids.astype(str))
