"""Extent (XZ) schemas in the port against the JAX package: the extent
tristate's plain version against ``geomesa_tpu.scan.gscan.extent_tristate``
on its edge cases, a seeded extent store over a filter battery on the
XZ-pruned host path and on the dense tristate path, and the DataStore
contract cases over an extent schema (delete, sort, projection,
sampling, visibility, BIN bytes, density, stats, Arrow).

Tolerance: exact. States are int8, ids are compared in result order,
plan costs, BIN and Arrow bytes and density grids must be equal.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.features import parse_spec as jparse_spec
from geomesa_tpu.features.batch import FeatureBatch as JFeatureBatch
from geomesa_tpu.geometry import parse_wkt as jparse_wkt
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.scan import gscan as jgscan
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan import gscan, kernels
from test_torch_package import EXTENT_QUERIES, extent_cases

MS_DAY = 86_400_000
MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731


# -- the tristate's plain version against the reference ----------------------

@pytest.mark.parametrize("with_times", [True, False])
@pytest.mark.parametrize("n", [1, 257, 20_011])
@pytest.mark.parametrize("qi", range(len(EXTENT_QUERIES)))
def test_plain_tristate_matches_reference(n, with_times, qi):
    """NaN rows, edges with no exact f32, an inverted inner box, 64
    boxes and 16 intervals, pre-1970 millis, intervals on day
    boundaries, no dtg: int8 states equal the reference's."""
    boxes, intervals = EXTENT_QUERIES[qi]
    b, ms = extent_cases(n, seed=n + qi)
    millis = ms if with_times else None
    want = jgscan.extent_tristate(jgscan.build_extent_data(b, millis),
                                  jgscan.extent_query(boxes, intervals))
    data = gscan.build_extent_data(b, millis, "cpu")
    got = gscan.extent_tristate(data, gscan.extent_query(boxes, intervals))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_tristate_tables_round_like_reference():
    """The outer and inner boxes are the reference's f32 roundings (bit
    for bit), the inverted inner box included, and the (day, ms) split
    is floor division for pre-1970 millis."""
    boxes = [(0.1, 1 / 3, 0.1 + 1e-9, 0.5), (-2.7, -7.3, 5.000000001, 7.3)]
    iv = [(-MS_DAY - 1, 3 * MS_DAY), (-1, 0)]
    q, jq = gscan.extent_query(boxes, iv), jgscan.extent_query(boxes, iv)
    k, b = len(boxes), len(iv)
    assert np.array_equal(q.outer.view(np.int32),
                          np.asarray(jq.outer)[:k].view(np.int32))
    assert np.array_equal(q.inner.view(np.int32),
                          np.asarray(jq.inner)[:k].view(np.int32))
    assert q.inner[0, 0] > q.inner[0, 2]    # inverted: never IN
    assert np.array_equal(q.intervals, np.asarray(jq.times)[:b])
    bounds, ms = extent_cases(500, seed=3)
    d = gscan.build_extent_data(bounds, ms, "cpu")
    jd = jgscan.build_extent_data(bounds, ms)
    cols = [np.asarray(c) for c in (jd.bxmin, jd.bymin, jd.bxmax, jd.bymax)]
    assert np.array_equal(d.bounds.numpy().view(np.int32),
                          np.stack(cols, axis=1).view(np.int32))
    assert np.array_equal(d.valid.numpy(), np.asarray(jd.valid))
    assert np.array_equal(d.times[:, 0].numpy(), np.asarray(jd.tday))
    assert np.array_equal(d.times[:, 1].numpy(), np.asarray(jd.tms))


def test_tristate_wrapper_refuses_bad_tables():
    b, ms = extent_cases(16)
    d = gscan.build_extent_data(b, ms, "cpu")
    o, i, t = gscan.extent_query(*EXTENT_QUERIES[0]).tables("cpu")
    with pytest.raises(ValueError, match="same boxes"):
        kernels.extent_tristate(d.bounds, d.valid, d.times, o, i[:0], t)
    with pytest.raises(ValueError, match="bool"):
        kernels.extent_tristate(d.bounds, d.valid.to(torch.uint8), d.times,
                                o, i, t)
    big = torch.zeros((1600, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.extent_tristate(d.bounds, d.valid, d.times, big, big, t)


# -- a seeded extent store over a filter battery ------------------------------

SPEC = ("name:String:index=true,val:Integer,dtg:Date,"
        "*geom:Geometry:srid=4326")
N = 4_000


def _wkts(rng, n):
    """Polygons (a fifth with a hole), lines, multipolygons, points and
    multipoints around (0, 0), a few on a shared grid so edges coincide,
    2 % null."""
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-12, 12, 2)
        if i % 7 == 0:
            cx, cy = np.round(cx), np.round(cy)
        w, h = rng.uniform(0.05, 1.5, 2)
        kind = i % 10
        if rng.random() < 0.02:
            out.append(None)
        elif kind < 4:
            shell = (f"({cx} {cy}, {cx + w} {cy}, {cx + w} {cy + h}, "
                     f"{cx} {cy + h}, {cx} {cy})")
            if kind == 0:
                hx, hy = cx + w / 4, cy + h / 4
                shell += (f", ({hx} {hy}, {hx + w / 2} {hy}, "
                          f"{hx + w / 2} {hy + h / 2}, {hx} {hy + h / 2}, "
                          f"{hx} {hy})")
            out.append(f"POLYGON ({shell})")
        elif kind < 7:
            k = rng.integers(2, 6)
            pts = np.cumsum(rng.normal(0, 0.4, (k, 2)), axis=0) + (cx, cy)
            out.append("LINESTRING (" + ", ".join(
                f"{x} {y}" for x, y in pts) + ")")
        elif kind == 7:
            out.append(f"MULTIPOLYGON ((({cx} {cy}, {cx + w} {cy}, "
                       f"{cx} {cy + h}, {cx} {cy})), (({cx + 2} {cy}, "
                       f"{cx + 2 + w} {cy}, {cx + 2} {cy + h}, "
                       f"{cx + 2} {cy})))")
        elif kind == 8:
            out.append(f"POINT ({cx} {cy})")
        else:
            out.append(f"MULTIPOINT (({cx} {cy}), ({cx + w} {cy + h}))")
    return out


def _extent_data(seed=21, n=N):
    rng = np.random.default_rng(seed)
    ms = rng.integers(MS("1969-12-01"), MS("1970-03-01"), n).astype(object)
    ms[rng.random(n) < 0.01] = None
    return [f"e{i}" for i in range(n)], {
        "name": [f"n{i % 6}" for i in range(n)],
        "val": rng.integers(0, 50, n),
        "dtg": ms, "geom": _wkts(rng, n)}


@pytest.fixture(scope="module")
def extent_stores():
    ids, data = _extent_data()
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    port.create_schema(parse_spec("ext", SPEC))
    ref.create_schema(jparse_spec("ext", SPEC))
    # two writes: the second flush rebuilds the tristate columns and the
    # XZ-key index over both
    for s in (port, ref):
        s.write_dict("ext", ids[:2500],
                     {k: v[:2500] for k, v in data.items()})
        s.query_count("INCLUDE", "ext")
        s.write_dict("ext", ids[2500:],
                     {k: v[2500:] for k, v in data.items()})
    return port, ref


J70 = "dtg DURING 1970-01-05T00:00:00Z/1970-02-01T00:00:00Z"
PRE70 = "dtg DURING 1969-12-03T00:00:00Z/1970-01-02T12:00:00Z"
DONUT = ("POLYGON ((-6 -6, 6 -6, 6 6, -6 6, -6 -6), "
         "(-2 -2, 2 -2, 2 2, -2 2, -2 -2))")
TRI = "POLYGON ((-5 -4, 7 -3, 1 8, -5 -4))"
FILTERS = [
    "INCLUDE", "EXCLUDE",
    "BBOX(geom, -3, -3, 4, 4)", "BBOX(geom, -3, -3, 4, 4) AND " + J70,
    "BBOX(geom, 0, 0, 0.5, 0.5)", "BBOX(geom, -12.5, -12.5, 13.5, 13.5)",
    "BBOX(geom, -3, -3, 4, 4) AND " + PRE70,
    "BBOX(geom, 0.1, 0.2, 3.3, 2.7) AND " + J70,
    "(BBOX(geom, -10, -10, -5, -5) OR BBOX(geom, 5, 5, 10, 10)) AND " + J70,
    "BBOX(geom, -3, -3, 4, 4) OR BBOX(geom, 8, 8, 9, 9)",
    "BBOX(geom, 170, -3, 190, 4)", J70, PRE70,
    "dtg AFTER 1970-02-20T00:00:00Z",
    f"INTERSECTS(geom, {TRI})", f"INTERSECTS(geom, {TRI}) AND {J70}",
    f"INTERSECTS(geom, {DONUT})", f"WITHIN(geom, {DONUT})",
    f"WITHIN(geom, {TRI}) AND {PRE70}", f"DISJOINT(geom, {TRI})",
    "CONTAINS(geom, POINT (1.5 1.5))", "CONTAINS(geom, POINT (3 3))",
    f"TOUCHES(geom, {DONUT})", "TOUCHES(geom, POLYGON ((0 0, 1 0, 1 1, "
    "0 1, 0 0)))", "CROSSES(geom, LINESTRING (-12 0.5, 12 0.7))",
    f"CROSSES(geom, {TRI})", f"OVERLAPS(geom, {TRI})",
    "OVERLAPS(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "EQUALS(geom, POINT (3 4))", "INTERSECTS(geom, POINT (3 4))",
    "INTERSECTS(geom, LINESTRING (-8 -8, 8 8))",
    "INTERSECTS(geom, MULTIPOINT ((1 1), (2 2), (-3 4)))",
    "DWITHIN(geom, POINT (1 1), 100, kilometers)",
    "DWITHIN(geom, POINT (1 1), 50, statute miles) AND " + J70,
    "DWITHIN(geom, LINESTRING (-5 0, 5 0), 0.3, degrees)",
    f"DWITHIN(geom, {TRI}, 20000, meters)",
    "name = 'n2' AND BBOX(geom, -3, -3, 4, 4)",
    "name = 'n2'", "name IN ('n1', 'n4') AND " + J70,
    "val > 40 AND BBOX(geom, -6, -6, 6, 6)",
    "NOT BBOX(geom, -3, -3, 4, 4)", "IN ('e1', 'e17', 'e3001')",
    "IN ('e1', 'e17') AND BBOX(geom, -20, -20, 20, 20)",
    "dtg IS NULL", "geom IS NULL",
    f"INTERSECTS(geom, {DONUT}) AND name LIKE 'n%' AND {J70}",
]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ecql", FILTERS)
def test_extent_store_matches_reference(extent_stores, ecql, dense,
                                        monkeypatch):
    """Ids (in order), counts, strategies and plan costs equal the JAX
    store's, on the XZ-pruned host path and on the dense tristate path
    (geomesa.scan.extent.host.rows = 0 in both packages)."""
    port, ref = extent_stores
    if dense:
        monkeypatch.setenv("GEOMESA_SCAN_EXTENT_HOST_ROWS", "0")
    lines, jlines = [], []
    got = port.query(Query("ext", ecql), explain_out=lines.append)
    want = ref.query(JQuery("ext", ecql), explain_out=jlines.append)
    assert list(got.ids) == list(want.ids)
    assert (got.plan.index, got.plan.cost) == (want.plan.index,
                                               want.plan.cost)
    assert port.query_count(ecql, "ext") == ref.query_count(ecql, "ext")
    tiers = ("XZ-pruned host scan", "Device extent scan")
    assert [any(t in ln for ln in lines) for t in tiers] == \
        [any(t in ln for ln in jlines) for t in tiers]
    if dense and got.plan.index.startswith("xz"):
        # the tristate, unless the XZ index found no candidate at all
        assert any("Device extent scan" in ln for ln in lines) or any(
            "XZ-pruned host scan: 0 candidate" in ln for ln in lines)


def test_query_batched_matches_reference(extent_stores):
    """query_batched on an extent schema runs its queries one by one, as
    the reference does: the same ids per query, in input order."""
    port, ref = extent_stores
    ecqls = FILTERS[2:12] + ["BBOX(geom, -3, -3, 4, 4)"]
    got = port.query_batched([Query("ext", e) for e in ecqls])
    want = ref.query_batched([JQuery("ext", e) for e in ecqls])
    assert [list(r.ids) for r in got] == [list(r.ids) for r in want]


@pytest.mark.parametrize("hint", ["xz3", "xz2", "id", "fullscan"])
def test_query_index_hint_matches_reference(extent_stores, hint):
    port, ref = extent_stores
    ecql = "BBOX(geom, -3, -3, 4, 4) AND " + J70
    got = port.query(Query("ext", ecql, hints={"QUERY_INDEX": hint}))
    want = ref.query(JQuery("ext", ecql, hints={"QUERY_INDEX": hint}))
    assert got.plan.index == want.plan.index
    assert list(got.ids) == list(want.ids)


def test_timeless_extent_schema_matches_reference():
    """A schema with no dtg has xz2 only, and no times on the device."""
    spec = "name:String,*geom:Polygon:srid=4326"
    rng = np.random.default_rng(4)
    wkts = [w for w in _wkts(rng, 1500) if w is None or w.startswith("POLY")]
    ids = [f"p{i}" for i in range(len(wkts))]
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    port.create_schema(parse_spec("poly", spec))
    ref.create_schema(jparse_spec("poly", spec))
    for s in (port, ref):
        s.write_dict("poly", ids, {"name": ["a"] * len(wkts), "geom": wkts})
    assert port._state("poly").ensure_index() is None
    assert port._state("poly").extent_data.times is None
    for ecql in ("BBOX(geom, -3, -3, 4, 4)", f"INTERSECTS(geom, {TRI})",
                 "DWITHIN(geom, POINT (1 1), 100, kilometers)", "INCLUDE"):
        for rows in (None, "0"):
            if rows is None:
                import os
                os.environ.pop("GEOMESA_SCAN_EXTENT_HOST_ROWS", None)
            else:
                import os
                os.environ["GEOMESA_SCAN_EXTENT_HOST_ROWS"] = rows
            try:
                got, want = port.query(ecql, "poly"), ref.query(ecql, "poly")
            finally:
                import os
                os.environ.pop("GEOMESA_SCAN_EXTENT_HOST_ROWS", None)
            assert got.plan.index == want.plan.index
            assert list(got.ids) == list(want.ids), ecql


# -- the DataStore contract over an extent schema -----------------------------

@pytest.fixture
def pair():
    ids, data = _extent_data(seed=8, n=1500)
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    port.create_schema(parse_spec("ext", SPEC))
    ref.create_schema(jparse_spec("ext", SPEC))
    for s in (port, ref):
        s.write_dict("ext", ids, data)
    return port, ref


def _plain(v):
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if hasattr(v, "geom_type"):
        return (v.geom_type, repr(v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _features(res):
    return [{k: _plain(v) for k, v in f.items()} for f in res.features()]


def test_extent_geometries():
    """tests/test_datastore_contract.py's extent case, on the port."""
    store = InMemoryDataStore(device="cpu")
    store.create_schema(parse_spec(
        "ext", "name:String,dtg:Date,*geom:Geometry:srid=4326"))
    wkts = ["POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
            "POLYGON ((20 20, 30 20, 30 30, 20 30, 20 20))",
            "LINESTRING (5 5, 25 25)",
            "POLYGON ((-50 -50, -40 -50, -40 -40, -50 -40, -50 -50))"]
    store.write_dict("ext", [f"g{i}" for i in range(len(wkts))], {
        "name": [f"n{i}" for i in range(len(wkts))],
        "dtg": [MS("2020-01-01")] * len(wkts),
        "geom": wkts,
    })
    res = store.query("BBOX(geom, 1, 1, 9, 9)", "ext")
    assert set(res.ids.astype(str)) == {"g0", "g2"}
    res = store.query(
        "INTERSECTS(geom, POLYGON ((4 4, 26 4, 26 26, 4 26, 4 4)))", "ext")
    assert set(res.ids.astype(str)) == {"g0", "g1", "g2"}
    assert store.query("INCLUDE", "ext").n == len(wkts)


def test_delete_and_remove_schema_match_reference(pair):
    port, ref = pair
    victims = [f"e{i}" for i in range(0, 1500, 7)]
    for s in (port, ref):
        s.query_count("INCLUDE", "ext")   # build, then delete
        s.delete("ext", victims)
    assert port.count("ext") == ref.count("ext")
    for ecql in ("INCLUDE", "BBOX(geom, -3, -3, 4, 4) AND " + J70,
                 f"INTERSECTS(geom, {TRI})"):
        for rows in (None, "0"):
            import os
            if rows is None:
                os.environ.pop("GEOMESA_SCAN_EXTENT_HOST_ROWS", None)
            else:
                os.environ["GEOMESA_SCAN_EXTENT_HOST_ROWS"] = rows
            try:
                assert list(port.query(ecql, "ext").ids) == \
                    list(ref.query(ecql, "ext").ids)
            finally:
                os.environ.pop("GEOMESA_SCAN_EXTENT_HOST_ROWS", None)
    assert port.analyze("ext").count.count == ref.analyze("ext").count.count
    for s in (port, ref):
        s.remove_schema("ext")
        assert "ext" not in s.get_type_names()


@pytest.mark.parametrize("sort_by,desc", [("val", False), ("val", True),
                                          ("name", False), ("dtg", True)])
def test_sort_limit_projection_match_reference(pair, sort_by, desc):
    port, ref = pair
    ecql = "BBOX(geom, -8, -8, 8, 8)"
    got = port.query(Query("ext", ecql, sort_by=sort_by, sort_desc=desc,
                           max_features=40, properties=["name", "geom"]))
    want = ref.query(JQuery("ext", ecql, sort_by=sort_by, sort_desc=desc,
                            max_features=40, properties=["name", "geom"]))
    assert list(got.ids) == list(want.ids)
    assert _features(got) == _features(want)


def test_sampling_matches_reference(pair):
    port, ref = pair
    for hints in ({"SAMPLING": 0.2}, {"SAMPLING": 0.3, "SAMPLE_BY": "name"}):
        got = port.query(Query("ext", "BBOX(geom, -10, -10, 10, 10)",
                               hints=hints))
        want = ref.query(JQuery("ext", "BBOX(geom, -10, -10, 10, 10)",
                                hints=hints))
        assert list(got.ids) == list(want.ids)


@pytest.mark.parametrize("level", ["feature", "attribute"])
def test_visibility_matches_reference(level):
    """Feature- and attribute-level labels: ids and the values each
    auth set sees (a hidden geometry reads as null) equal the JAX
    store's."""
    ids, data = _extent_data(seed=9, n=800)
    spec = SPEC + (";geomesa.visibility.level=attribute"
                   if level == "attribute" else "")
    if level == "feature":
        labels = [None, "a", "a&b", "b|c"]
    else:
        labels = [",,,", "a,,,", ",b,,a&b", "c,c,c,c"]
    vis = [labels[i % 4] for i in range(len(ids))]
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    port.create_schema(parse_spec("ext", spec))
    ref.create_schema(jparse_spec("ext", spec))
    for s, fb, sft in ((port, FeatureBatch, port.get_schema("ext")),
                       (ref, JFeatureBatch, ref.get_schema("ext"))):
        s.write("ext", fb.from_dict(sft, ids, data), visibilities=vis)
    for auths in ([], ["a"], ["a", "b"], ["a", "b", "c"]):
        for ecql in ("INCLUDE", "BBOX(geom, -6, -6, 6, 6)",
                     "BBOX(geom, -6, -6, 6, 6) AND val > 20"):
            got = port.query(Query("ext", ecql, auths=auths))
            want = ref.query(JQuery("ext", ecql, auths=auths))
            assert list(got.ids) == list(want.ids), (auths, ecql)
            assert _features(got) == _features(want), (auths, ecql)


def test_bin_and_density_match_reference(pair):
    """BIN records (bounding-box centres) byte for byte, and density
    grids (bounding-box centres, f32) cell for cell."""
    port, ref = pair
    for ecql in ("INCLUDE", "BBOX(geom, -6, -6, 6, 6) AND " + J70):
        for kw in ({}, {"label": "name", "sort": True},
                   {"track": "name"}):
            assert port.bin_query("ext", ecql, **kw) == \
                ref.bin_query("ext", ecql, **kw), (ecql, kw)
        for bbox, w, h, attr in (((-15, -15, 15, 15), 64, 48, None),
                                 ((-6, -6, 6, 6), 16, 16, "val")):
            got = port.density("ext", ecql, bbox, w, h, weight_attr=attr)
            want = ref.density("ext", ecql, bbox, w, h, weight_attr=attr)
            assert np.array_equal(got, np.asarray(want)), (ecql, bbox)


def test_stats_and_arrow_match_reference(pair):
    """Stats sketches and analyze, plan costs from the stats, and Arrow
    IPC bytes (geometries as WKB) equal the JAX store's."""
    pytest.importorskip("pyarrow")
    port, ref = pair
    for ecql in ("INCLUDE", "BBOX(geom, -6, -6, 6, 6) AND " + J70):
        for spec in ("Count()", "MinMax(dtg)", "MinMax(val)",
                     "Enumeration(name)", "Histogram(val,10,0,50)",
                     "TopK(name,3)"):
            assert port.stats_query("ext", spec, ecql).to_json() == \
                ref.stats_query("ext", spec, ecql).to_json(), (spec, ecql)
        assert port.arrow_ipc("ext", ecql) == ref.arrow_ipc("ext", ecql)
        assert port.arrow_ipc("ext", ecql, sort_by="val") == \
            ref.arrow_ipc("ext", ecql, sort_by="val")
    assert port.stats.get("ext").estimate_count(
        port.query("INCLUDE", "ext").plan.primary or _include()) == \
        ref.stats.get("ext").estimate_count(_jinclude())


def _include():
    from geomesa_tpu_torch.filters import ast
    return ast.Include()


def _jinclude():
    from geomesa_tpu.filters import ast
    return ast.Include()


def test_wkt_values_round_trip(pair):
    """Every stored geometry reads back as the reference's, value for
    value, through the result batch."""
    port, ref = pair
    got = port.query("INCLUDE", "ext").batch.col("geom")
    want = ref.query("INCLUDE", "ext").batch.col("geom")
    assert [_plain(g) for g in got.geoms] == [_plain(g) for g in want.geoms]
    assert np.array_equal(got.bounds, want.bounds, equal_nan=True)
    assert repr(parse_wkt(DONUT)) == repr(jparse_wkt(DONUT))
