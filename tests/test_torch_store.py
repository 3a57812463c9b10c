"""The port's InMemoryDataStore against the JAX reference store on the
CPU: the same chunked writes and the slice's queries, in each of the
three scan tiers (forced through geomesa.scan.host.rows and
geomesa.scan.index.threshold). Tolerance: exact — ids and counts must
be equal, id for id."""

import numpy as np
import pytest

from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.scan import kernels

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64))
MS_DAY = 86_400_000
N = 50_000
CHUNKS = [0, 12_000, 25_000, 31_000, 40_000, N]

# tier -> (geomesa.scan.host.rows, geomesa.scan.index.threshold)
TIERS = {"host": (None, None), "gathered": ("0", "1.0"),
         "dense": ("0", "0")}
TIER_LINE = {"host": None, "gathered": "Index-pruned device scan",
             "dense": "Device scan:"}


def _rows():
    rng = np.random.default_rng(21)
    x = rng.uniform(-180, 180, N)
    y = rng.uniform(-90, 90, N)
    ms = T0 + rng.integers(0, 100 * MS_DAY, N)
    # rows placed ON the bounds of the boundary query below
    x[:4] = [-80.0, -60.0, -70.0, -70.0]
    y[:4] = [35.0, 35.0, 30.0, 45.0]
    ms[:4] = T0 + 20 * MS_DAY
    names = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, N)]
    return x, y, ms, names


QUERIES = [
    "BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
    "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z",
    "BBOX(geom, -80, 30, -60, 45) AND dtg BETWEEN "
    "2020-01-21T00:00:00Z AND 2020-01-21T00:00:00Z",
    "BBOX(geom, -10, -10, 10, 10)",
    "(BBOX(geom, -80, 30, -60, 45) OR BBOX(geom, 0, 0, 30, 20)) AND "
    "dtg DURING 2020-01-05T00:00:00Z/2020-03-01T00:00:00Z",
    "INTERSECTS(geom, POLYGON((100 -50, 140 -50, 140 -10, 100 -10, "
    "100 -50))) AND dtg BETWEEN 2020-02-01T00:00:00Z AND "
    "2020-03-15T00:00:00Z",
    "WITHIN(geom, POLYGON((-20 -20, 20 -20, 20 20, -20 20, -20 -20)))",
    "dtg DURING 2020-01-01T12:00:00Z/2020-01-03T00:00:00Z",
    "BBOX(geom, 170, -30, 190, 30) AND dtg DURING "
    "2020-01-01T00:00:00Z/2020-04-01T00:00:00Z",
    "BBOX(geom, -100, -40, 60, 70) AND dtg > 2020-03-01T00:00:00Z",
    "BBOX(geom, -120, -60, 120, 60) AND dtg >= 2020-01-15T00:00:00Z AND "
    "dtg <= 2020-02-15T00:00:00Z",
    "dtg < 2020-01-02T00:00:00Z",
    "BBOX(geom, -180, -90, 180, 90)",
    "INCLUDE",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 20, 20, 30, 30)",
]


@pytest.fixture(scope="module")
def stores():
    x, y, ms, names = _rows()
    ports = {t: InMemoryDataStore(device="cpu") for t in TIERS}
    ref = JaxStore()
    for s in (*ports.values(), ref):
        s.create_schema("pts", SPEC)
    return x, y, ms, names, ports, ref


def _write(stores, lo, hi):
    x, y, ms, names, ports, ref = stores
    ids = [f"f{i}" for i in range(lo, hi)]
    data = {"name": names[lo:hi], "dtg": ms[lo:hi],
            "geom": (x[lo:hi], y[lo:hi])}
    for s in (*ports.values(), ref):
        s.write_dict("pts", ids, data)


@pytest.fixture
def tier_props(monkeypatch):
    """Force a tier in both packages (both read the environment)."""
    def force(tier):
        host, thr = TIERS[tier]
        for name, v in (("GEOMESA_SCAN_HOST_ROWS", host),
                        ("GEOMESA_SCAN_INDEX_THRESHOLD", thr)):
            if v is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, v)
    return force


def _check_all(stores, tier_props):
    _, _, _, _, ports, ref = stores
    for tier, port in ports.items():
        tier_props(tier)
        for q in QUERIES:
            before = dict(kernels.launches)
            got = port.query(q, "pts")
            want = ref.query(q, "pts")
            assert list(got.ids) == list(want.ids), (tier, q)
            assert port.query_count(q, "pts") == ref.query_count(q, "pts") \
                == got.n, (tier, q)
            # on CPU tensors the wrappers run their plain versions
            assert kernels.launches == before
    tier_props("host")


def test_chunked_writes_all_tiers(stores, tier_props):
    # first chunks, then reads; then more chunks appended in place
    # (and once past the capacity) before reading again
    for lo, hi in zip(CHUNKS[:3], CHUNKS[1:3]):
        _write(stores, lo, hi)
    _check_all(stores, tier_props)
    # capacity after the first build: next_pow2(25_000) = 32_768
    in_place = {31_000: True, 40_000: False, N: True}
    for lo, hi in zip(CHUNKS[2:], CHUNKS[3:]):
        _write(stores, lo, hi)
        for port in stores[4].values():
            st = port._types["pts"]
            col = st.scan_data.xhi
            port.query(QUERIES[0], "pts")  # flushes the chunk
            assert port.count("pts") == hi == st.scan_data.n
            assert (st.scan_data.xhi is col) == in_place[hi]
    _check_all(stores, tier_props)


def test_each_tier_runs(stores, tier_props):
    """The forced properties really select the tier."""
    _, _, _, _, ports, _ = stores
    q = QUERIES[0]
    for tier, port in ports.items():
        tier_props(tier)
        text = port.query(q, "pts").explain.text
        if tier == "host":
            assert "Index-pruned host scan" in text
        else:
            assert TIER_LINE[tier] in text
    tier_props("host")


def test_boundary_rows_are_exact(stores):
    """Rows placed on the box's bounds come back (inclusive bounds) in
    every tier."""
    _, _, _, _, ports, _ = stores
    for port in ports.values():
        ids = set(port.query(QUERIES[0], "pts").ids)
        assert {"f0", "f1", "f2", "f3"} <= ids


def test_max_features(stores):
    _, _, _, _, ports, ref = stores
    from geomesa_tpu.index.api import Query as JQuery
    from geomesa_tpu_torch import Query
    got = ports["dense"].query(Query("pts", QUERIES[2], max_features=7))
    want = ref.query(JQuery("pts", QUERIES[2], max_features=7))
    assert list(got.ids) == list(want.ids) and got.n == 7


@pytest.mark.parametrize("ecql", [
    "DWITHIN(geom, POINT(0 0), 10, kilometers)",
    "BEYOND(geom, POINT(0 0), 10, kilometers)",
    "CONTAINS(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "TOUCHES(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "CROSSES(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "OVERLAPS(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "EQUALS(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "INTERSECTS(geom, POINT(1 2))",
])
def test_out_of_slice_filters_raise(stores, ecql):
    """Filters that the point slices refused: BEYOND, which no ECQL
    grammar of either package has, raises ECQLError in both; since the
    relate and distance slice the others run, id for id with the JAX
    store (exact)."""
    from geomesa_tpu.filters.ecql import ECQLError as JECQLError
    from geomesa_tpu_torch.filters.ecql import ECQLError
    _, _, _, _, ports, ref = stores
    port = ports["dense"]
    if ecql.startswith("BEYOND"):
        with pytest.raises(ECQLError):
            port.query(ecql, "pts")
        with pytest.raises(JECQLError):
            ref.query(ecql, "pts")
        return
    assert list(port.query(ecql, "pts").ids) == list(ref.query(ecql, "pts").ids)


@pytest.mark.parametrize("ecql", [
    "NOT BBOX(geom, 0, 0, 1, 1)",
    "name = 'a'",
    "name LIKE 'a%'",
    "INTERSECTS(geom, POLYGON((0 0, 10 0, 5 10, 0 0)))",
    "EXCLUDE",
    "dtg BEFORE 2020-01-02T00:00:00Z",
])
def test_former_out_of_slice_filters_match_reference(stores, ecql):
    """Filters that slice 1 refused now run, id for id with the JAX
    store (exact)."""
    _, _, _, _, ports, ref = stores
    port = ports["dense"]
    assert list(port.query(ecql, "pts").ids) == list(ref.query(ecql, "pts").ids)


def test_extent_schema_raises():
    """An extent schema is created (the extent slice), and so is a
    schema with no geometry (the geometry-less slice); a spatial filter
    on the latter raises KeyError, as in the JAX store."""
    s = InMemoryDataStore(device="cpu")
    s.create_schema("poly", "dtg:Date,*geom:Polygon:srid=4326")
    assert not s.get_schema("poly").is_points
    s.create_schema("plain", "name:String,dtg:Date")
    assert s.get_schema("plain").geom_field is None
    s.write_dict("plain", ["a"], {"name": ["x"], "dtg": [0]})
    with pytest.raises(KeyError):
        s.query("BBOX(geom, 0, 0, 1, 1)", "plain")


# one attribute bounded by a quoted and an unquoted literal under AND:
# (filter, the same filter with every literal unquoted)
MIXED = [
    ("dtg AFTER 1969-11-27T01:49:17Z AND dtg BETWEEN "
     "'1970-01-01T12:00:00Z' AND '1970-01-03T00:00:00Z'",
     "dtg AFTER 1969-11-27T01:49:17Z AND dtg BETWEEN "
     "1970-01-01T12:00:00Z AND 1970-01-03T00:00:00Z"),
    ("val > '2' AND val < 8", "val > 2 AND val < 8"),
    ("val = '5' AND val > 1", "val = 5 AND val > 1"),
    ("val BETWEEN 1 AND '5' AND val <> 3", "val BETWEEN 1 AND 5 AND val <> 3"),
    ("score >= '2.5' AND score < 9", "score >= 2.5 AND score < 9"),
    ("val > '2.5' OR dtg < '1970-01-02T00:00:00Z'",
     "val > 2.5 OR dtg < 1970-01-02T00:00:00Z"),
]


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("ecql,unquoted", MIXED)
def test_mixed_literal_bounds_match_the_evaluator(ecql, unquoted, indexed):
    """A quoted literal is coerced to its attribute's type before the
    bounds intersect (a departure: the JAX store raises TypeError, and
    its evaluator raises on a quoted number). The oracle is the JAX
    package's host evaluate of the filter with every literal unquoted,
    and of the filter itself where it answers (the dates); exact."""
    from geomesa_tpu.features import parse_spec as jparse_spec
    from geomesa_tpu.features.batch import FeatureBatch as JBatch
    from geomesa_tpu.filters import parse_ecql as jparse
    from geomesa_tpu.filters.evaluate import evaluate as jevaluate
    idx = ":index=true" if indexed else ""
    spec = f"val:Integer{idx},score:Double{idx},dtg:Date,*geom:Point"
    n = 400
    rng = np.random.default_rng(2)
    data = {"val": rng.integers(0, 10, n), "score": rng.uniform(0, 10, n),
            "dtg": rng.integers(-2, 4, n) * MS_DAY // 2,
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    ids = [f"f{i}" for i in range(n)]
    port = InMemoryDataStore(device="cpu")
    port.create_schema("m", spec)
    port.write_dict("m", ids, data)
    batch = JBatch.from_dict(jparse_spec("m", spec), ids, data)
    want = np.asarray(ids)[jevaluate(jparse(unquoted), batch)]
    if ecql.startswith("dtg"):
        assert list(np.asarray(ids)[jevaluate(jparse(ecql), batch)]) == \
            list(want)
    assert len(want) > 0
    assert sorted(port.query(ecql, "m").ids) == sorted(want)
    assert port.query_count(ecql, "m") == len(want)
    from geomesa_tpu_torch import Query
    got = port.query_batched([Query("m", ecql),
                              Query("m", "BBOX(geom, -5, -5, 5, 5)")])[0]
    assert sorted(got.ids) == sorted(want)
    ref = JaxStore()
    ref.create_schema("m", spec)
    ref.write_dict("m", ids, data)
    if (ecql, unquoted) in MIXED[:3] and (indexed or ecql.startswith("dtg")):
        # ROADMAP's three, where the JAX store intersects the bounds
        with pytest.raises(TypeError):
            ref.query(ecql, "m")
    elif (ecql, unquoted) in MIXED[1:3]:
        # unindexed integers: its device residual coerces, and answers
        assert list(port.query(ecql, "m").ids) == \
            list(ref.query(ecql, "m").ids)


# -- a schema without a geometry ---------------------------------------------

PLAIN_SPEC = ("name:String:index=true,age:Integer:index=true,score:Double,"
              "dtg:Date")
PLAIN_N = 20_000
PLAIN_QUERIES = [
    "age > 80", "age = 33", "name = 'n3'", "IN ('p1', 'p5', 'p19999')",
    "INCLUDE", "score > 0.25", "age > 10 AND score < 0.2",
    "dtg AFTER 2020-01-10T00:00:00Z", "name LIKE 'n1%' OR age < 5",
    "NOT (age BETWEEN 20 AND 60)", "score IS NULL",
]


@pytest.fixture(scope="module")
def plain_stores():
    """A port store on the CPU and a JAX store, each holding the same
    seeded rows of a schema with no geometry."""
    rng = np.random.default_rng(31)
    ids = [f"p{i}" for i in range(PLAIN_N)]
    score = rng.uniform(0, 1, PLAIN_N)
    score[::97] = np.nan
    data = {"name": [f"n{i}" for i in rng.integers(0, 20, PLAIN_N)],
            "age": rng.integers(0, 90, PLAIN_N),
            "score": score,
            "dtg": T0 + rng.integers(0, 30 * MS_DAY, PLAIN_N)}
    out = []
    for s in (InMemoryDataStore(device="cpu"), JaxStore()):
        s.create_schema("events", PLAIN_SPEC)
        for lo, hi in ((0, 12_000), (12_000, PLAIN_N)):
            s.write_dict("events", ids[lo:hi],
                         {k: v[lo:hi] for k, v in data.items()})
        out.append(s)
    return out


def _same_query(port, ref, ecql):
    got, want = port.query(ecql, "events"), ref.query(ecql, "events")
    assert got.plan.index == want.plan.index
    assert list(got.ids) == list(want.ids)
    assert port.query_count(ecql, "events") == \
        ref.query_count(ecql, "events") == len(want.ids)
    return got


@pytest.mark.parametrize("ecql", PLAIN_QUERIES)
def test_geometry_less_queries_match_reference(plain_stores, ecql):
    """id, attr:<name> and fullscan on a schema with no geometry, id for
    id and plan for plan with the JAX store (exact); a fullscan whose
    residual covers more than a quarter of the rows runs the residual
    program on the device path (its plain version on the CPU)."""
    port, ref = plain_stores
    assert port.get_schema("events").geom_field is None
    got = _same_query(port, ref, ecql)
    if ecql == "score > 0.25":
        assert got.plan.index == "fullscan"
        assert "Device residual scan (dense)" in got.explain.text


def test_geometry_less_delete_and_stats_match_reference():
    port, ref = (InMemoryDataStore(device="cpu"), JaxStore())
    rng = np.random.default_rng(32)
    ages = rng.integers(0, 90, 5_000)
    for s in (port, ref):
        s.create_schema("events", "name:String,age:Integer:index=true")
        s.write_dict("events", [f"e{i}" for i in range(5_000)],
                     {"name": [f"n{a % 7}" for a in ages], "age": ages})
    _same_query(port, ref, "age > 70")
    for s in (port, ref):
        s.delete("events", [f"e{i}" for i in range(0, 5_000, 3)])
    for ecql in ("age > 70", "name = 'n2'", "IN ('e1', 'e3', 'e4')",
                 "INCLUDE"):
        _same_query(port, ref, ecql)
    assert port.count("events") == ref.count("events")
    for spec in ("Count()", "MinMax(age)", "Enumeration(name)"):
        for ecql in (None, "age < 30"):
            assert (port.stats_query("events", spec, ecql).to_json_object()
                    == ref.stats_query("events", spec, ecql)
                    .to_json_object())


def test_geometry_less_spatial_entry_points_raise_as_reference(
        plain_stores):
    """The entry points that need a geometry raise KeyError in both
    stores."""
    from geomesa_tpu.analytics import processes as jp
    from geomesa_tpu_torch.analytics import processes as tp
    port, ref = plain_stores
    for s, procs in ((port, tp), (ref, jp)):
        calls = [
            lambda: s.density("events", "INCLUDE", (-180, -90, 180, 90),
                              8, 8),
            lambda: s.bin_query("events", "INCLUDE"),
            lambda: s.query("BBOX(geom, 0, 0, 1, 1)", "events"),
            lambda: procs.tube_select_process(s, "events", [0.0, 1.0],
                                              [0.0, 1.0], [0, 60_000], 0.5),
            lambda: procs.knn_process(s, "events", 0.0, 0.0, 3),
            lambda: procs.proximity_process(s, "events", [0.0], [0.0], 1.0),
        ]
        for call in calls:
            with pytest.raises(KeyError):
                call()


# -- a plan the planner proves empty keeps its schema -------------------------

EMPTY_ECQL = "BBOX(geom, 0, 0, 1, 1) AND BBOX(geom, 5, 5, 6, 6)"


@pytest.fixture(scope="module")
def small_stores():
    """Two points in a port store and a JAX store, and a second type
    created in both with no rows."""
    from geomesa_tpu.features import parse_spec as jparse_spec
    from geomesa_tpu_torch.features import parse_spec
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("pts", SPEC))
        s.write_dict("pts", ["a", "b"], {
            "name": ["x", "y"], "dtg": [T0, T0 + MS_DAY],
            "geom": ([0.5, 5.5], [0.5, 5.5])})
        s.create_schema(parse("none", SPEC))
    return port, ref


def _schema(batch):
    return ([a.name for a in batch.sft.attributes], list(batch.columns),
            batch.n, list(batch.ids))


@pytest.mark.parametrize("kw", [
    {}, {"properties": ["name"]}, {"properties": ["geom", "dtg"]},
    {"sort_by": "name", "sort_desc": True, "max_features": 1}])
def test_empty_plan_batch_matches_reference(small_stores, kw):
    """query() of a planner-proven empty plan: an empty batch of the
    type's schema (or the projection's), as in the JAX store, with the
    plan 'empty' in both."""
    from geomesa_tpu.index.api import Query as JQuery
    from geomesa_tpu_torch import Query
    port, ref = small_stores
    got = port.query(Query("pts", EMPTY_ECQL, **kw))
    want = ref.query(JQuery("pts", EMPTY_ECQL, **kw))
    assert got.plan.index == want.plan.index == "empty"
    assert got.batch is not None and want.batch is not None
    assert _schema(got.batch) == _schema(want.batch)
    assert got.n == want.n == 0 and list(got.ids) == []
    assert port.query_count(Query("pts", EMPTY_ECQL, **kw)) == 0


def test_empty_plan_in_query_batched(small_stores):
    """The empty plan's entry of query_batched is the same empty batch,
    beside fused and scalar neighbours."""
    from geomesa_tpu.index.api import Query as JQuery
    from geomesa_tpu_torch import Query
    port, ref = small_stores
    ecqls = ["BBOX(geom, 0, 0, 1, 1)", EMPTY_ECQL, "BBOX(geom, 5, 5, 6, 6)",
             "INCLUDE"]
    got = port.query_batched([Query("pts", e, properties=["name"])
                              for e in ecqls])
    want = ref.query_batched([JQuery("pts", e, properties=["name"])
                              for e in ecqls])
    for g, w in zip(got, want):
        assert _schema(g.batch) == _schema(w.batch)


def test_empty_plan_arrow_query_columns(small_stores):
    """arrow_query of an empty plan: an empty table with the JAX
    store's columns."""
    port, ref = small_stores
    got = port.arrow_query("pts", EMPTY_ECQL)
    want = ref.arrow_query("pts", EMPTY_ECQL)
    assert got is not None and want is not None
    assert got.num_rows == want.num_rows == 0
    assert got.schema.names == want.schema.names


def test_type_without_rows_still_answers_none(small_stores):
    """A type that holds no rows answers batch None in both stores,
    through query, query_batched and arrow_query."""
    from geomesa_tpu.index.api import Query as JQuery
    from geomesa_tpu_torch import Query
    port, ref = small_stores
    for ecql in ("INCLUDE", EMPTY_ECQL):
        got, want = port.query(Query("none", ecql)), ref.query(
            JQuery("none", ecql))
        assert got.batch is None and want.batch is None
        assert got.plan.index == want.plan.index == "empty"
        pair = port.query_batched([Query("none", ecql), Query("pts", ecql)])
        assert pair[0].batch is None and pair[1].batch is not None
        assert port.arrow_query("none", ecql) is None
        assert ref.arrow_query("none", ecql) is None


def test_live_store_empty_plan_matches_reference():
    """LiveDataStore.query follows the in-memory store: an empty batch
    of the schema for a planner-proven empty plan."""
    from geomesa_tpu.features import FeatureBatch as JBatch
    from geomesa_tpu.features import parse_spec as jparse_spec
    from geomesa_tpu.store.live import LiveDataStore as JLive
    from geomesa_tpu.store.live import MessageBus as JBus
    from geomesa_tpu_torch.features import FeatureBatch, parse_spec
    from geomesa_tpu_torch.store.live import LiveDataStore, MessageBus
    out = []
    for live, batch_cls, parse in (
            (LiveDataStore(MessageBus(), device="cpu"), FeatureBatch,
             parse_spec), (JLive(JBus()), JBatch, jparse_spec)):
        sft = parse("pts", SPEC)
        live.create_schema(sft)
        live.write("pts", batch_cls.from_dict(sft, ["a", "b"], {
            "name": ["x", "y"], "dtg": [T0, T0 + MS_DAY],
            "geom": ([0.5, 5.5], [0.5, 5.5])}))
        out.append(_schema(live.query(EMPTY_ECQL, "pts").batch))
    assert out[0] == out[1]
    assert out[0][2] == 0
