"""The port's store against the JAX store on the query surface: the
DataStore contract cases of delete, remove_schema, sort and limit,
projection, sampling, visibilities and BIN output, plus attribute-level
visibility, SAMPLE_BY, descending sorts over nulls, query_batched with
the post-scan stages, write_many, and the residual path after a delete;
and the contract battery's "remote" case: the port's RemoteDataStore
over the port's GeoMesaWebServer (a CPU store behind it).

Both stores get the same seeded rows (the contract battery's SPEC and
_populate, copied here); the port runs on the CPU. Tolerance: exact —
ids in result order, counts, feature values and BIN bytes must be
equal."""

import json

import numpy as np
import pytest

from geomesa_tpu.features import parse_spec as jparse_spec
from geomesa_tpu.features.batch import FeatureBatch as JFeatureBatch
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.geometry import Point
from geomesa_tpu_torch.index.api import QueryHints
from geomesa_tpu_torch.scan import aggregations

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731

SPEC = "name:String:index=true,val:Integer,dtg:Date,*geom:Point:srid=4326"
N = 3_000
BBOX = "BBOX(geom, -60, -30, 60, 30)"


def _populate(ds, type_name="t", parse=parse_spec):
    rng = np.random.default_rng(55)
    ds.create_schema(parse(type_name, SPEC))
    ds.write_dict(type_name, [f"f{i}" for i in range(N)], {
        "name": [f"n{i % 10}" for i in range(N)],
        "val": rng.integers(0, 100, N),
        "dtg": rng.integers(MS("2019-01-01"), MS("2019-03-01"), N),
        "geom": (rng.uniform(-180, 180, N), rng.uniform(-90, 90, N)),
    })
    return ds


@pytest.fixture
def pair():
    """(port store on the CPU, JAX store), the same rows in each."""
    return (_populate(InMemoryDataStore(device="cpu")),
            _populate(JaxStore(), parse=jparse_spec))


def _ids(res) -> list:
    return [str(i) for i in res.ids]


def _plain(v):
    """A feature value comparable across the two packages."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, Point) or type(v).__name__ == "Point":
        return ("POINT", v.x, v.y)
    return v


def _features(res) -> list:
    return [{k: _plain(v) for k, v in f.items()} for f in res.features()]


def _jq(q: Query) -> JQuery:
    return JQuery(q.type_name, str(q.filter), properties=q.properties,
                  max_features=q.max_features, sort_by=q.sort_by,
                  sort_desc=q.sort_desc, hints=dict(q.hints), auths=q.auths)


def _same(port, ref, q: Query):
    got, want = port.query(q), ref.query(_jq(q))
    assert _ids(got) == _ids(want)
    # the port's row ids name the same features, in result order
    src = port._types[q.type_name].batch
    assert [str(i) for i in src.ids[got.rows]] == _ids(got)
    assert port.query_count(q) == ref.query_count(_jq(q)) == got.n
    return got, want


# -- the contract battery's cases ---------------------------------------------

@pytest.mark.parametrize("ecql", [
    "INCLUDE", BBOX,
    BBOX + " AND dtg DURING 2019-01-10T00:00:00Z/2019-02-10T00:00:00Z",
    "name = 'n3'", "val > 40 AND val < 60"])
def test_delete(pair, ecql):
    port, ref = pair
    port.query(BBOX, "t")   # build the index and device columns first
    victims = [f"f{i}" for i in range(0, 100)] + ["f2500", "nope"]
    for s in pair:
        s.delete("t", victims)
    assert port.count("t") == ref.count("t") == N - 101
    got, _ = _same(port, ref, Query("t", ecql))
    assert not set(victims) & set(_ids(got))


def test_delete_then_write_and_delete_all(pair):
    port, ref = pair
    port.query(BBOX, "t")
    for s in pair:
        s.delete("t", [f"f{i}" for i in range(0, N, 3)])
        s.write_dict("t", ["g0", "g1"], {
            "name": ["n1", "n2"], "val": [5, 6],
            "dtg": [MS("2019-01-05")] * 2, "geom": ([1.0, 2.0], [1.0, 2.0])})
    _same(port, ref, Query("t", BBOX))
    _same(port, ref, Query("t", "name = 'n1'"))
    for s in pair:
        s.delete("t", [str(i) for i in s.query("INCLUDE", "t").ids])
    assert port.count("t") == ref.count("t") == 0
    assert port.query(BBOX, "t").n == 0 and port.query_count(BBOX, "t") == 0


def test_remove_schema(pair):
    port, ref = pair
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("gone", "v:Integer,*geom:Point"))
        s.write_dict("gone", ["a"], {"v": [1], "geom": ([0.0], [0.0])})
        assert "gone" in s.get_type_names()
        s.remove_schema("gone")
        assert "gone" not in s.get_type_names()
        with pytest.raises(KeyError):
            s.get_schema("gone")
    assert port.get_type_names() == ref.get_type_names()


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("key", ["val", "name", "dtg"])
def test_sort_and_limit(pair, key, desc):
    port, ref = pair
    got, want = _same(port, ref, Query("t", BBOX, sort_by=key, sort_desc=desc,
                                       max_features=25))
    assert got.n == 25
    vals = [f[key] for f in got.features()]
    assert vals == sorted(vals, reverse=desc)
    assert _features(got) == _features(want)


@pytest.mark.parametrize("props", [["name", "geom"], ["val"], ["dtg", "name"]])
def test_projection(pair, props):
    port, ref = pair
    got, want = _same(port, ref, Query("t", "name = 'n3'", properties=props))
    assert set(next(got.features())) == {"id", *props}
    assert _features(got) == _features(want)
    with pytest.raises(KeyError):
        port.query(Query("t", "INCLUDE", properties=["nope"]))


@pytest.mark.parametrize("rate", [0.25, 0.1, 1.0])
def test_query_count_honors_sampling(pair, rate):
    port, ref = pair
    got, _ = _same(port, ref, Query("t", BBOX,
                                    hints={QueryHints.SAMPLING: rate}))
    assert port.query_count(Query("t", BBOX, hints={
        QueryHints.SAMPLING: rate})) == got.n


def _vis_write(ds, parse, fb):
    ds.create_schema(parse("vis", SPEC))
    n = 40
    rng = np.random.default_rng(9)
    batch = fb.from_dict(ds.get_schema("vis"), [f"v{i}" for i in range(n)], {
        "name": [f"n{i}" for i in range(n)],
        "val": rng.integers(0, 100, n),
        "dtg": rng.integers(MS("2019-01-01"), MS("2019-03-01"), n),
        "geom": (rng.uniform(-90, 90, n), rng.uniform(-45, 45, n))})
    vis = ["admin&ops" if i % 4 == 0 else ("admin" if i % 2 == 0 else None)
           for i in range(n)]
    ds.write("vis", batch, visibilities=vis)


@pytest.mark.parametrize("auths,want_n", [
    ([], 20), (["admin"], 30), (["admin", "ops"], 40), (None, 20)])
@pytest.mark.parametrize("ecql", ["INCLUDE", "BBOX(geom, -45, -30, 45, 30)"])
def test_visibilities(pair, auths, want_n, ecql):
    port, ref = pair
    _vis_write(port, parse_spec, FeatureBatch)
    _vis_write(ref, jparse_spec, JFeatureBatch)
    got, _ = _same(port, ref, Query("vis", ecql, auths=auths))
    if ecql == "INCLUDE":
        assert got.n == want_n


def test_visibility_labels_validated():
    port = InMemoryDataStore(device="cpu")
    port.create_schema(parse_spec("vis", SPEC))
    with pytest.raises(ValueError):
        port.write_dict("vis", ["a"], {
            "name": ["x"], "val": [1], "dtg": [MS("2019-01-01")],
            "geom": ([0.0], [0.0])}, visibilities=["admin&(ops"])
    with pytest.raises(ValueError):
        port.write_dict("vis", ["a"], {
            "name": ["x"], "val": [1], "dtg": [MS("2019-01-01")],
            "geom": ([0.0], [0.0])}, visibilities=["a", "b"])
    assert port.count("vis") == 0


@pytest.mark.parametrize("kwargs", [
    {}, {"sort": True}, {"label": "name"}, {"track": "name"},
    {"track": "val", "label": "dtg", "sort": True}])
def test_bin_output(pair, kwargs):
    port, ref = pair
    got = port.bin_query("t", BBOX, **kwargs)
    assert got == ref.bin_query("t", BBOX, **kwargs)
    recs = aggregations.decode_bin_records(got, "label" in kwargs)
    assert len(recs) == port.query_count(BBOX, "t")
    assert port.bin_query("t", "EXCLUDE") == b""


# -- attribute-level visibility ------------------------------------------------

ATTR_SPEC = ("name:String,age:Integer,dtg:Date,*geom:Point;"
             "geomesa.visibility.level='attribute'")


def _attr_pair():
    rng = np.random.default_rng(17)
    n = 400
    labels = ["admin,,,", ",admin,,", "admin,admin,admin,admin", ",,,",
              None, "admin|ops,ops,,", ",,admin&ops,"]
    vis = [labels[i] for i in rng.integers(0, len(labels), n)]
    data = {"name": [f"p{i % 13}" for i in range(n)],
            "age": rng.integers(0, 90, n),
            "dtg": rng.integers(MS("2017-01-01"), MS("2017-02-01"), n),
            "geom": (rng.uniform(-20, 20, n), rng.uniform(-20, 20, n))}
    out = []
    for ds, parse in ((InMemoryDataStore(device="cpu"), parse_spec),
                      (JaxStore(), jparse_spec)):
        ds.create_schema(parse("t", ATTR_SPEC))
        ds.write_dict("t", [f"a{i}" for i in range(n)], data,
                      visibilities=vis)
        out.append(ds)
    return out


@pytest.mark.parametrize("auths", [[], ["admin"], ["ops"], ["admin", "ops"]])
@pytest.mark.parametrize("ecql,sort_by", [
    ("INCLUDE", None),
    ("name = 'p3'", None),           # the leak guard: name may be hidden
    ("age < 40", "age"),             # hidden sort keys sort as null
    ("BBOX(geom, -10, -10, 10, 10) AND age >= 20", "name"),
    ("dtg DURING 2017-01-05T00:00:00Z/2017-01-20T00:00:00Z", "dtg")])
def test_attribute_visibility(auths, ecql, sort_by):
    port, ref = _attr_pair()
    q = Query("t", ecql, auths=auths, sort_by=sort_by)
    got, want = _same(port, ref, q)
    # redacted cells read as null, in the same places
    assert _features(got) == _features(want)


def test_attribute_visibility_leak_guard():
    port, ref = _attr_pair()
    for auths in ([], ["admin"]):
        q = Query("t", "name = 'p3'", auths=auths)
        got, _ = _same(port, ref, q)
        if not auths:
            assert all(f["name"] == "p3" for f in got.features())


# -- sampling, sorting over nulls, batched, write_many -------------------------

@pytest.mark.parametrize("by", ["name", "val", "dtg"])
@pytest.mark.parametrize("rate", [0.05, 0.3])
def test_sample_by(pair, by, rate):
    port, ref = pair
    _same(port, ref, Query("t", BBOX, hints={QueryHints.SAMPLING: rate,
                                             QueryHints.SAMPLE_BY: by}))


NULL_SPEC = "s:String,i:Integer,d:Double,t:Date,*geom:Point"


def _null_pair():
    rng = np.random.default_rng(3)
    n = 300
    s = [None if i % 7 == 0 else f"k{i % 11}" for i in range(n)]
    i_ = [None if i % 5 == 0 else int(v) for i, v in
          enumerate(rng.integers(-50, 50, n))]
    d = rng.uniform(-5, 5, n)
    d[::6] = np.nan
    t = [None if i % 9 == 0 else int(v) for i, v in
         enumerate(rng.integers(MS("2018-01-01"), MS("2018-02-01"), n))]
    out = []
    for ds, parse in ((InMemoryDataStore(device="cpu"), parse_spec),
                      (JaxStore(), jparse_spec)):
        ds.create_schema(parse("nl", NULL_SPEC))
        ds.write_dict("nl", [f"r{k}" for k in range(n)], {
            "s": s, "i": i_, "d": d, "t": t,
            "geom": (rng.uniform(-1, 1, n) * 0 + np.linspace(-9, 9, n),
                     np.linspace(-4, 4, n))})
        out.append(ds)
    return out


@pytest.mark.parametrize("key", ["s", "i", "d", "t"])
@pytest.mark.parametrize("desc", [False, True])
def test_sort_desc_with_nulls(key, desc):
    port, ref = _null_pair()
    got, want = _same(port, ref, Query("nl", "INCLUDE", sort_by=key,
                                       sort_desc=desc, max_features=120))
    assert _features(got) == _features(want)


def test_query_batched_post_scan(pair):
    port, ref = pair
    _vis_write(port, parse_spec, FeatureBatch)
    _vis_write(ref, jparse_spec, JFeatureBatch)
    qs = [Query("t", BBOX, sort_by="val", sort_desc=True, max_features=40),
          Query("t", "BBOX(geom, -100, -50, 0, 10) AND dtg DURING "
                "2019-01-10T00:00:00Z/2019-02-10T00:00:00Z",
                hints={QueryHints.SAMPLING: 0.2}),
          Query("t", "BBOX(geom, 0, 0, 90, 60)", properties=["val"],
                hints={QueryHints.SAMPLING: 0.3,
                       QueryHints.SAMPLE_BY: "name"}),
          Query("vis", "BBOX(geom, -45, -30, 45, 30)", auths=["admin"]),
          Query("vis", "BBOX(geom, -90, -45, 0, 45)", auths=[]),
          Query("t", "name = 'n2'", sort_by="dtg")]
    got = port.query_batched(qs)
    want = ref.query_batched([_jq(q) for q in qs])
    for q, g, w in zip(qs, got, want):
        assert _ids(g) == _ids(w)
        assert _ids(g) == _ids(port.query(q))
        assert _features(g) == _features(w)
    assert "Fused" in got[0].explain.text and "Fused" in got[3].explain.text


def test_write_many(pair):
    port, ref = pair
    for s, parse, fb in ((port, parse_spec, FeatureBatch),
                         (ref, jparse_spec, JFeatureBatch)):
        s.create_schema(parse("wm", SPEC))
        sft = s.get_schema("wm")
        pairs = []
        for k in range(3):
            ids = [f"w{k}_{i}" for i in range(5)]
            b = fb.from_dict(sft, ids, {
                "name": [f"n{i}" for i in range(5)], "val": list(range(5)),
                "dtg": [MS("2019-01-02")] * 5,
                "geom": (np.arange(5.0) + k, np.arange(5.0))})
            pairs.append((b, None if k == 1 else ["admin"] * 5))
        s.write_many("wm", pairs)
    for auths in ([], ["admin"]):
        _same(port, ref, Query("wm", "INCLUDE", auths=auths))
    assert port.count("wm") == 15


# -- the residual path after a delete ------------------------------------------

RESIDUAL_QUERIES = [
    # dense candidates: the residual program over every row
    "BBOX(geom, -170, -80, 170, 80) AND val > 30",
    # fullscan attributes only
    "val >= 10 AND val < 70",
    # an attribute index whose bounds are too wide
    "name >= 'n2'",
]


@pytest.mark.parametrize("ecql", RESIDUAL_QUERIES)
def test_residual_after_delete_and_recreate(pair, ecql):
    """The residual's device columns are uploaded again after a delete
    (and after remove_schema + create_schema of the same name), possibly
    at addresses a prepared launch was keyed on; the answers stay the
    JAX store's."""
    port, ref = pair
    got, _ = _same(port, ref, Query("t", ecql))
    assert "Device residual scan" in got.explain.text \
        or "too wide" in got.explain.text
    for s in pair:
        s.delete("t", [f"f{i}" for i in range(1, N, 4)])
    _same(port, ref, Query("t", ecql))
    for s in pair:
        s.remove_schema("t")
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        rng = np.random.default_rng(77)
        s.create_schema(parse("t", SPEC))
        s.write_dict("t", [f"h{i}" for i in range(N)], {
            "name": [f"n{(i * 7) % 10}" for i in range(N)],
            "val": rng.integers(0, 100, N),
            "dtg": rng.integers(MS("2019-01-01"), MS("2019-03-01"), N),
            "geom": (rng.uniform(-180, 180, N), rng.uniform(-90, 90, N))})
    _same(port, ref, Query("t", ecql))


# -- stats and Arrow on the contract battery's rows ----------------------------

def test_arrow_ipc_roundtrip(pair):
    """The contract case on the port, its payload also read by the JAX
    package's reader, and the JAX store's by the port's."""
    pytest.importorskip("pyarrow")
    from geomesa_tpu.arrow.io import FeatureArrowFileReader as JReader
    from geomesa_tpu_torch.arrow.io import FeatureArrowFileReader
    port, ref = pair
    payload = port.arrow_ipc("t", BBOX, sort_by="dtg")
    batch = FeatureArrowFileReader(payload, port.get_schema("t")).read_all()
    res = port.query(BBOX, "t")
    assert set(np.asarray(batch.ids).astype(str)) == set(
        res.ids.astype(str))
    ms = batch.col("dtg").millis
    assert np.all(np.diff(ms) >= 0)
    jbatch = JReader(payload, ref.get_schema("t")).read_all()
    assert list(jbatch.ids) == list(batch.ids)
    assert np.array_equal(jbatch.col("dtg").millis, ms)
    back = FeatureArrowFileReader(ref.arrow_ipc("t", BBOX, sort_by="dtg"))
    assert list(back.read_all().ids) == list(batch.ids)


@pytest.mark.parametrize("spec", ["Count()", "MinMax(val)",
                                  "Enumeration(name)", "TopK(name,4)",
                                  "Histogram(val,10,0,100)",
                                  "GroupBy(name,MinMax(dtg))"])
@pytest.mark.parametrize("ecql", [None, BBOX, "name = 'n3' AND val > 20"])
def test_stats_query(pair, spec, ecql):
    port, ref = pair
    assert port.stats_query("t", spec, ecql).to_json() == \
        ref.stats_query("t", spec, ecql).to_json()


def test_query_stream(pair):
    port, ref = pair
    q = Query("t", BBOX, sort_by="dtg")
    wins = list(port.query_stream(q, batch_rows=64))
    assert [str(i) for w in wins for i in w.ids] == _ids(port.query(q))
    assert [w.n for w in wins] == [w.n for w in ref.query_stream(
        _jq(q), batch_rows=64)]


@pytest.mark.parametrize("ecql", ["name = 'n3'", BBOX + " AND name = 'n3'",
                                  "BBOX(geom, 0, 0, 1, 1) AND name = 'n3'"])
def test_plans_follow_stats_after_delete_and_analyze(pair, ecql):
    """Both stores plan the same strategy at the same cost from their
    stats, stale after a delete and fresh after analyze."""
    port, ref = pair

    def plans():
        got, want = port.query(ecql, "t"), ref.query(ecql, "t")
        assert list(got.ids) == list(want.ids)
        return (got.plan.index, got.plan.cost), (want.plan.index,
                                                 want.plan.cost)
    a, b = plans()
    assert a == b
    for s in pair:
        s.delete("t", [f"f{i}" for i in range(N) if i % 10 == 3])
    a, b = plans()
    assert a == b
    for s in pair:
        assert s.analyze("t").count.count == N - N // 10
    a, b = plans()
    assert a == b


# -- the remote case: the port's client over the port's server -------------------
# (tests/test_datastore_contract.py runs its battery on a "remote" store:
# a web server fronting a local store, reached through the HTTP client)

@pytest.fixture
def remote_pair():
    """(the port's RemoteDataStore over a GeoMesaWebServer fronting a CPU
    store, the JAX store), the same rows written through each."""
    from geomesa_tpu_torch.store import RemoteDataStore
    from geomesa_tpu_torch.web import GeoMesaWebServer
    server = GeoMesaWebServer(InMemoryDataStore(device="cpu")).start()
    try:
        yield (_populate(RemoteDataStore("127.0.0.1", server.port)),
               _populate(JaxStore(), parse=jparse_spec))
    finally:
        server.stop()


def _same_remote(remote, ref, q: Query):
    got, want = remote.query(q), ref.query(_jq(q))
    assert _ids(got) == _ids(want)
    assert _features(got) == _features(want)
    assert remote.query_count(q) == ref.query_count(_jq(q)) == got.n
    return got


REMOTE_QUERIES = [
    Query("t", "INCLUDE"), Query("t", BBOX),
    Query("t", BBOX + " AND dtg DURING "
               "2019-01-10T00:00:00Z/2019-02-10T00:00:00Z"),
    Query("t", "name = 'n3'"), Query("t", "val > 40 AND val < 60"),
    Query("t", BBOX, sort_by="val", sort_desc=True, max_features=25),
    Query("t", BBOX, sort_by="name", max_features=25),
    Query("t", "name = 'n3'", properties=["dtg", "name"]),
    Query("t", BBOX, hints={QueryHints.SAMPLING: 0.25}),
    Query("t", BBOX, hints={QueryHints.SAMPLING: 0.3,
                            QueryHints.SAMPLE_BY: "name"}),
]


def test_remote_is_spi_instance(remote_pair):
    from geomesa_tpu_torch.store.api import DataStore
    remote, ref = remote_pair
    assert isinstance(remote, DataStore)
    sft = remote.get_schema("t")
    assert sft.geom_field == "geom" and sft.dtg_field == "dtg"
    assert remote.get_type_names() == ref.get_type_names() == ["t"]
    assert remote.count("t") == ref.count("t") == N


@pytest.mark.parametrize("i", range(len(REMOTE_QUERIES)))
def test_remote_query(remote_pair, i):
    _same_remote(*remote_pair, REMOTE_QUERIES[i])


@pytest.mark.parametrize("ecql", ["INCLUDE", BBOX, "name = 'n3'"])
def test_remote_delete(remote_pair, ecql):
    remote, ref = remote_pair
    victims = [f"f{i}" for i in range(0, 100)] + ["f2500", "nope"]
    for s in remote_pair:
        s.delete("t", victims)
    assert remote.count("t") == ref.count("t") == N - 101
    got = _same_remote(remote, ref, Query("t", ecql))
    assert not set(victims) & set(_ids(got))


def test_remote_remove_schema(remote_pair):
    remote, ref = remote_pair
    for s, parse in ((remote, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("gone", "v:Integer,*geom:Point"))
        s.write_dict("gone", ["a"], {"v": [1], "geom": ([0.0], [0.0])})
        s.remove_schema("gone")
        with pytest.raises(KeyError):
            s.get_schema("gone")
    assert remote.get_type_names() == ref.get_type_names()


@pytest.mark.parametrize("auths", [[], ["admin"], ["admin", "ops"], None])
def test_remote_visibilities(remote_pair, auths):
    remote, ref = remote_pair
    _vis_write(remote, parse_spec, FeatureBatch)
    _vis_write(ref, jparse_spec, JFeatureBatch)
    _same_remote(remote, ref, Query("vis", "INCLUDE", auths=auths))
    assert remote.count("vis") == 40


@pytest.mark.parametrize("kwargs", [
    {}, {"sort": True}, {"track": "val", "label": "dtg", "sort": True}])
def test_remote_bin_output(remote_pair, kwargs):
    remote, ref = remote_pair
    assert remote.bin_query("t", BBOX, **kwargs) == \
        ref.bin_query("t", BBOX, **kwargs)


@pytest.mark.parametrize("spec", ["Count()", "MinMax(val)", "TopK(name,4)"])
def test_remote_stats_query(remote_pair, spec):
    remote, ref = remote_pair
    assert remote.stats_query("t", spec, BBOX) == json.loads(
        ref.stats_query("t", spec, BBOX).to_json())


def test_remote_stream_and_arrow(remote_pair):
    remote, ref = remote_pair
    q = Query("t", BBOX, sort_by="dtg")
    wins = list(remote.query_stream(q, batch_rows=64))
    assert [str(i) for w in wins for i in w.ids] == _ids(ref.query(_jq(q)))
    assert remote.arrow_ipc("t", BBOX, sort_by="dtg") == \
        ref.arrow_ipc("t", BBOX, sort_by="dtg")
