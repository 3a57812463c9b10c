"""The port's processes (analytics/processes.py), its tube builder and
QueryBatcher.knn against the JAX package's, on a port store on the CPU
beside a JAX store holding the same seeded rows.

Tolerance: exact. Ids are equal in the same order, distances and
counts are equal arrays, process outputs (segments, labels, hashes,
BIN and Arrow bytes, per-feature geometries, geohashes and their cells)
are equal."""

import threading

import numpy as np
import pytest

from geomesa_tpu.analytics import processes as jp
from geomesa_tpu.analytics.tube import TubeBuilder as JTubeBuilder
from geomesa_tpu.geometry import parse_wkt as jwkt
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.analytics import processes as tp
from geomesa_tpu_torch.analytics import tube
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan.batcher import KNN_BATCH, QueryBatcher

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731


def _both(spec, type_name, ids, data):
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s in (port, ref):
        s.create_schema(type_name, spec)
        s.write_dict(type_name, ids, data)
    return port, ref


@pytest.fixture(scope="module")
def pts():
    """30k points (test_analytics.py's process store) with duplicated
    coordinates for distance ties."""
    rng = np.random.default_rng(20)
    n = 30_000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    x[500:600], y[500:600] = x[:100], y[:100]
    return _both("kind:String,dtg:Date,*geom:Point:srid=4326", "pts",
                 [f"x{i}" for i in range(n)],
                 {"kind": [f"k{i % 5}" for i in range(n)],
                  "dtg": rng.integers(MS("2017-01-01"), MS("2017-01-10"), n),
                  "geom": (x, y)})


@pytest.fixture(scope="module")
def trk():
    """Two boats moving east (test_processes2.py), with a line attribute
    and a polygon attribute for the per-feature processes."""
    n = 10
    lines = [f"LINESTRING({i} 0, {i + 1} 1, {i + 2} 0)" for i in range(2 * n)]
    polys = [f"POLYGON(({i} 0, {i + 1} 0, {i + 1} 1, {i} 0))"
             for i in range(2 * n)]
    lines[3] = polys[4] = None
    data = {
        "boat": ["a"] * n + ["b"] * n,
        "label": [f"L{i}" for i in range(2 * n)],
        "dtg": np.concatenate([np.arange(n) * 60_000 + MS("2022-01-01")] * 2),
        "geom": (np.concatenate([np.arange(n) * 1.0] * 2),
                 np.concatenate([np.zeros(n), np.full(n, 10.0)])),
    }
    spec = ("boat:String,label:String,route:LineString,area:Polygon,"
            "dtg:Date,*geom:Point:srid=4326")
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_wkt), (ref, jwkt)):
        s.create_schema("trk", spec)
        s.write_dict("trk", [f"t{i}" for i in range(2 * n)], {
            **data, "route": [None if w is None else parse(w) for w in lines],
            "area": [None if w is None else parse(w) for w in polys]})
    return port, ref


def _same(got, want):
    assert list(np.asarray(got[0]).astype(str)) == \
        list(np.asarray(want[0]).astype(str))
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("qx,qy,k", [(0.0, 0.0, 100), (9.9, -9.9, 17),
                                     (120.0, 40.0, 25), (0.0, 0.0, 1),
                                     (0.0, 0.0, 0), (3.3, 4.4, 5000)])
def test_knn_process_scalar(pts, qx, qy, k):
    """The z-ring host tier (queries outside the data force doublings)."""
    port, ref = pts
    _same(tp.knn_process(port, "pts", qx, qy, k),
          jp.knn_process(ref, "pts", qx, qy, k))


def test_knn_process_arrays_and_filter(pts):
    port, ref = pts
    qx, qy = np.array([10.0, -120.0, 0.0, 5.0]), np.array([10.0, 40.0, 0.0, 5.0])
    got = tp.knn_process(port, "pts", qx, qy, 20)
    want = jp.knn_process(ref, "pts", qx, qy, 20)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)
    _same(tp.knn_process(port, "pts", 0.0, 0.0, 10, ecql="kind = 'k1'"),
          jp.knn_process(ref, "pts", 0.0, 0.0, 10, ecql="kind = 'k1'"))
    for g, w in zip(tp.knn_batch_process(port, "pts", [0.0, 3.0], [0.0, 1.0],
                                         10, ecql="BBOX(geom, -5, -5, 5, 5)"),
                    jp.knn_batch_process(ref, "pts", [0.0, 3.0], [0.0, 1.0],
                                         10, ecql="BBOX(geom, -5, -5, 5, 5)")):
        _same(g, w)
    assert tp.knn_process(port, "pts", 0.0, 0.0, 10,
                          ecql="kind = 'none'")[0].size == 0


def test_knn_process_fewer_than_k():
    port, ref = _both("*geom:Point", "few", ["a", "b"],
                      {"geom": ([0.0, 5.0], [0.0, 5.0])})
    _same(tp.knn_process(port, "few", 1.0, 1.0, 10),
          jp.knn_process(ref, "few", 1.0, 1.0, 10))


def test_contains_and_proximity_processes(pts):
    port, ref = pts
    wkts = ["POLYGON((0 0, 10 0, 5 10, 0 0))",
            "POLYGON((-8 -8, -2 -8, -2 -2, -8 -2, -8 -8), "
            "(-6 -6, -4 -6, -4 -4, -6 -4, -6 -6))",
            "POLYGON((100 100, 101 100, 101 101, 100 101, 100 100))"]
    for co in (True, False):
        got = tp.contains_process(port, "pts", [parse_wkt(w) for w in wkts],
                                  counts_only=co)
        want = jp.contains_process(ref, "pts", [jwkt(w) for w in wkts],
                                   counts_only=co)
        assert np.array_equal(got[0], want[0])
        if co:
            assert got[1] is None and want[1] is None
        else:
            for g, w in zip(got[1], want[1]):
                assert list(g) == list(w)
        got = tp.proximity_process(port, "pts", [0.0, 4.0], [0.0, -3.0], 1.0,
                                   counts_only=co)
        want = jp.proximity_process(ref, "pts", [0.0, 4.0], [0.0, -3.0], 1.0,
                                    counts_only=co)
        assert np.array_equal(got[0], want[0])
        if not co:
            assert list(got[1]) == list(want[1])


def test_stats_processes(pts):
    port, ref = pts
    assert tp.unique_process(port, "pts", "kind") == \
        jp.unique_process(ref, "pts", "kind")
    assert tp.minmax_process(port, "pts", "dtg", "kind = 'k2'") == \
        jp.minmax_process(ref, "pts", "dtg", "kind = 'k2'")


def test_query_sampling_and_join_processes(trk):
    port, ref = trk
    for ecql in ("boat = 'a'", "INCLUDE"):
        assert list(tp.query_process(port, "trk", ecql).ids) == \
            list(jp.query_process(ref, "trk", ecql).ids)
    assert list(tp.sampling_process(port, "trk", rate=0.5).ids) == \
        list(jp.sampling_process(ref, "trk", rate=0.5).ids)
    assert list(tp.sampling_process(port, "trk", rate=0.3, by="boat").ids) \
        == list(jp.sampling_process(ref, "trk", rate=0.3, by="boat").ids)
    for args in (("boat",), ("boat", None, "label = 'L3'"),
                 ("label", "label", "label = 'nope'")):
        assert list(tp.join_process(port, "trk", "trk", *args).ids) == \
            list(jp.join_process(ref, "trk", "trk", *args).ids)


def test_join_process_escapes_quotes():
    port, ref = _both("name:String,*geom:Point:srid=4326", "p", ["a", "b"],
                      {"name": ["O'Brien", "Smith"],
                       "geom": (np.array([0.0, 1.0]), np.array([0.0, 1.0]))})
    got = tp.join_process(port, "p", "p", "name", ecql="name = 'O''Brien'")
    want = jp.join_process(ref, "p", "p", "name", ecql="name = 'O''Brien'")
    assert list(got.ids) == list(want.ids) == ["a"]


def test_track_processes(trk):
    port, ref = trk
    got = tp.point2point_process(port, "trk", "boat")
    want = jp.point2point_process(ref, "trk", "boat")
    assert set(got) == set(want) == {"a", "b"}
    for g in got:
        assert np.array_equal(got[g], want[g])
    assert tp.track_label_process(port, "trk", "boat", "label") == \
        jp.track_label_process(ref, "trk", "boat", "label")


@pytest.mark.parametrize("route,buffer", [(([0.0, 9.0], [0.0, 0.0]), 0.5),
                                          (([0.0], [0.0]), 1.5),
                                          (([0.0, 4.0, 4.0], [0.0, 5.0, 10.0]),
                                           0.8)])
def test_route_search_process(trk, route, buffer):
    port, ref = trk
    for ecql in (None, "boat = 'a'"):
        got = tp.route_search_process(port, "trk", *route, buffer_deg=buffer,
                                      ecql=ecql)
        want = jp.route_search_process(ref, "trk", *route, buffer_deg=buffer,
                                       ecql=ecql)
        assert list(got) == list(want)


def test_hash_and_conversion_processes(trk):
    port, ref = trk
    assert np.array_equal(tp.hash_attribute_process(port, "trk", "boat", 4),
                          jp.hash_attribute_process(ref, "trk", "boat", 4))
    got = tp.bin_conversion_process(port, "trk", "boat = 'a'", track="boat",
                                    label="label")
    assert got == jp.bin_conversion_process(ref, "trk", "boat = 'a'",
                                            track="boat", label="label")
    assert len(got) == 10 * 24   # labelled records, 24 bytes each
    assert tp.arrow_conversion_process(port, "trk", "boat = 'b'") == \
        jp.arrow_conversion_process(ref, "trk", "boat = 'b'")


def test_arrow_conversion_empty():
    import pyarrow as pa
    port, ref = _both("name:String,*geom:Point:srid=4326", "e", [],
                      {"name": [], "geom": (np.empty(0), np.empty(0))})
    out = tp.arrow_conversion_process(port, "e")
    assert pa.ipc.open_stream(out).read_all().num_rows == 0
    assert out == jp.arrow_conversion_process(ref, "e")


@pytest.mark.parametrize("name,args", [
    ("length_spheroid_process", ("route",)),
    ("point_n_process", ("route", 2)),
    ("exterior_ring_process", ("area",)),
    ("num_points_process", ("route",)),
    ("translate_process", ("area", 1.5, -2.0)),
    ("idl_safe_geom_process", ("route",)),
])
def test_per_feature_processes(trk, name, args):
    port, ref = trk
    for ecql in (None, "boat = 'b'"):
        got = getattr(tp, name)(port, "trk", *args, ecql=ecql)
        want = getattr(jp, name)(ref, "trk", *args, ecql=ecql)
        assert len(got) == len(want) and got.dtype == want.dtype
        for g, w in zip(got, want):
            if isinstance(w, float):
                assert g == w or (np.isnan(g) and np.isnan(w))
            else:
                assert (g is None and w is None) or str(g) == str(w) or g == w


@pytest.mark.parametrize("qx,qy,k,est", [(0.0, 0.0, 10, 1.0),
                                         (9.9, -9.9, 17, 0.3),
                                         (2.2, 7.7, 40, 0.05),
                                         (20.0, 20.0, 3, 5.0)])
def test_knn_spiral_process(pts, qx, qy, k, est):
    """The geohash spiral: one BBOX query per cell through the store."""
    port, ref = pts
    _same(tp.knn_spiral_process(port, "pts", qx, qy, k,
                                estimated_distance=est),
          jp.knn_spiral_process(ref, "pts", qx, qy, k,
                                estimated_distance=est))


@pytest.mark.parametrize("prec", [1, 5, 12, 25, 32, 45])
@pytest.mark.parametrize("attribute,ecql", [("geom", None),
                                            ("route", "boat = 'a'"),
                                            ("area", None)])
def test_geohash_process(trk, attribute, ecql, prec):
    """Per-feature hashes (a null geometry gives None; a line or polygon
    hashes its centroid)."""
    port, ref = trk
    got = tp.geohash_process(port, "trk", attribute, prec=prec, ecql=ecql)
    want = jp.geohash_process(ref, "trk", attribute, prec=prec, ecql=ecql)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert tp.geohash_process(port, "trk", "geom",
                              ecql="boat = 'none'").tolist() == []


@pytest.mark.parametrize("prec", [None, 1, 8, 13, 25, 30])
def test_geohash_decode_process(prec):
    from geomesa_tpu.geometry import to_wkt as jto_wkt
    from geomesa_tpu_torch.geometry import to_wkt
    hashes = ["9q8yy", "u60g0", "s", None, "ezs42e44", "zzzzzz"]
    got = tp.geohash_decode_process(hashes, prec)
    want = jp.geohash_decode_process(hashes, prec)
    assert [None if g is None else to_wkt(g) for g in got] == \
        [None if g is None else jto_wkt(g) for g in want]


@pytest.mark.parametrize("bin_millis,max_bins", [(86_400_000, 256),
                                                 (3_600_000, 4),
                                                 (60_000, 256)])
def test_tube_builder_matches_reference(bin_millis, max_bins):
    rng = np.random.default_rng(bin_millis % 97)
    x = np.linspace(-9, 9, 12) + rng.normal(0, 0.1, 12)
    y = rng.uniform(-1, 1, 12)
    ms = np.sort(rng.integers(MS("2017-01-01"), MS("2017-01-09"), 12))[::-1]
    got = tube.TubeBuilder(0.5, bin_millis, max_bins).build(x, y, ms)
    want = JTubeBuilder(0.5, bin_millis, max_bins).build(x, y, ms)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# -- QueryBatcher.knn --------------------------------------------------------

QS = [(float(a), float(b)) for a, b in
      zip(np.random.default_rng(3).uniform(-9, 9, 8),
          np.random.default_rng(4).uniform(-9, 9, 8))]


def test_batcher_knn_coalesces_and_is_exact(pts):
    """Eight callers on one (type, k) coalesce into batched top-k calls;
    every caller gets the JAX knn_process's ids and distances."""
    port, ref = pts
    qb = QueryBatcher(port, max_batch=8, linger_us=200_000, adaptive=False)
    out = [None] * len(QS)
    # a dispatch in flight makes the leader linger for followers
    qb._in_flight = 1
    ts = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, qb.knn("pts", QS[i][0], QS[i][1], 12))) for i in range(len(QS))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    qb._in_flight = 0
    for (qx, qy), got in zip(QS, out):
        _same(got, jp.knn_process(ref, "pts", qx, qy, 12))
    s = qb.stats()
    assert s["total_queries"] == 8 and s["coalesced_queries"] > 0
    assert s["batches"] < 8


def test_batcher_knn_knob_disables_coalescing(pts, monkeypatch):
    port, ref = pts
    qb = QueryBatcher(port, max_batch=8)
    monkeypatch.setenv("GEOMESA_KNN_BATCH", "false")
    assert KNN_BATCH.get() == "false"
    got = qb.knn("pts", 1.0, 2.0, 5)
    _same(got, jp.knn_process(ref, "pts", 1.0, 2.0, 5))
    assert qb._queues == {} and qb.stats()["coalesced_queries"] == 0


def test_batcher_knn_replays_failures_per_caller(pts, monkeypatch):
    """A failed batched call replays each caller alone through the
    batched call: the caller whose query breaks it gets the error, the
    others their answers, and no caller is answered by the host z-ring;
    a call that fails for every caller fails every caller."""
    port, ref = pts
    qb = QueryBatcher(port, max_batch=4, linger_us=200_000, adaptive=False)
    real = tp.knn_batch_process
    poison = QS[1]

    def fails_on_poison(store, type_name, qx, qy, k, ecql=None):
        if poison[0] in list(qx):
            raise RuntimeError("batched call failed")
        return real(store, type_name, qx, qy, k, ecql=ecql)

    def no_host_tier(*a, **k):
        raise AssertionError("the host z-ring answered a replayed caller")
    monkeypatch.setattr(tp, "knn_batch_process", fails_on_poison)
    monkeypatch.setattr(tp, "_knn_zring", no_host_tier)
    from geomesa_tpu_torch.scan.batcher import _Pending
    chunk = [_Pending(q) for q in QS[:3]]
    qb._dispatch_knn("pts", 7, chunk)
    for p, (qx, qy) in zip(chunk, QS[:3]):
        if (qx, qy) == poison:
            with pytest.raises(RuntimeError, match="batched call failed"):
                p.get()
        else:
            _same(p.get(), jp.knn_process(ref, "pts", qx, qy, 7))

    def boom(*a, **k):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(tp, "knn_batch_process", boom)
    chunk = [_Pending(q) for q in QS[:3]]
    qb._dispatch_knn("pts", 7, chunk)
    for p in chunk:
        with pytest.raises(RuntimeError, match="kernel failed"):
            p.get()


# -- the ingest hook --------------------------------------------------------

def test_ingest_prewarm_hook_respects_knob(monkeypatch):
    from geomesa_tpu_torch.analytics import join as tj
    from geomesa_tpu_torch.store import memory as mem
    rng = np.random.default_rng(5)
    n = 3000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    calls = []
    monkeypatch.setattr(tj, "prewarm_join_kernels",
                        lambda *a, **k: calls.append(k))
    monkeypatch.setattr(mem.InMemoryDataStore, "_EAGER_INDEX_ROWS", 1000)
    ds = InMemoryDataStore(device="cpu")
    ds.create_schema("pw", "*geom:Point:srid=4326")
    monkeypatch.setenv("GEOMESA_JOIN_PREWARM", "false")
    ds.write_dict("pw", [str(i) for i in range(n)], {"geom": (x, y)})
    monkeypatch.delenv("GEOMESA_JOIN_PREWARM")
    assert mem.JOIN_PREWARM.get() == "true"
    assert not calls and ds._state("pw").scan_data is not None
    ds2 = InMemoryDataStore(device="cpu")
    ds2.create_schema("pw", "*geom:Point:srid=4326")
    ds2.write_dict("pw", [str(i) for i in range(n)], {"geom": (x, y)})
    sd = ds2._state("pw").scan_data
    assert len(calls) == 1 and calls[0]["device_xy"][0] is sd.xhi
    ds2.write_dict("pw", ["more"], {"geom": ([0.0], [0.0])})
    assert len(calls) == 1   # only the first bulk write of a type
