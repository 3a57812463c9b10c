"""The port's Arrow interchange against the JAX package on the CPU:
FeatureBatch.to_arrow/from_arrow, StringColumn.from_arrow, the vectors,
the IPC file writer and reader, the delta stream, ArrowScan and
merge_deltas, ArrowDataStore, and the store's arrow_ipc, arrow_query and
query_stream, on the same seeded rows.

Tolerance: exact -- ids in order, every column's validity and values,
and the encoded bytes (each package's payloads are byte for byte the
other's)."""

import io

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from geomesa_tpu.arrow import delta as jdelta, io as jio  # noqa: E402
from geomesa_tpu.arrow.scan import merge_deltas as jmerge_deltas  # noqa: E402
from geomesa_tpu.arrow.vector import (  # noqa: E402
    SimpleFeatureVector as JVector)
from geomesa_tpu.features import parse_spec as jparse_spec  # noqa: E402
from geomesa_tpu.features.batch import (  # noqa: E402
    FeatureBatch as JFeatureBatch, StringColumn as JStringColumn)
from geomesa_tpu.index.api import Query as JQuery  # noqa: E402
from geomesa_tpu.store import InMemoryDataStore as JaxStore  # noqa: E402
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query  # noqa: E402
from geomesa_tpu_torch import parse_spec  # noqa: E402
from geomesa_tpu_torch.arrow import (  # noqa: E402
    ArrowDataStore, ArrowDictionary, SimpleFeatureVector, delta, io as aio)
from geomesa_tpu_torch.arrow.scan import merge_deltas  # noqa: E402
from geomesa_tpu_torch.features.batch import StringColumn  # noqa: E402
from geomesa_tpu_torch.geometry import Point  # noqa: E402

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731

SPEC = ("name:String:index=true,val:Integer,score:Double,flag:Boolean,"
        "big:Long,dtg:Date,*geom:Point:srid=4326")
N = 2_500
BBOX = "BBOX(geom, -60, -30, 60, 30)"


def _data(n=N, seed=31, lo=0):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.04):
        out = list(vals)
        for i in np.flatnonzero(rng.random(n) < p):
            out[i] = None
        return out
    return [f"f{i}" for i in range(lo, lo + n)], {
        "name": nulls([f"n{i}" for i in rng.integers(0, 25, n)]),
        "val": nulls(rng.integers(0, 100, n).tolist()),
        "score": nulls(rng.normal(0, 3, n).tolist()),
        "flag": nulls((rng.random(n) < 0.5).tolist()),
        "big": nulls(rng.integers(-2**50, 2**50, n).tolist()),
        "dtg": rng.integers(MS("2019-01-01"), MS("2019-03-01"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }


def _batches(n=N, seed=31, lo=0):
    ids, data = _data(n, seed, lo)
    return (FeatureBatch.from_dict(parse_spec("t", SPEC), ids, data),
            JFeatureBatch.from_dict(jparse_spec("t", SPEC), ids, data))


@pytest.fixture(scope="module")
def pair():
    ids, data = _data()
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("t", SPEC))
        s.write_dict("t", ids, data)
    return port, ref


def _same_batch(got, want):
    """Ids in order, and every column's validity and valid values."""
    assert [str(i) for i in got.ids] == [str(i) for i in want.ids]
    for a in got.sft.attributes:
        g, w = got.col(a.name), want.col(a.name)
        gv, wv = np.asarray(g.valid), np.asarray(w.valid)
        assert np.array_equal(gv, wv), a.name
        if a.type.name == "Point":
            assert np.array_equal(g.x[gv], w.x[wv])
            assert np.array_equal(g.y[gv], w.y[wv])
        elif a.type.name == "Date":
            assert np.array_equal(g.millis[gv], w.millis[wv])
        elif a.type.name == "String":
            assert np.array_equal(g.vocab[g.codes[gv]], w.vocab[w.codes[wv]])
        else:
            assert np.array_equal(g.values[gv], w.values[wv]), a.name


def test_batch_to_and_from_arrow():
    pb, jb = _batches()
    rb, jrb = pb.to_arrow(), jb.to_arrow()
    assert rb.equals(jrb)
    _same_batch(FeatureBatch.from_arrow(pb.sft, jrb),
                JFeatureBatch.from_arrow(jb.sft, rb))
    _same_batch(FeatureBatch.from_arrow(pb.sft, rb), pb)


@pytest.mark.parametrize("vals", [
    ["b", "a", "c", "a", "b"], ["z", None, "a", None], [], ["only"]])
def test_string_column_from_arrow(vals):
    arr = pa.array(vals, type=pa.string())
    got, want = StringColumn.from_arrow("s", arr), \
        JStringColumn.from_arrow("s", arr)
    assert np.array_equal(got.codes, want.codes)
    assert list(got.vocab) == list(want.vocab)
    assert all(got.code_of(v) == want.code_of(v) for v in vals if v)


@pytest.mark.parametrize("sort_by", [None, "dtg", "name", "val", "score"])
@pytest.mark.parametrize("ecql", ["INCLUDE", BBOX, "name = 'n3'",
                                  "val > 200"])
def test_arrow_ipc_crosses_packages(pair, ecql, sort_by):
    """Each package's arrow_ipc payload reads back in the other's
    FeatureArrowFileReader to equal ids and values; the payloads are the
    same bytes."""
    port, ref = pair
    data = port.arrow_ipc("t", ecql, sort_by=sort_by)
    jdata = ref.arrow_ipc("t", ecql, sort_by=sort_by)
    assert data == jdata
    got = jio.FeatureArrowFileReader(data, ref.get_schema("t"))
    want = aio.FeatureArrowFileReader(jdata)
    assert want.sft == port.get_schema("t")
    if ref.query_count(ecql, "t") == 0:
        with pytest.raises(ValueError, match="empty"):
            want.read_all()
        return
    _same_batch(want.read_all(), got.read_all())
    res = port.query(ecql, "t")
    ids = [str(i) for i in want.read_all().ids]
    assert sorted(ids) == sorted(str(i) for i in res.ids)
    if sort_by is None:
        assert ids == [str(i) for i in res.ids]


def test_arrow_ipc_roundtrip(pair):
    """The DataStore contract case on the port."""
    port, _ = pair
    payload = port.arrow_ipc("t", BBOX, sort_by="dtg")
    batch = aio.FeatureArrowFileReader(payload,
                                       port.get_schema("t")).read_all()
    assert set(np.asarray(batch.ids).astype(str)) == set(
        port.query(BBOX, "t").ids.astype(str))
    assert np.all(np.diff(batch.col("dtg").millis) >= 0)


def test_arrow_query(pair):
    port, ref = pair
    for ecql in ("INCLUDE", BBOX, "name = 'n1'"):
        assert port.arrow_query("t", ecql).equals(ref.arrow_query("t", ecql))
    empty = InMemoryDataStore(device="cpu")
    empty.create_schema("e", SPEC)
    assert empty.arrow_query("e", "INCLUDE") is None


@pytest.mark.parametrize("rows", [1, 7, 1000, 8192, None])
def test_query_stream_windows(pair, rows):
    """query_stream: windows of ``rows`` rows whose ids, in order, are
    the query's, equal to the JAX store's windows."""
    port, ref = pair
    q = Query("t", BBOX, sort_by="val", sort_desc=True)
    wins = list(port.query_stream(q, batch_rows=rows))
    jwins = list(ref.query_stream(JQuery("t", BBOX, sort_by="val",
                                         sort_desc=True), batch_rows=rows))
    size = rows or 8192
    assert [w.n for w in wins] == [w.n for w in jwins]
    assert all(w.n == size for w in wins[:-1]) and 0 < wins[-1].n <= size
    ids = [str(i) for w in wins for i in w.ids]
    assert ids == [str(i) for i in port.query(q).ids]
    for w, jw in zip(wins, jwins):
        _same_batch(w, jw)
    assert list(port.query_stream("val > 200", "t")) == []


def test_write_read_sort_and_merge_ipc():
    pb, jb = _batches()
    for bs in (100, 8096):
        assert aio.write_ipc(pb.sft, pb, bs) == jio.write_ipc(jb.sft, jb, bs)
    sft, back = aio.read_ipc_batches(aio.write_ipc(pb.sft, pb, 300))
    assert sft == pb.sft
    _same_batch(back, pb)
    for key in ("dtg", "name", "val"):
        for rev in (False, True):
            _same_batch(aio.sort_batches(pb, key, rev),
                        jio.sort_batches(jb, key, rev))
    parts = [_batches(700, s, lo=1000 * s) for s in (1, 2, 3)]
    pays = [aio.write_ipc(p.sft, aio.sort_batches(p, "dtg"), 128)
            for p, _ in parts]
    jpays = [jio.write_ipc(j.sft, jio.sort_batches(j, "dtg"), 128)
             for _, j in parts]
    assert pays == jpays
    assert aio.merge_sorted_ipc(pays, "dtg") == jio.merge_sorted_ipc(
        jpays, "dtg")
    _, merged = aio.read_ipc_batches(aio.merge_sorted_ipc(pays, "dtg"))
    assert np.all(np.diff(merged.col("dtg").millis) >= 0)
    assert merged.n == 2100


@pytest.mark.parametrize("sort_by,presorted", [(None, False), ("dtg", False),
                                               ("dtg", True), ("name", False)])
def test_merge_deltas(sort_by, presorted):
    """merge_deltas of two payloads with their own dictionaries."""
    (pa_, ja), (pb, jb) = _batches(900, 4), _batches(600, 5, lo=5000)
    if presorted:
        pa_, pb = aio.sort_batches(pa_, sort_by), aio.sort_batches(pb, sort_by)
        ja, jb = jio.sort_batches(ja, sort_by), jio.sort_batches(jb, sort_by)
    pays = [aio.write_ipc(b.sft, b) for b in (pa_, pb)]
    jpays = [jio.write_ipc(b.sft, b) for b in (ja, jb)]
    got = merge_deltas(pays, sort_by=sort_by, presorted=presorted)
    want = jmerge_deltas(jpays, sort_by=sort_by, presorted=presorted)
    assert got == want
    _, gb = aio.read_ipc_batches(got)
    _, wb = jio.read_ipc_batches(want)
    _same_batch(gb, wb)
    assert gb.n == 1500
    with pytest.raises(ValueError):
        merge_deltas([])


def test_delta_stream():
    """DeltaWriter / stream_ipc / iter_ipc / reassemble_ipc / stream_bin
    against the JAX package's bytes."""
    pb, jb = _batches(3_000, 8)
    chunks = list(delta.stream_ipc(pb.sft, pb, batch_rows=700))
    assert chunks == list(jdelta.stream_ipc(jb.sft, jb, batch_rows=700))
    stream = b"".join(chunks)
    sft, it = delta.iter_ipc(stream)
    wins = list(it)
    assert sft == pb.sft and [w.n for w in wins] == [700] * 4 + [200]
    _same_batch(FeatureBatch.concat_all(wins), pb)
    _, jit = jdelta.iter_ipc(stream)
    for w, jw in zip(wins, jit):
        _same_batch(w, jw)
    assert delta.reassemble_ipc(pb.sft, wins) == aio.write_ipc(pb.sft, pb)
    assert delta.reassemble_ipc(pb.sft, []) == jdelta.reassemble_ipc(
        jb.sft, [])
    sink = io.BytesIO()
    with delta.DeltaWriter(sink, pb.sft, batch_rows=1000) as w:
        w.write(pb.take(np.arange(1500)))
        w.flush()
        w.write(pb.take(np.arange(1500, 3000)))
    jsink = io.BytesIO()
    with jdelta.DeltaWriter(jsink, jb.sft, batch_rows=1000) as jw:
        jw.write(jb.take(np.arange(1500)))
        jw.flush()
        jw.write(jb.take(np.arange(1500, 3000)))
    assert sink.getvalue() == jsink.getvalue() and w.batches_written == 4
    assert list(delta.stream_bin(pb.sft, pb, batch_rows=1000)) == list(
        jdelta.stream_bin(jb.sft, jb, batch_rows=1000))


def test_vectors_and_features():
    """SimpleFeatureVector write and read sides, ArrowDictionary deltas
    and ArrowFeature, against the JAX package's vectors."""
    sft, jsft = parse_spec("t", SPEC), jparse_spec("t", SPEC)
    _, data = _data(50, 3)
    d = ArrowDictionary(["n1"])
    v = SimpleFeatureVector.create(sft, capacity=64, precision="f32",
                                   dictionaries={"name": d})
    jv = JVector.create(jsft, capacity=64, precision="f32")
    for i in range(50):
        row = {k: (Point(data[k][0][i], data[k][1][i]) if k == "geom"
                   else (int(data[k][i]) if k == "dtg" else data[k][i]))
               for k in data}
        v.set(i, f"r{i}", row)
        jrow = dict(row)
        jrow["geom"] = (row["geom"].x, row["geom"].y)
        jv.set(i, f"r{i}", jrow)
    rb, jrb = v.unload(), jv.unload()
    assert rb.column("geom").equals(jrb.column("geom"))
    for name in ("__fid__", "val", "score", "flag", "big", "dtg"):
        assert rb.column(name).equals(jrb.column(name)), name
    assert rb.column("name").to_pylist() == jrb.column("name").to_pylist()
    assert d.values[0] == "n1" and d.lookup("absent") == -1
    assert d.delta_since(1) == d.values[1:]
    r, jr = SimpleFeatureVector.wrap(sft, rb), JVector.wrap(jsft, rb)
    assert list(r.ids()) == list(jr.ids()) and r.n == 50
    for i in range(50):
        f, jf = r.feature(i).as_dict(), jr.feature(i).as_dict()
        g, jg = f.pop("geom"), jf.pop("geom")
        assert f == jf
        assert (g is None) == (jg is None)
        if g is not None:
            assert (g.x, g.y) == (jg.x, jg.y)
        assert r.reader("val").apply(i) == jr.reader("val").apply(i)
    v.reset()
    assert v.unload().num_rows == 0
    with pytest.raises(ValueError):
        v.reader("val")
    # a Polygon attribute (refused before the extent slice) is a WKB
    # vector, byte for byte the reference's, and reads back as written
    from geomesa_tpu.geometry import parse_wkt as jparse_wkt
    from geomesa_tpu_torch.geometry import parse_wkt
    wkt = "POLYGON ((0 0, 4 0, 4 3, 0 0), (1 0.5, 2 0.5, 2 1, 1 0.5))"
    pv = SimpleFeatureVector.create(parse_spec(
        "x", "g:Polygon,*geom:Point"), capacity=4)
    jpv = JVector.create(jparse_spec("x", "g:Polygon,*geom:Point"),
                         capacity=4)
    pv.set(0, "p0", {"g": parse_wkt(wkt), "geom": Point(1, 2)})
    jpv.set(0, "p0", {"g": jparse_wkt(wkt), "geom": (1.0, 2.0)})
    prb, jprb = pv.unload(), jpv.unload()
    assert prb.column("g").equals(jprb.column("g"))
    back = SimpleFeatureVector.wrap(pv.sft, prb).reader("g").apply(0)
    assert repr(back) == repr(jparse_wkt(wkt))


def test_arrow_data_store(tmp_path):
    """An Arrow file as a queryable store (on the CPU), equal to the
    JAX package's on the same file."""
    from geomesa_tpu.arrow import ArrowDataStore as JArrowDataStore
    pb, jb = _batches(1_200, 6)
    path, jpath = str(tmp_path / "p.arrow"), str(tmp_path / "j.arrow")
    ads, jads = ArrowDataStore(path, device="cpu"), JArrowDataStore(jpath)
    assert not ads.exists
    ads.create_schema(pb.sft)
    jads.create_schema(jb.sft)
    assert ads.count() == 0
    ads.write(pb.take(np.arange(700)))
    ads.write(pb.take(np.arange(700, 1200)))
    jads.write(jb.take(np.arange(700)))
    jads.write(jb.take(np.arange(700, 1200)))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    reopened = ArrowDataStore(path, device="cpu")
    assert reopened.count() == 1200 and reopened.get_schema() == pb.sft
    for ecql in ("INCLUDE", BBOX, "val < 20 AND flag = true"):
        assert list(reopened.query(ecql).ids) == list(jads.query(ecql).ids)
