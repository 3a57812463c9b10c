"""The port's file store (``store/fs.py``, on ``device="cpu"``) against
the JAX package's on the same seeded writes: the cases of
tests/test_fs_store.py's TestFsStore, TestIndexSidecars and
TestFsAttributeVisibility run in both packages with equal answers (ids
in order where the query sorts or both stores read one root's files, as
sets where each package wrote files of its own), the pushdown
expressions, partition directories, sidecar adoption without a z-key
sort, and roots and sidecars written by either package and read by the
other. Tolerance: exact."""

import os
import shutil
import warnings

import numpy as np
import pytest

from geomesa_tpu.features import FeatureBatch as JBatch
from geomesa_tpu.features.sft import parse_spec as jparse
from geomesa_tpu.filters import parse_ecql as jecql
from geomesa_tpu.index import zkeys as jzkeys
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.index.api import QueryHints as JHints
from geomesa_tpu.store import (CompositeScheme as JComposite,
                               DateTimeScheme as JDateTime,
                               FileSystemDataStore as JFs,
                               InMemoryDataStore as JMem,
                               Z2Scheme as JZ2)
from geomesa_tpu.store.fs import _pushdown_expr as jpushdown
from geomesa_tpu_torch import FileSystemDataStore as PkgFs
from geomesa_tpu_torch.features import FeatureBatch
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.index import zkeys
from geomesa_tpu_torch.index.api import Query, QueryHints
from geomesa_tpu_torch.store import (CompositeScheme, DateTimeScheme,
                                     FileSystemDataStore, InMemoryDataStore,
                                     Z2Scheme)
from geomesa_tpu_torch.store.fs import _pushdown_expr

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))
SPEC = "kind:String,dtg:Date,*geom:Point"
ECQL = ("BBOX(geom, -10, -10, 10, 10) AND "
        "dtg DURING 2017-01-02T00:00:00Z/2017-01-05T00:00:00Z")


def _data(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return ([f"e{seed}_{i}" for i in range(n)], {
        "kind": [f"k{i % 4}" for i in range(n)],
        "dtg": rng.integers(MS("2017-01-01"), MS("2017-01-20"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    })


def write_sample(ds, n=5000, seed=0, type_name="events"):
    ids, data = _data(n, seed)
    ds.write_dict(type_name, ids, data)


def _port(path):
    return FileSystemDataStore(str(path), device="cpu")


def _pair(tmp_path, spec=SPEC, name="events", scheme=None, **kw):
    """A JAX store and a port store, each on a root of its own, with the
    same schema (and scheme, a pair of scheme factories)."""
    j, t = JFs(str(tmp_path / "j")), _port(tmp_path / "t")
    j.create_schema(jparse(name, spec), scheme=scheme[0]() if scheme else None)
    t.create_schema(name, spec, scheme=scheme[1]() if scheme else None)
    return j, t


def _ids(res) -> list:
    return [str(i) for i in res.ids.tolist()]


def _xy(res):
    return ([f["geom"].x for f in res.features()],
            [f["geom"].y for f in res.features()])


def _disk_files(root) -> dict:
    """{partition dir: file count} under a type's data/."""
    out = {}
    for dirpath, _d, files in os.walk(root):
        n = sum(f.endswith(".parquet") for f in files)
        if n:
            out[os.path.relpath(dirpath, root)] = n
    return out


def _poison(monkeypatch, mod):
    def boom(*a, **k):
        raise AssertionError("index was re-sorted on reopen")
    for name in ("sort_bin_z", "sort_z", "_native_sort_bin_z"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(mod.np, "lexsort", boom)


# -- TestFsStore's cases, both packages ---------------------------------------

def test_write_query_roundtrip(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    assert t.count("events") == j.count("events") == 5000
    q = ("BBOX(geom, -50, -30, 50, 30) AND "
         "dtg DURING 2017-01-05T00:00:00Z/2017-01-10T00:00:00Z")
    rj, rt = j.query(q, "events"), t.query(q, "events")
    assert rt.n == rj.n > 0
    assert sorted(_ids(rt)) == sorted(_ids(rj))
    assert all(-50 <= x <= 50 for x in _xy(rt)[0])


def test_partition_directories_equal(tmp_path):
    j, t = _pair(tmp_path)
    for seed in (0, 1):
        write_sample(j, n=2000, seed=seed)
        write_sample(t, n=2000, seed=seed)
    assert t.partitions("events") == j.partitions("events")
    assert len(t.partitions("events")) == 19
    assert (_disk_files(tmp_path / "t" / "events" / "data")
            == _disk_files(tmp_path / "j" / "events" / "data"))
    assert sorted(os.listdir(tmp_path / "t" / "events")) == \
        sorted(os.listdir(tmp_path / "j" / "events"))


@pytest.mark.parametrize("ecql,scanned", [
    ("dtg DURING 2017-01-05T00:00:00Z/2017-01-07T00:00:00Z", 3),
    ("dtg DURING 2017-01-05T12:00:00Z/2017-01-05T13:00:00Z", 1),
    ("BBOX(geom, 0, 0, 10, 10)", None),
])
def test_datetime_partition_pruning(tmp_path, ecql, scanned):
    j, t = _pair(tmp_path, scheme=(lambda: JDateTime("daily"),
                                   lambda: DateTimeScheme("daily")))
    write_sample(j)
    write_sample(t)
    assert t.partitions("events")[0] == "2017/01/01"
    oj, ot = [], []
    rj = j.query(JQuery("events", ecql), explain_out=oj.append)
    rt = t.query(Query("events", ecql), explain_out=ot.append)
    assert sorted(_ids(rt)) == sorted(_ids(rj))
    assert ot[-1] == oj[-1]
    want = f"Partitions scanned: {'all' if scanned is None else scanned}"
    assert want in ot[-1]


@pytest.mark.parametrize("q,line", [
    # partitions named, no files under them
    ("dtg DURING 2018-01-05T00:00:00Z/2018-01-07T00:00:00Z",
     "Partitions scanned: 3; files: 0; parquet pushdown: yes"),
    # disjoint intervals: no partition at all
    ("dtg DURING 2017-01-05T00:00:00Z/2017-01-06T00:00:00Z AND "
     "dtg DURING 2017-01-08T00:00:00Z/2017-01-09T00:00:00Z",
     "All partitions pruned"),
])
def test_nothing_to_scan(tmp_path, q, line):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    oj, ot = [], []
    rj = j.query(JQuery("events", q), explain_out=oj.append)
    rt = t.query(Query("events", q), explain_out=ot.append)
    assert rt.n == rj.n == 0 and rt.plan.index == "empty"
    assert ot[-1] == oj[-1] == line


@pytest.mark.parametrize("bits,box", [(2, (100, 40, 110, 50)),
                                      (4, (-20, -20, 20, 20))])
def test_z2_partition_pruning(tmp_path, bits, box):
    j, t = _pair(tmp_path, name="pts", scheme=(lambda: JZ2(bits),
                                               lambda: Z2Scheme(bits)))
    write_sample(j, type_name="pts")
    write_sample(t, type_name="pts")
    q = "BBOX(geom, %s, %s, %s, %s)" % box
    rj, rt = j.query(q, "pts"), t.query(q, "pts")
    full = t.query("INCLUDE", "pts")
    x, y = (np.array(v) for v in _xy(full))
    expect = int(((x >= box[0]) & (x <= box[2])
                  & (y >= box[1]) & (y <= box[3])).sum())
    assert rt.n == rj.n == expect
    assert sorted(_ids(rt)) == sorted(_ids(rj))
    assert t.partitions("pts") == j.partitions("pts")


def test_composite_scheme(tmp_path):
    j, t = _pair(tmp_path, name="c", scheme=(
        lambda: JComposite([JDateTime("monthly"), JZ2(1)]),
        lambda: CompositeScheme([DateTimeScheme("monthly"), Z2Scheme(1)])))
    write_sample(j, type_name="c", n=500)
    write_sample(t, type_name="c", n=500)
    parts = t.partitions("c")
    assert parts == j.partitions("c")
    assert all(len(p.split("/")) == 3 for p in parts)
    q = "BBOX(geom, -10, -10, 10, 10)"
    full = t.query("INCLUDE", "c")
    x, y = (np.array(v) for v in _xy(full))
    expect = int(((x >= -10) & (x <= 10) & (y >= -10) & (y <= 10)).sum())
    assert t.query(q, "c").n == j.query(q, "c").n == expect


def test_parquet_predicate_pushdown(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    ecql = "BBOX(geom, -20, -10, 20, 10) AND kind = 'k1'"
    rj, rt = j.query(ecql, "events"), t.query(ecql, "events")
    loaded_j = next(iter(j._state("events").cache.values()))
    loaded_t = next(iter(t._state("events").cache.values()))
    # pushdown trimmed the scan to the same superset in both
    assert loaded_t.count("events") == loaded_j.count("events") < 5000
    assert loaded_t.count("events") >= rt.n
    full = t._load(t._state("events"), t._files_for(t._state("events"),
                                                      None))
    want = set(_ids(full.query(ecql, "events")))
    assert set(_ids(rt)) == set(_ids(rj)) == want and rt.n > 0


def test_parquet_column_projection(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    rj = j.query(JQuery("events", "kind = 'k2'", properties=["kind"]))
    rt = t.query(Query("events", "kind = 'k2'", properties=["kind"]))
    assert rt.n == rj.n > 0
    assert set(rt.batch.columns) == set(rj.batch.columns) == {"kind"}
    assert sorted(_ids(rt)) == sorted(_ids(rj))
    loaded = next(iter(t._state("events").cache.values()))
    assert {a.name for a in loaded.get_schema("events").attributes} \
        <= {"kind", "dtg", "geom"}


def test_projection_with_sample_by(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    rj = j.query(JQuery("events", "INCLUDE", properties=["kind"],
                        hints={JHints.SAMPLING: 0.5,
                               JHints.SAMPLE_BY: "kind"}))
    rt = t.query(Query("events", "INCLUDE", properties=["kind"],
                       hints={QueryHints.SAMPLING: 0.5,
                              QueryHints.SAMPLE_BY: "kind"}))
    assert 0 < rt.n < 5000
    # one file a partition: both stores load the rows in one order
    assert _ids(rt) == _ids(rj)


def test_pushdown_with_unpushable_residual(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    ecql = "kind LIKE 'k%' AND BBOX(geom, -90, -45, 90, 45)"
    rj, rt = j.query(ecql, "events"), t.query(ecql, "events")
    full = t._load(t._state("events"),
                   t._files_for(t._state("events"), None))
    want = set(_ids(full.query(ecql, "events")))
    assert set(_ids(rt)) == set(_ids(rj)) == want and rt.n > 0


def test_sorted_query_ids_in_order(tmp_path):
    j, t = _pair(tmp_path)
    for seed in (0, 1):
        write_sample(j, n=1500, seed=seed)
        write_sample(t, n=1500, seed=seed)
    q = ("BBOX(geom, -60, -40, 60, 40) AND "
         "dtg DURING 2017-01-03T00:00:00Z/2017-01-12T00:00:00Z")
    rj = j.query(JQuery("events", q, sort_by="dtg"))
    rt = t.query(Query("events", q, sort_by="dtg"))
    assert _ids(rt) == _ids(rj) and rt.n > 0


def test_reopen_from_disk(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j, n=100)
    write_sample(t, n=100)
    t2 = _port(tmp_path / "t")
    assert t2.get_type_names() == JFs(str(tmp_path / "j")).get_type_names() \
        == ["events"]
    assert t2.count("events") == 100


def test_compact(tmp_path):
    j, t = _pair(tmp_path)
    for ds in (j, t):
        write_sample(ds, n=200, seed=1)
        write_sample(ds, n=200, seed=2)
    counts = []
    for ds in (j, t):
        st = ds._state("events")
        before = sum(len(ds._files_for(st, [p]))
                     for p in ds.partitions("events"))
        ds.compact("events")
        after = sum(len(ds._files_for(st, [p]))
                    for p in ds.partitions("events"))
        counts.append((before, after, ds.count("events")))
    assert counts[0] == counts[1]
    assert counts[1][1] < counts[1][0] and counts[1][2] == 400
    assert sorted(_ids(t.query(ECQL, "events"))) == \
        sorted(_ids(j.query(ECQL, "events")))


def test_delete_rewrites_files(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    gone = [f"e0_{i}" for i in range(0, 5000, 7)]
    j.delete("events", gone)
    t.delete("events", gone)
    assert t.count("events") == j.count("events") == 5000 - len(gone)
    rt, rj = t.query(ECQL, "events"), j.query(ECQL, "events")
    assert sorted(_ids(rt)) == sorted(_ids(rj))
    assert not set(_ids(t.query("INCLUDE", "events"))) & set(gone)


def test_bulk_write_past_two_million_rows(tmp_path):
    """A write of 4M rows (the size at which pyarrow turns a numpy
    unicode array into a ChunkedArray) lands in the same partitions as
    the JAX store's, and every row of every partition reads back equal
    to the JAX store's, in order."""
    n = 4_000_000
    rng = np.random.default_rng(11)
    ids = np.arange(n).astype(str).astype(object)
    data = {"n": rng.integers(0, 1000, n),
            "dtg": rng.integers(MS("2017-01-01"), MS("2017-01-11"), n),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}
    spec = "n:Integer,dtg:Date,*geom:Point"
    j, t = _pair(tmp_path, spec=spec)
    names_j = j.write("events", JBatch.from_dict(j.get_schema("events"),
                                                 ids, data))
    names_t = t.write("events", FeatureBatch.from_dict(
        t.get_schema("events"), ids, data))
    assert names_t.tolist() == names_j.tolist()
    parts = t.partitions("events")
    assert parts == j.partitions("events") and len(parts) == 10
    total = 0
    for part in parts:
        (bj, _), (bt, _) = (j.read_partition("events", part),
                            t.read_partition("events", part))
        assert bt.ids.tolist() == bj.ids.tolist()
        assert np.array_equal(bt.col("n").values, bj.col("n").values)
        assert np.array_equal(bt.col("dtg").millis, bj.col("dtg").millis)
        assert np.array_equal(bt.col("geom").x, bj.col("geom").x)
        assert np.array_equal(bt.col("geom").y, bj.col("geom").y)
        total += bt.n
    assert total == n


def test_read_partition_equal(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j, n=1000)
    write_sample(t, n=1000)
    # the JAX store's files under the port: one order, one batch
    tj = _port(tmp_path / "j")
    for part in t.partitions("events")[:4] + ["nope", "../events"]:
        bj, vj = j.read_partition("events", part)
        bt, vt = tj.read_partition("events", part)
        assert (bj is None) == (bt is None) and vj is None and vt is None
        if bj is not None:
            assert bt.ids.tolist() == bj.ids.tolist()
            assert np.array_equal(bt.col("geom").x, bj.col("geom").x)
            assert np.array_equal(bt.col("dtg").millis, bj.col("dtg").millis)
            assert [bt.col("kind").value(i) for i in range(bt.n)] == \
                [bj.col("kind").value(i) for i in range(bj.n)]


def test_bin_and_arrow_bytes_equal_on_one_root(tmp_path):
    j = JFs(str(tmp_path / "j"))
    j.create_schema(jparse("events", SPEC))
    write_sample(j, n=3000)
    t = _port(tmp_path / "j")
    assert t.bin_query("events", ECQL, track="kind") == \
        j.bin_query("events", ECQL, track="kind")
    assert t.bin_query("events", ECQL, sort=True) == \
        j.bin_query("events", ECQL, sort=True)
    assert t.arrow_ipc("events", ECQL) == j.arrow_ipc("events", ECQL)


def test_reindex_and_back(tmp_path):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    t.load_resident("events")
    want = sorted(_ids(j.query(ECQL, "events")))
    assert sorted(_ids(t.query(ECQL, "events"))) == want
    assert os.path.isdir(tmp_path / "t" / "events" / "index")
    for version in (1, None):
        t.reindex("events", version)
        j.reindex("events", version)
        assert not os.path.isdir(tmp_path / "t" / "events" / "index")
        assert sorted(_ids(t.query(ECQL, "events"))) == want
        assert sorted(_ids(j.query(ECQL, "events"))) == want
        reopened = _port(tmp_path / "t")
        assert reopened.get_schema("events").index_version == \
            JFs(str(tmp_path / "j")).get_schema("events").index_version
        assert sorted(_ids(reopened.query(ECQL, "events"))) == want


def test_remove_schema(tmp_path):
    _, t = _pair(tmp_path)
    write_sample(t, n=100)
    t.query(ECQL, "events")
    t.remove_schema("events")
    assert t.get_type_names() == []
    assert not os.path.exists(tmp_path / "t" / "events")
    assert _port(tmp_path / "t").get_type_names() == []
    with pytest.raises(KeyError):
        t.count("events")


def test_write_returns_raw_partition_names(tmp_path):
    j, t = _pair(tmp_path)
    ids, data = _data(500)
    from geomesa_tpu.features import FeatureBatch as JBatch
    from geomesa_tpu_torch.features import FeatureBatch
    nj = j.write("events", JBatch.from_dict(j.get_schema("events"), ids, data))
    nt = t.write("events", FeatureBatch.from_dict(t.get_schema("events"),
                                                  ids, data))
    assert nt.tolist() == nj.tolist()


def test_load_cache_is_bounded(tmp_path):
    _, t = _pair(tmp_path)
    write_sample(t, n=2000)
    st = t._state("events")
    for k in range(10):
        t.query(f"BBOX(geom, {k}, 0, {k + 1}, 1)", "events")
    assert len(st.cache) == 8
    pinned = {id(m) for m in st.pending_sidecar.values()}
    assert pinned <= {id(m) for m in st.cache.values()}


def test_needs_cuda_unless_a_device_is_given(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        PkgFs(str(tmp_path / "x"))
    assert _port(tmp_path / "y").device.type == "cpu"


# -- pushdown expressions ------------------------------------------------------

PUSHDOWN_FILTERS = [
    "INCLUDE",
    "BBOX(geom, -20, -10, 20, 10)",
    "BBOX(geom, -20, -10, 20, 10) AND kind = 'k1'",
    "kind = 'k1' OR kind = 'k2'",
    "kind = 'k1' OR kind LIKE 'k%'",
    "kind LIKE 'k%' AND BBOX(geom, -90, -45, 90, 45)",
    "kind IN ('k0', 'k3')",
    "NOT (kind = 'k1')",
    "kind <> 'k1' AND kind >= 'k0' AND kind < 'k3' AND kind <= 'k9'",
    "n > 3", "n BETWEEN 2 AND 4",
    "kind IS NULL",
    "dtg DURING 2017-01-02T00:00:00Z/2017-01-05T00:00:00Z",
    "dtg AFTER 2017-01-10T00:00:00Z",
    "dtg BEFORE 2017-01-02T00:00:00Z",
    "dtg = '2017-01-03T00:00:00Z'",
    "dtg BETWEEN '2017-01-03T00:00:00Z' AND '2017-01-04T00:00:00Z'",
    "INTERSECTS(geom, POLYGON((0 0, 30 0, 30 30, 0 30, 0 0)))",
    "WITHIN(geom, POLYGON((0 0, 30 0, 30 30, 0 30, 0 0)))",
    "DWITHIN(geom, POINT(10 10), 500, kilometers)",
    "DWITHIN(geom, POINT(10 10), 0.5, degrees)",
    "CONTAINS(geom, POINT(1 1))",
    "IN ('e0_1', 'e0_2')",
    ECQL,
]


@pytest.mark.parametrize("ecql", PUSHDOWN_FILTERS)
@pytest.mark.parametrize("spec", [SPEC + ",n:Integer",
                                  "kind:String,n:Integer,dtg:Date,"
                                  "*geom:Polygon"])
def test_pushdown_expressions_equal(ecql, spec):
    want = jpushdown(jecql(ecql), jparse("events", spec))
    got = _pushdown_expr(parse_ecql(ecql), parse_spec("events", spec))
    assert (got is None) == (want is None)
    assert str(got) == str(want)


# -- TestIndexSidecars' cases, both packages ----------------------------------

def test_sidecar_written_and_reused(tmp_path, monkeypatch):
    j, t = _pair(tmp_path)
    write_sample(j)
    write_sample(t)
    expect = sorted(_ids(j.query(ECQL, "events")))
    assert sorted(_ids(t.query(ECQL, "events"))) == expect
    snaps = list((tmp_path / "t" / "events" / "index").iterdir())
    assert len(snaps) == 1 and (snaps[0] / "manifest.json").is_file()
    arrays = sorted(p.name for p in snaps[0].iterdir())
    jsnaps = list((tmp_path / "j" / "events" / "index").iterdir())
    assert arrays == sorted(p.name for p in jsnaps[0].iterdir())
    # a fresh store answers WITHOUT sorting: both sort entry points and
    # np.lexsort poisoned
    t2 = _port(tmp_path / "t")
    _poison(monkeypatch, zkeys)
    assert sorted(_ids(t2.query(ECQL, "events"))) == expect


def test_stale_sidecar_ignored_after_write(tmp_path):
    _, t = _pair(tmp_path)
    write_sample(t, n=3000)
    r1 = t.query(ECQL, "events")
    write_sample(t, n=3000, seed=1)  # new files: digests change
    r2 = _port(tmp_path / "t").query(ECQL, "events")
    assert r2.n >= r1.n
    expect = set()
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        dtg = rng.integers(MS("2017-01-01"), MS("2017-01-20"), 3000)
        x = rng.uniform(-180, 180, 3000)
        y = rng.uniform(-90, 90, 3000)
        hit = ((x >= -10) & (x <= 10) & (y >= -10) & (y <= 10)
               & (dtg > MS("2017-01-02")) & (dtg < MS("2017-01-05")))
        expect |= {f"e{seed}_{i}" for i in np.flatnonzero(hit)}
    assert set(_ids(r2)) == expect


def test_sidecar_cap_prunes(tmp_path):
    _, t = _pair(tmp_path)
    write_sample(t, n=2000)
    for k in range(7):
        t.query(f"BBOX(geom, {k}, 0, {k + 1}, 1)", "events")
    idx_dir = tmp_path / "t" / "events" / "index"
    assert 0 < len(list(idx_dir.iterdir())) <= FileSystemDataStore._SIDECAR_CAP


def test_resident_sidecar_reopen_and_append(tmp_path, monkeypatch):
    """load_resident's full-table sidecar serves a reopened store without
    a sort; the memory-mapped (read-only) orders then take an append:
    the merged index answers as a store built without sidecars."""
    _, t = _pair(tmp_path)
    write_sample(t, n=4000)
    t.load_resident("events")
    want = _ids(t.query(ECQL, "events"))
    t2 = _port(tmp_path / "t")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _poison(monkeypatch, zkeys)
        res = t2.query(ECQL, "events")
        assert "Served from resident full-table store" in res.explain.text
        assert _ids(res) == want
        monkeypatch.undo()
        st = t2._state("events")
        mem = t2._load(st, t2._files_for(st, None))
        state = mem._state("events").zindex.state_dict()
        assert any(isinstance(a, np.memmap) or not a.flags.writeable
                   for a in state.values())
        ids, data = _data(700, seed=9)
        mem.write_dict("events", ids, data)
        got = _ids(mem.query(ECQL, "events"))
    assert not [w for w in caught if "writable" in str(w.message)]
    # the same rows in the same order, no sidecar
    fresh = InMemoryDataStore(device="cpu")
    fresh.create_schema("events", SPEC)
    fresh.write("events", mem._state("events").batch.take(
        np.arange(4000)))
    fresh.query(ECQL, "events")
    fresh.write_dict("events", ids, data)
    assert got == _ids(fresh.query(ECQL, "events"))


# -- roots and sidecars across packages ---------------------------------------

def _without_index(src, dst):
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        shutil.rmtree(os.path.join(dst, name, "index"), ignore_errors=True)


@pytest.mark.parametrize("then", ["none", "delete", "compact"])
@pytest.mark.parametrize("resident", [False, True])
def test_jax_root_and_sidecar_in_the_port(tmp_path, monkeypatch, then,
                                          resident):
    j = JFs(str(tmp_path / "j"))
    j.create_schema(jparse("events", SPEC))
    for seed in (0, 1):
        write_sample(j, n=2500, seed=seed)
    if then == "delete":
        j.delete("events", [f"e0_{i}" for i in range(0, 2500, 3)])
    elif then == "compact":
        j.compact("events")
    if resident:
        j.load_resident("events")
    want = _ids(j.query(ECQL, "events"))
    assert os.listdir(tmp_path / "j" / "events" / "index")
    _without_index(tmp_path / "j", tmp_path / "plain")
    plain = _ids(_port(tmp_path / "plain").query(ECQL, "events"))
    t = _port(tmp_path / "j")
    _poison(monkeypatch, zkeys)
    got = _ids(t.query(ECQL, "events"))
    assert got == want == plain and len(got) > 0


@pytest.mark.parametrize("then", ["none", "delete", "compact"])
@pytest.mark.parametrize("resident", [False, True])
def test_port_root_and_sidecar_in_jax(tmp_path, monkeypatch, then,
                                      resident):
    t = _port(tmp_path / "t")
    t.create_schema("events", SPEC)
    for seed in (0, 1):
        write_sample(t, n=2500, seed=seed)
    if then == "delete":
        t.delete("events", [f"e1_{i}" for i in range(0, 2500, 3)])
    elif then == "compact":
        t.compact("events")
    if resident:
        t.load_resident("events")
    want = _ids(t.query(ECQL, "events"))
    assert os.listdir(tmp_path / "t" / "events" / "index")
    _without_index(tmp_path / "t", tmp_path / "plain")
    plain = _ids(JFs(str(tmp_path / "plain")).query(ECQL, "events"))
    j = JFs(str(tmp_path / "t"))
    _poison(monkeypatch, jzkeys)
    got = _ids(j.query(ECQL, "events"))
    assert got == want == plain and len(got) > 0


# -- TestFsAttributeVisibility's cases, and labels across files ----------------

VIS_SPEC = ("name:String,age:Integer,dtg:Date,*geom:Point;"
            "geomesa.visibility.level='attribute'")


def _vis_rows(ds):
    ds.write_dict("t", ["a", "b"],
                  {"name": ["alice", "bob"], "age": [30, 40],
                   "dtg": [MS("2017-01-01")] * 2,
                   "geom": ([1.0, 2.0], [1.0, 2.0])},
                  visibilities=["admin,,,", ",,,"])


def _features(res) -> dict:
    return {str(i): {k: v for k, v in f.items() if k not in ("id", "geom")}
            for i, f in zip(res.ids, res.features())}


@pytest.mark.parametrize("auths", [[], ["admin"]])
def test_labels_persist_and_null_cells(tmp_path, auths):
    j, t = _pair(tmp_path, spec=VIS_SPEC, name="t")
    _vis_rows(j)
    _vis_rows(t)
    rt = _port(tmp_path / "t").query(Query("t", "INCLUDE", auths=auths))
    rj = JFs(str(tmp_path / "j")).query(JQuery("t", "INCLUDE", auths=auths))
    assert _features(rt) == _features(rj)
    assert (_features(rt)["a"]["name"] is None) == (auths == [])


@pytest.mark.parametrize("auths", [[], ["admin"]])
@pytest.mark.parametrize("props", [["name"], ["age"], ["name", "age"]])
def test_projected_query_remaps_labels(tmp_path, auths, props):
    j, t = _pair(tmp_path, spec=VIS_SPEC, name="t")
    _vis_rows(j)
    _vis_rows(t)
    rt = t.query(Query("t", "INCLUDE", auths=auths, properties=props))
    rj = j.query(JQuery("t", "INCLUDE", auths=auths, properties=props))
    assert _features(rt) == _features(rj)
    if "name" in props:
        assert (_features(rt)["a"]["name"] is None) == (auths == [])
        assert _features(rt)["b"]["name"] == "bob"


def test_write_rejects_wrong_label_arity(tmp_path):
    _, t = _pair(tmp_path, spec=VIS_SPEC, name="t")
    with pytest.raises(ValueError):
        t.write_dict("t", ["x"], {"name": ["n"], "age": [1],
                                  "dtg": [MS("2017-01-01")],
                                  "geom": ([0.0], [0.0])},
                     visibilities=["admin,user"])
    with pytest.raises(ValueError):
        t.write_dict("t", ["x"], {"name": ["n"], "age": [1],
                                  "dtg": [MS("2017-01-01")],
                                  "geom": ([0.0], [0.0])},
                     visibilities=["a,,,", ",,,"])
    assert t.partitions("t") == []


def test_labels_of_a_later_file_are_read(tmp_path):
    """A partition whose first file (in sorted order) has no label column
    and whose second has one: the port reads the labels (the JAX store
    reads only the first file's columns and serves the labelled row to
    every reader). Oracle: the JAX in-memory store on the same writes."""
    spec = "name:String,dtg:Date,*geom:Point"
    rows = [(["a"], None), (["b"], ["secret"])]
    t = _port(tmp_path / "t")
    t.create_schema("t", spec)
    ref = JMem()
    ref.create_schema(jparse("t", spec))
    pdir = tmp_path / "t" / "t" / "data" / "2017" / "01" / "01"
    for k, (ids, vis) in enumerate(rows):
        data = {"name": ["x"], "dtg": [MS("2017-01-01")],
                "geom": ([1.0], [1.0])}
        # the write's file is what the listing gained: a new file's name
        # is random hex, and may itself start with "f"
        before = set(os.listdir(pdir)) if pdir.exists() else set()
        t.write_dict("t", ids, data, visibilities=vis)
        ref.write_dict("t", ids, data, visibilities=vis)
        new = sorted(set(os.listdir(pdir)) - before)
        os.rename(pdir / new[0], pdir / f"f{k}.parquet")
    for auths in ([], ["secret"]):
        want = sorted(_ids(ref.query(JQuery("t", "INCLUDE", auths=auths))))
        for ds in (t, _port(tmp_path / "t")):
            got = ds.query(Query("t", "INCLUDE", auths=auths))
            assert sorted(_ids(got)) == want
            proj = ds.query(Query("t", "INCLUDE", auths=auths,
                                  properties=["name"]))
            assert sorted(_ids(proj)) == want
        part, vis = t.read_partition("t", "2017/01/01")
        assert part.ids.tolist() == ["a", "b"]
        assert vis.tolist() == [None, "secret"]
    # the JAX store over the same root (the reference's departure)
    leaked = JFs(str(tmp_path / "t")).query(JQuery("t", "INCLUDE", auths=[]))
    assert sorted(_ids(leaked)) == ["a", "b"]
