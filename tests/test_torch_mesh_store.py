"""The port's DistributedDataStore and FsBackedDistributedDataStore
against the JAX package's, on the CPU.

The port's stores run ``data_mesh(8, device="cpu")``: eight shards on
the CPU with the kernels' plain versions; the JAX stores run the JAX
package's ``data_mesh()`` over the eight virtual devices that
``tests/conftest.py`` forces. Every store gets the same seeded rows.
The 17 cases of ``tests/test_mesh_store.py`` (with their parametrised
queries) run here, each held to its own oracle (the port's single-device
store, a numpy brute force) and to the JAX mesh store; so do the mesh
cases of ``tests/test_fs_store.py`` (TestFsBackedMesh),
``tests/test_index_versioning.py`` (the fs-mesh sidecar after a
reindex) and ``tests/test_processes2.py`` (sampling on the mesh store).
Roots and ``index_mesh`` sidecars written by either package open in the
other, and Arrow payloads read back across packages. Tolerance: exact
(ids in result order, counts, histograms, KNN ids in order, Arrow
tables); density grids bit for bit against the JAX mesh store's."""

import os
import shutil

import numpy as np
import pytest

from geomesa_tpu.features import parse_spec as jparse_spec
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.parallel import data_mesh as jdata_mesh
from geomesa_tpu.store import DistributedDataStore as JDist
from geomesa_tpu.store import FsBackedDistributedDataStore as JFsMesh
from geomesa_tpu_torch.features import parse_spec
from geomesa_tpu_torch.index.api import Query
from geomesa_tpu_torch.parallel import data_mesh
from geomesa_tpu_torch.store import (DistributedDataStore,
                                     FsBackedDistributedDataStore,
                                     InMemoryDataStore)

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"


def tmesh():
    return data_mesh(8, device="cpu")


def tdist():
    return DistributedDataStore(tmesh())


def _ids(res) -> list:
    return [str(i) for i in res.ids]


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(42)
    n = 120_007
    data = {
        "name": [f"n{i % 13}" for i in range(n)],
        "age": rng.integers(0, 100, n),
        "dtg": rng.integers(MS("2019-01-01"), MS("2019-06-01"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }
    ids = [f"f{i}" for i in range(n)]
    dist = tdist()
    dist.create_schema(parse_spec("pts", SPEC))
    dist.write_dict("pts", ids, data)
    mem = InMemoryDataStore(device="cpu")
    mem.create_schema(parse_spec("pts", SPEC))
    mem.write_dict("pts", ids, data)
    jdist = JDist(jdata_mesh())
    jdist.create_schema(jparse_spec("pts", SPEC))
    jdist.write_dict("pts", ids, data)
    return dist, mem, jdist


class _CapSpy:
    """Wraps a row-materializing function; records calls and asserts
    each result stays result-space (< table length)."""

    def __init__(self, fn, n):
        self.fn, self.n, self.calls = fn, n, 0

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls += 1
        assert len(out) < self.n
        return out


QUERIES = [
    "BBOX(geom, -20, -15, 31.5, 42.25)",
    ("BBOX(geom, 10, 10, 60, 55) AND "
     "dtg DURING 2019-02-01T00:00:00Z/2019-03-15T00:00:00Z"),
    "INTERSECTS(geom, POLYGON ((0 0, 40 5, 35 45, -5 30, 0 0)))",
    "BBOX(geom, -20, -15, 31.5, 42.25) AND age > 50",
    "IN ('f17', 'f99', 'nope')",
]


class TestDistributedStore:
    @pytest.mark.parametrize("ecql", QUERIES)
    def test_ids_match_single_device_store(self, stores, ecql):
        dist, mem, jdist = stores
        got = _ids(dist.query(ecql, "pts"))
        assert got == _ids(mem.query(ecql, "pts"))
        assert got == _ids(jdist.query(ecql, "pts"))

    @pytest.mark.parametrize("ecql", QUERIES)
    def test_count_matches(self, stores, ecql):
        dist, mem, jdist = stores
        n = dist.query_count(ecql, "pts")
        assert n == mem.query(ecql, "pts").n == jdist.query_count(ecql,
                                                                  "pts")

    def test_density_mass(self, stores):
        dist, mem, jdist = stores
        ecql = "BBOX(geom, -90, -45, 90, 45)"
        grid = dist.density("pts", ecql, (-180, -90, 180, 90), 32, 16)
        assert int(grid.sum()) == mem.query(ecql, "pts").n
        want = jdist.density("pts", ecql, (-180, -90, 180, 90), 32, 16)
        assert grid.tobytes() == np.asarray(want, np.float32).tobytes()

    @pytest.mark.parametrize("ecql,bbox,w,h", [
        ("BBOX(geom, 10, 10, 60, 55) AND "
         "dtg DURING 2019-02-01T00:00:00Z/2019-03-15T00:00:00Z",
         (0.0, 0.0, 70.0, 60.0), 140, 120),
        ("INCLUDE", (-180.0, -90.0, 180.0, 90.0), 360, 180),
        ("BBOX(geom, -20, -15, 31.5, 42.25)", (-10.0, -5.0, 5.0, 5.0),
         64, 48),
    ])
    def test_density_bit_equal_to_reference_mesh(self, stores, ecql, bbox,
                                                 w, h):
        dist, mem, jdist = stores
        got = dist.density("pts", ecql, bbox, w, h)
        want = np.asarray(jdist.density("pts", ecql, bbox, w, h),
                          np.float32)
        assert got.shape == (h, w) and got.tobytes() == want.tobytes()

    def test_histogram_matches_numpy(self, stores):
        dist, mem, jdist = stores
        hist = dist.histogram("pts", "age", 10, 0.0, 100.0)
        ages = mem._state("pts").batch.col("age").values
        want, _ = np.histogram(ages, bins=10, range=(0.0, 100.0))
        assert np.array_equal(hist, want)
        assert np.array_equal(hist, jdist.histogram("pts", "age", 10, 0.0,
                                                    100.0))
        for attr, nb, lo, hi in (("age", 7, 3.5, 77.0),
                                 ("dtg", 12, float(MS("2019-02-01")),
                                  float(MS("2019-05-01")))):
            assert np.array_equal(dist.histogram("pts", attr, nb, lo, hi),
                                  jdist.histogram("pts", attr, nb, lo, hi))

    def test_knn(self, stores):
        dist, mem, jdist = stores
        for qx, qy, k in ((12.3, -45.6, 25), (-100.0, 40.0, 1),
                          (170.0, 80.0, 60)):
            ids = dist.knn("pts", qx, qy, k)
            col = mem._state("pts").batch.col("geom")
            d2 = (col.x - qx) ** 2 + (col.y - qy) ** 2
            want = mem._state("pts").batch.ids[np.argsort(d2,
                                                          kind="stable")[:k]]
            assert set(ids.astype(str)) == set(want.astype(str))
            assert list(ids.astype(str)) == list(
                jdist.knn("pts", qx, qy, k).astype(str))

    def test_sort_by_matches_memory(self, stores):
        dist, mem, jdist = stores
        q = Query("pts", "BBOX(geom, -90, -45, 90, 45)", sort_by="age")
        assert _ids(dist.query(q)) == _ids(mem.query(q))
        qd = Query("pts", "BBOX(geom, -90, -45, 90, 45)", sort_by="age",
                   sort_desc=True, max_features=10)
        assert _ids(dist.query(qd)) == _ids(mem.query(qd))
        assert _ids(dist.query(qd)) == _ids(jdist.query(JQuery(
            "pts", "BBOX(geom, -90, -45, 90, 45)", sort_by="age",
            sort_desc=True, max_features=10)))

    def test_selective_query_uses_pruned_host_path(self, stores):
        dist, mem, jdist = stores
        ecql = ("BBOX(geom, 5, 5, 7, 7) AND "
                "dtg DURING 2019-02-01T00:00:00Z/2019-02-08T00:00:00Z")
        lines = []
        res = dist.query(Query("pts", ecql), explain_out=lines.append)
        assert any("Index-pruned host scan" in ln for ln in lines), lines
        assert _ids(res) == _ids(mem.query(ecql, "pts"))

    def test_wide_query_uses_distributed_scan(self, stores):
        dist, mem, jdist = stores
        ecql = "BBOX(geom, -180, -90, 180, 0)"
        lines = []
        res = dist.query(Query("pts", ecql), explain_out=lines.append)
        assert any("Distributed scan over 8 device(s)" in ln
                   for ln in lines), lines
        assert _ids(res) == _ids(mem.query(ecql, "pts"))

    def test_gathered_tier_evaluates_candidates_on_host(self, stores):
        from geomesa_tpu_torch.store.memory import HOST_SCAN_ROWS
        dist, mem, jdist = stores
        ecql = ("BBOX(geom, 5, 5, 30, 25) AND "
                "dtg DURING 2019-02-01T00:00:00Z/2019-03-08T00:00:00Z")
        HOST_SCAN_ROWS.set("0")
        try:
            lines = []
            res = dist.query(Query("pts", ecql), explain_out=lines.append)
        finally:
            HOST_SCAN_ROWS.set(None)
        assert any("Index-pruned host candidate scan" in ln
                   for ln in lines), lines
        assert _ids(res) == _ids(mem.query(ecql, "pts"))

    def test_wide_query_compacts_on_device(self, stores, monkeypatch):
        """The dense tier never pulls a full-length host mask: hit rows
        compact per shard through exact_hit_rows, and the compaction
        transfer is O(hits)."""
        from geomesa_tpu_torch.parallel import mesh as pmesh
        from geomesa_tpu_torch.store import mesh_store
        dist, mem, jdist = stores
        n = mem.count("pts")

        def boom(*a, **k):
            raise AssertionError("full-length host mask materialized")

        monkeypatch.setattr(pmesh, "exact_host_mask", boom)
        spy = _CapSpy(pmesh.exact_hit_rows, n)
        monkeypatch.setattr(mesh_store, "exact_hit_rows", spy)
        ecql = "BBOX(geom, -180, -90, 180, 0)"
        res = dist.query(Query("pts", ecql))
        assert _ids(res) == _ids(mem.query(ecql, "pts"))
        assert spy.calls > 0

    def test_query_batched_matches_query(self, stores):
        dist, mem, jdist = stores
        ecqls = ["BBOX(geom, -20, -15, 31.5, 42.25)",
                 ("BBOX(geom, 10, 10, 60, 55) AND dtg DURING "
                  "2019-02-01T00:00:00Z/2019-03-15T00:00:00Z"),
                 "BBOX(geom, -180, -90, 180, 0)",
                 "BBOX(geom, 100, -50, 140, -10) OR BBOX(geom, 0, 0, 9, 9)",
                 "name = 'n3'"]
        lines = []
        got = dist.query_batched([Query("pts", e) for e in ecqls],
                                 explain_out=lines.append)
        assert any("Fused distributed scan" in ln for ln in lines), lines
        jgot = jdist.query_batched([JQuery("pts", e) for e in ecqls])
        for e, g, j in zip(ecqls, got, jgot):
            assert _ids(g) == _ids(mem.query(e, "pts")) == _ids(j), e

    def test_extent_types_supported(self):
        ds = tdist()
        mem = InMemoryDataStore(device="cpu")
        jds = JDist(jdata_mesh())
        wkts = [
            "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
            "POLYGON ((20 20, 30 20, 30 30, 20 30, 20 20))",
            "POLYGON ((-50 -50, -40 -50, -40 -40, -50 -40, -50 -50))",
            "LINESTRING (5 5, 25 25)",
        ]
        for s, parse in ((ds, parse_spec), (mem, parse_spec),
                         (jds, jparse_spec)):
            s.create_schema(parse("z", "*geom:Geometry:srid=4326"))
            s.write_dict("z", [f"g{i}" for i in range(len(wkts))],
                         {"geom": wkts})
        for ecql in ("BBOX(geom, 1, 1, 9, 9)",
                     "INTERSECTS(geom, POLYGON ((4 4, 26 4, 26 26, 4 26, "
                     "4 4)))",
                     "INCLUDE"):
            got = _ids(ds.query(ecql, "z"))
            assert got == _ids(mem.query(ecql, "z")) == _ids(
                jds.query(ecql, "z")), ecql
        assert list(ds.knn("z", 24.0, 24.0, 2).astype(str)) == list(
            jds.knn("z", 24.0, 24.0, 2).astype(str))

    def test_extent_tristate_on_shards(self):
        from geomesa_tpu_torch.store.memory import EXTENT_HOST_SCAN_ROWS
        from geomesa_tpu.store.memory import \
            EXTENT_HOST_SCAN_ROWS as JEXTENT
        rng = np.random.default_rng(12)
        n = 3_001
        cx, cy = rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)
        wkts = [f"POLYGON (({a - 1} {b - 1}, {a + 1} {b - 1}, "
                f"{a + 1} {b + 1}, {a - 1} {b + 1}, {a - 1} {b - 1}))"
                for a, b in zip(cx, cy)]
        ds, jds = tdist(), JDist(jdata_mesh())
        for s, parse in ((ds, parse_spec), (jds, jparse_spec)):
            s.create_schema(parse("e", "*geom:Polygon:srid=4326"))
            s.write_dict("e", [f"p{i}" for i in range(n)], {"geom": wkts})
        EXTENT_HOST_SCAN_ROWS.set("0")
        JEXTENT.set("0")
        try:
            for ecql in ("BBOX(geom, -20, -15, 31.5, 22.25)",
                         "INTERSECTS(geom, POLYGON ((0 0, 40 5, 35 35, "
                         "-5 30, 0 0)))"):
                lines = []
                got = _ids(ds.query(Query("e", ecql),
                                    explain_out=lines.append))
                assert any("Device extent scan" in ln for ln in lines)
                assert got == _ids(jds.query(ecql, "e")), ecql
                assert len(ds._state("e").ext_segments[0].shards) == 8
        finally:
            EXTENT_HOST_SCAN_ROWS.set(None)
            JEXTENT.set(None)

    def test_visibility_filtering(self):
        from geomesa_tpu_torch.features.batch import FeatureBatch
        ds = tdist()
        ds.create_schema(parse_spec("v", SPEC))
        n = 50
        rng = np.random.default_rng(3)
        batch = FeatureBatch.from_dict(ds.get_schema("v"),
            [f"f{i}" for i in range(n)],
            {"name": [f"n{i}" for i in range(n)],
             "age": rng.integers(0, 9, n),
             "dtg": rng.integers(0, 10 ** 12, n),
             "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))})
        vis = ["admin" if i % 2 else None for i in range(n)]
        ds.write("v", batch, visibilities=vis)
        assert ds.query(Query("v", "INCLUDE", auths=[])).n == n // 2
        assert ds.query(Query("v", "INCLUDE", auths=["admin"])).n == n
        assert ds.query_count(Query("v", "BBOX(geom, -20, -20, 20, 20)",
                                    auths=[])) == n // 2

    def test_delete(self):
        ds = tdist()
        ds.create_schema(parse_spec("d", SPEC))
        rng = np.random.default_rng(5)
        n = 1000
        ds.write_dict("d", [f"f{i}" for i in range(n)], {
            "name": [f"n{i % 3}" for i in range(n)],
            "age": rng.integers(0, 100, n),
            "dtg": rng.integers(0, 10 ** 12, n),
            "geom": (rng.uniform(-90, 90, n), rng.uniform(-45, 45, n))})
        assert ds.query("INCLUDE", "d").n == n
        ds.delete("d", [f"f{i}" for i in range(0, n, 2)])
        assert ds.count("d") == n // 2
        res = ds.query("INCLUDE", "d")
        assert res.n == n // 2
        assert all(int(s[1:]) % 2 == 1 for s in res.ids.astype(str))
        wide = ds.query("BBOX(geom, -180, -90, 180, 90)", "d")
        assert sorted(_ids(wide)) == sorted(_ids(res))

    def test_write_burst_appends_segment_not_reshard(self):
        ds = tdist()
        ds.create_schema(parse_spec("w", SPEC))
        rng = np.random.default_rng(7)

        def mkdata(n):
            return {"name": [f"n{i % 3}" for i in range(n)],
                    "age": rng.integers(0, 100, n),
                    "dtg": rng.integers(0, 10 ** 12, n),
                    "geom": (rng.uniform(-90, 90, n),
                             rng.uniform(-45, 45, n))}

        n0 = 10_000
        ds.write_dict("w", [f"a{i}" for i in range(n0)], mkdata(n0))
        ds.query("BBOX(geom, -180, -90, 180, 0)", "w")  # build
        st = ds._state("w")
        assert len(st.segments) == 1
        base_seg = st.segments[0]
        n1 = 500
        ds.write_dict("w", [f"b{i}" for i in range(n1)], mkdata(n1))
        res = ds.query("BBOX(geom, -180, -90, 180, 0)", "w")
        assert len(st.segments) == 2
        assert st.segments[0] is base_seg          # base not re-uploaded
        assert st.segments[1].n == n1              # delta-sized segment
        mem = InMemoryDataStore(device="cpu")
        mem.create_schema(parse_spec("w", SPEC))
        mem.write("w", st.batch)
        assert _ids(res) == _ids(mem.query("BBOX(geom, -180, -90, 180, 0)",
                                           "w"))
        col = st.batch.col("geom")
        d2 = (col.x - 1.0) ** 2 + (col.y - 2.0) ** 2
        assert list(ds.knn("w", 1.0, 2.0, 30).astype(str)) == list(
            st.batch.ids[np.argsort(d2, kind="stable")[:30]].astype(str))

    def test_segment_compaction_after_many_bursts(self):
        from geomesa_tpu_torch.store.mesh_store import MAX_SEGMENTS
        ds = tdist()
        ds.create_schema(parse_spec("c", SPEC))
        rng = np.random.default_rng(11)
        total = 0
        seen = []
        for _ in range(12):  # > MAX_SEGMENTS bursts
            n = 200
            ds.write_dict("c", [f"f{total + i}" for i in range(n)], {
                "name": [f"n{i % 3}" for i in range(n)],
                "age": rng.integers(0, 100, n),
                "dtg": rng.integers(0, 10 ** 12, n),
                "geom": (rng.uniform(-90, 90, n), rng.uniform(-45, 45, n))})
            total += n
            ds.query("BBOX(geom, -180, -90, 180, 0)", "c")
            seen.append(len(ds._state("c").segments))
        assert max(seen) == MAX_SEGMENTS and seen[MAX_SEGMENTS] == 1
        assert len(ds._state("c").segments) <= MAX_SEGMENTS
        assert ds.query("INCLUDE", "c").n == total
        assert ds.query_count("BBOX(geom, -180, -90, 180, 90)", "c") == total

    def test_empty_store(self):
        ds = tdist()
        ds.create_schema(parse_spec("e", SPEC))
        assert ds.query("INCLUDE", "e").n == 0
        assert ds.query_count("INCLUDE", "e") == 0
        assert ds.knn("e", 0.0, 0.0, 3).size == 0
        assert np.array_equal(ds.histogram("e", "age", 4, 0.0, 1.0),
                              np.zeros(4, np.int64))


class TestMeshArrow:
    def test_arrow_ipc_redacts_hidden_cells(self):
        from geomesa_tpu_torch.arrow.io import FeatureArrowFileReader
        ds = DistributedDataStore(tmesh())
        ds.create_schema(parse_spec(
            "t", "name:String,age:Integer,*geom:Point;"
            "geomesa.visibility.level='attribute'"))
        ds.write_dict("t", ["a", "b", "c", "d"], {
            "name": [f"secret{i}" for i in range(4)],
            "age": [10, 20, 30, 40],
            "geom": ([0.0, 1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0]),
        }, visibilities=["admin,,"] * 4)
        payload = ds.arrow_ipc("t", "INCLUDE")
        assert b"secret" not in payload
        batch = FeatureArrowFileReader(
            payload, ds.get_schema("t")).read_all()
        assert all(batch.col("name").value(i) is None
                   for i in range(batch.n))
        assert batch.col("age").value(0) == 10  # unlabeled col visible

    @pytest.mark.parametrize("sort_by", [None, "age", "name"])
    def test_payloads_read_back_across_packages(self, stores, sort_by):
        """The shard-split payloads of either package's mesh store read
        back in the other's reader as equal tables."""
        import pyarrow as pa
        dist, mem, jdist = stores
        ecql = "BBOX(geom, -20, -15, 31.5, 42.25) AND age > 50"
        got = dist.arrow_ipc("pts", ecql, sort_by=sort_by)
        want = jdist.arrow_ipc("pts", ecql, sort_by=sort_by)

        def table(payload):
            return pa.ipc.open_file(pa.BufferReader(payload)).read_all()
        t_got, t_want = table(got), table(want)
        assert t_got.num_rows == mem.query(ecql, "pts").n
        assert t_got.equals(t_want)
        from geomesa_tpu.arrow.io import FeatureArrowFileReader as JReader
        from geomesa_tpu_torch.arrow.io import FeatureArrowFileReader
        a = FeatureArrowFileReader(want, dist.get_schema("pts")).read_all()
        b = JReader(got, jdist.get_schema("pts")).read_all()
        assert [str(i) for i in a.ids] == [str(i) for i in b.ids]
        assert a.n == b.n == t_got.num_rows


class TestFsMeshPartitionPlacement:
    def _store(self, root):
        rng = np.random.default_rng(23)
        n = 4_000
        ds = FsBackedDistributedDataStore(root, tmesh())
        ds.create_schema(parse_spec(
            "ais", "name:String,dtg:Date,*geom:Point:srid=4326"))
        ds.write_dict("ais", [f"f{i}" for i in range(n)], {
            "name": [f"n{i % 5}" for i in range(n)],
            "dtg": rng.integers(MS("2021-03-01"), MS("2021-03-10"), n),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
        })
        return ds, n

    def test_partition_shards_after_delete_then_write(self, tmp_path):
        ds, n = self._store(str(tmp_path))
        ds.delete("ais", [f"f{i}" for i in range(100)])
        rng = np.random.default_rng(29)
        m = 40
        ds.write_dict("ais", [f"g{i}" for i in range(m)], {
            "name": [f"n{i % 5}" for i in range(m)],
            "dtg": rng.integers(MS("2021-03-01"), MS("2021-03-10"), m),
            "geom": (rng.uniform(-180, 180, m), rng.uniform(-90, 90, m)),
        })
        shards = ds.partition_shards("ais")
        st = ds._state("ais")
        covered = sum(hi - lo for _, lo, hi in ds._partition_rows["ais"])
        assert covered == st.n == n - 100 + m
        assert set().union(*shards.values()) == set(range(ds.mesh.size))
        assert set(shards) <= set(ds.partitions("ais"))


def _fs_rows(n=5_000, seed=31):
    rng = np.random.default_rng(seed)
    return {
        "name": [f"n{i % 7}" for i in range(n)],
        "dtg": rng.integers(MS("2021-03-01"), MS("2021-03-20"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }


FS_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
FS_ECQL = ("BBOX(geom, -90, -45, 90, 45) AND "
           "dtg DURING 2021-03-05T00:00:00Z/2021-03-10T00:00:00Z")


def _fs_write(root, jax=False, n=5_000):
    ds = (JFsMesh(root, jdata_mesh()) if jax
          else FsBackedDistributedDataStore(root, tmesh()))
    ds.create_schema((jparse_spec if jax else parse_spec)("ais", FS_SPEC))
    ds.write_dict("ais", [f"f{i}" for i in range(n)], _fs_rows(n))
    return ds, n


class TestFsBackedMesh:
    def test_roundtrip_reopen_identical_ids(self, tmp_path):
        root = str(tmp_path)
        ds, n = _fs_write(root)
        want = _ids(ds.query(FS_ECQL, "ais"))
        assert want and len(want) < n
        assert ds.persist_index("ais")
        re = FsBackedDistributedDataStore(root, tmesh())
        assert re.count("ais") == n
        st = re._state("ais")
        assert st.zindex_warm is not None    # the sidecar installed
        assert _ids(re.query(FS_ECQL, "ais")) == want
        jds, _ = _fs_write(str(tmp_path / "j"), jax=True)
        assert sorted(_ids(jds.query(FS_ECQL, "ais"))) == sorted(want)

    def test_reopen_adopts_sidecar_without_a_sort(self, tmp_path,
                                                  monkeypatch):
        """The reopen's index build takes the persisted z3 order: the
        z3 key sort never runs."""
        from geomesa_tpu_torch.index import zkeys
        root = str(tmp_path)
        ds, n = _fs_write(root)
        want = _ids(ds.query(FS_ECQL, "ais"))
        assert ds.persist_index("ais")
        re = FsBackedDistributedDataStore(root, tmesh())

        def no_sort(*a, **k):
            raise AssertionError("z-key sort ran on a reopen with a sidecar")
        monkeypatch.setattr(zkeys, "sort_bin_z", no_sort)
        monkeypatch.setattr(zkeys, "sort_z", no_sort)
        assert _ids(re.query(FS_ECQL, "ais")) == want

    def test_partition_shard_placement(self, tmp_path):
        ds, n = _fs_write(str(tmp_path))
        parts = ds.partitions("ais")
        assert len(parts) > 1
        shards = ds.partition_shards("ais")
        assert set(shards) <= set(parts)
        for devs in shards.values():
            assert devs and all(0 <= d < ds.mesh.size for d in devs)
        assert set().union(*shards.values()) == set(range(ds.mesh.size))
        jds, _ = _fs_write(str(tmp_path / "j"), jax=True)
        assert shards == jds.partition_shards("ais")

    def test_write_through_durability(self, tmp_path):
        from geomesa_tpu_torch.store import FileSystemDataStore
        ds, n = _fs_write(str(tmp_path))
        fs = FileSystemDataStore(str(tmp_path), device="cpu")
        assert fs.count("ais") == n
        assert sorted(_ids(fs.query("name = 'n3'", "ais"))) == sorted(
            _ids(ds.query("name = 'n3'", "ais")))

    def test_delete_propagates(self, tmp_path):
        root = str(tmp_path)
        ds, n = _fs_write(root)
        ds.delete("ais", [f"f{i}" for i in range(50)])
        assert ds.count("ais") == n - 50
        re = FsBackedDistributedDataStore(root, tmesh())
        assert re.count("ais") == n - 50
        assert not ({f"f{i}" for i in range(50)}
                    & set(_ids(re.query("INCLUDE", "ais"))))

    def test_foreign_sidecar_refused_on_single_id_mismatch(self, tmp_path):
        rng = np.random.default_rng(37)
        n = 5_000
        dtg = rng.integers(MS("2021-03-01"), MS("2021-03-20"), n)
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)

        def build(root, ids):
            ds = FsBackedDistributedDataStore(root, tmesh())
            ds.create_schema(parse_spec("ais", "dtg:Date,*geom:Point:srid=4326"))
            ds.write_dict("ais", ids, {"dtg": dtg, "geom": (x, y)})
            ds.query("BBOX(geom, -90, -45, 90, 45)", "ais")
            assert ds.persist_index("ais")
            return ds

        ids_a = [f"f{i}" for i in range(n)]
        ids_b = list(ids_a)
        ids_b[2471] = "f2471x"
        root_a, root_b = str(tmp_path / "a"), str(tmp_path / "b")
        a, b = build(root_a, ids_a), build(root_b, ids_b)
        assert a._ids_digest("ais") != b._ids_digest("ais")
        own = FsBackedDistributedDataStore(root_b, tmesh())
        assert own._state("ais").zindex_warm is not None
        shutil.copy(
            os.path.join(root_a, "ais", "index_mesh", "orders.npz"),
            os.path.join(root_b, "ais", "index_mesh", "orders.npz"))
        re = FsBackedDistributedDataStore(root_b, tmesh())
        assert re._state("ais").zindex_warm is None
        got = set(_ids(re.query("BBOX(geom, -90, -45, 90, 45)", "ais")))
        hit = (x >= -90) & (x <= 90) & (y >= -45) & (y <= 45)
        assert got == {ids_b[i] for i in np.flatnonzero(hit)}

    def test_corrupt_sidecar_rebuilds(self, tmp_path):
        root = str(tmp_path)
        ds, n = _fs_write(root)
        want = _ids(ds.query(FS_ECQL, "ais"))
        assert ds.persist_index("ais")
        with open(os.path.join(root, "ais", "index_mesh", "orders.npz"),
                  "wb") as fh:
            fh.write(b"not an npz")
        re = FsBackedDistributedDataStore(root, tmesh())
        assert re._state("ais").zindex_warm is None
        assert _ids(re.query(FS_ECQL, "ais")) == want

    def test_reopen_with_quoted_partition_names(self, tmp_path):
        from geomesa_tpu_torch.store import AttributeScheme
        root = str(tmp_path)
        ds = FsBackedDistributedDataStore(root, tmesh())
        ds.create_schema(parse_spec("t", "name:String,*geom:Point"),
                         scheme=AttributeScheme("name"))
        ds.write_dict("t", [f"f{i}" for i in range(10)], {
            "name": ["a b" if i % 2 else "x:y" for i in range(10)],
            "geom": (np.linspace(0, 9, 10), np.linspace(0, 9, 10)),
        })
        assert ds.count("t") == 10
        re = FsBackedDistributedDataStore(root, tmesh())
        assert re.count("t") == 10
        assert set(_ids(re.query("INCLUDE", "t"))) == {f"f{i}"
                                                       for i in range(10)}
        assert set(ds.partition_shards("t")) == set(ds.partitions("t"))

    def test_partition_shards_after_delete(self, tmp_path):
        ds, n = _fs_write(str(tmp_path))
        ds.delete("ais", [f"f{i}" for i in range(10)])
        assert ds.partition_shards("ais")

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_root_and_sidecar_open_across_packages(self, tmp_path, writer):
        """A root and its index_mesh sidecar written by either package
        open in the other: the same rows in the same order, the sidecar
        adopted (its ids digest agrees), the same answers."""
        root = str(tmp_path)
        ds, n = _fs_write(root, jax=writer == "jax")
        want = _ids(ds.query(FS_ECQL, "ais"))
        assert ds.persist_index("ais")
        if writer == "jax":
            re = FsBackedDistributedDataStore(root, tmesh())
        else:
            re = JFsMesh(root, jdata_mesh())
        assert re.count("ais") == n
        assert re._state("ais").zindex_warm is not None
        assert re._ids_digest("ais") == ds._ids_digest("ais")
        assert _ids(re.query(FS_ECQL, "ais")) == want
        assert re.partition_shards("ais") == ds.partition_shards("ais")


def test_mesh_sidecar_rejected_after_reindex(tmp_path):
    """A reindex through the durable parent moves the schema to the
    current index version; the fs-mesh tier's sidecar, which carries
    the old version, is rejected on reopen (lazy rebuild), and a sidecar
    persisted under the new version round-trips."""
    from geomesa_tpu_torch.features.sft import CURRENT_INDEX_VERSION
    spec_v1 = ("kind:String,dtg:Date,*geom:Point:srid=4326;"
               "geomesa.index.version='1'")
    ecql = ("BBOX(geom, -10, -10, 10, 10) AND "
            "dtg DURING 2017-01-02T00:00:00Z/2017-01-05T00:00:00Z")
    rng = np.random.default_rng(0)
    n = 4_000
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(MS("2017-01-01"), MS("2017-01-20"), n)
    hit = ((x >= -10) & (x <= 10) & (y >= -10) & (y <= 10)
           & (ms > MS("2017-01-02")) & (ms < MS("2017-01-05")))
    want = {f"e{i}" for i in np.flatnonzero(hit)}
    mesh = FsBackedDistributedDataStore(str(tmp_path), tmesh())
    mesh.create_schema(parse_spec("events", spec_v1))
    mesh.write_dict("events", [f"e{i}" for i in range(n)],
                    {"kind": ["k"] * n, "dtg": ms, "geom": (x, y)})
    assert set(_ids(mesh.query(ecql, "events"))) == want
    assert mesh.persist_index("events") is True
    fs = mesh.fs
    assert set(_ids(fs.query(ecql, "events"))) == want
    fs.reindex("events")
    assert fs.get_schema("events").index_version == CURRENT_INDEX_VERSION
    assert set(_ids(fs.query(ecql, "events"))) == want
    mesh2 = FsBackedDistributedDataStore(str(tmp_path), tmesh())
    assert mesh2.get_schema("events").index_version == CURRENT_INDEX_VERSION
    assert set(_ids(mesh2.query(ecql, "events"))) == want
    assert mesh2._state("events").zindex.version == CURRENT_INDEX_VERSION
    assert mesh2.persist_index("events") is True
    mesh3 = FsBackedDistributedDataStore(str(tmp_path), tmesh())
    assert set(_ids(mesh3.query(ecql, "events"))) == want
    assert mesh3._state("events").zindex.version == CURRENT_INDEX_VERSION


def test_sampling_on_mesh_store():
    from geomesa_tpu.analytics.processes import \
        sampling_process as jsampling
    from geomesa_tpu_torch.analytics.processes import sampling_process
    rng = np.random.default_rng(9)
    n = 1000
    data = {"dtg": rng.integers(0, 10**12, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    ds, jds = tdist(), JDist(jdata_mesh())
    for s, parse in ((ds, parse_spec), (jds, jparse_spec)):
        s.create_schema(parse("s", "dtg:Date,*geom:Point:srid=4326"))
        s.write_dict("s", [f"f{i}" for i in range(n)], data)
    res = sampling_process(ds, "s", rate=0.1)
    assert 50 <= res.n <= 150
    assert _ids(res) == _ids(jsampling(jds, "s", rate=0.1))


def test_one_shard_mesh_equals_eight(stores):
    """The same rows on a one-shard mesh: the same answers as eight."""
    dist, mem, jdist = stores
    one = DistributedDataStore(data_mesh(1, device="cpu"))
    one.create_schema(parse_spec("pts", SPEC))
    one.write("pts", mem._state("pts").batch)
    for ecql in QUERIES[:2] + ["BBOX(geom, -180, -90, 180, 0)"]:
        assert _ids(one.query(ecql, "pts")) == _ids(dist.query(ecql, "pts"))
        assert one.query_count(ecql, "pts") == dist.query_count(ecql, "pts")
    bbox = (-180.0, -90.0, 180.0, 90.0)
    assert one.density("pts", "INCLUDE", bbox, 90, 45).tobytes() == \
        dist.density("pts", "INCLUDE", bbox, 90, 45).tobytes()
    assert list(one.knn("pts", 3.0, 4.0, 20)) == list(dist.knn("pts", 3.0,
                                                               4.0, 20))
