"""The port's batch jobs (``geomesa_tpu_torch.jobs``) against the JAX
package's on the CPU.

``TestJobs`` of ``tests/test_jobs_partitioning.py`` runs here, each
scenario in both packages (``both(fn)``) on stores built from the same
numpy seed (the port's on ``device="cpu"``): the reference's assertions
kept, and the outcomes held equal: split bounds, copied and ingested ids
in order, converter counts, the plan an attribute query takes after
``AttributeIndexJob`` and its ids. No comparison here has a tolerance.

The ``gpu`` test at the end copies a type into a CUDA store and ingests
files into one through the jobs' thread pools (``python -m pytest
--noconftest -m gpu tests/test_torch_jobs.py``)."""

import importlib
import threading
import types

import numpy as np
import pytest
import torch

SPEC = "name:String,age:Integer,*geom:Point:srid=4326"
CONF = {"type": "delimited-text", "id-field": "$2",
        "fields": [
            {"name": "name", "transform": "$1"},
            {"name": "age", "transform": "$2::int"},
            {"name": "geom",
             "transform": "point($3::double, $4::double)"}]}


def _ns(pkg, cpu):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    store = m("store.memory").InMemoryDataStore

    def make(**kw):
        if cpu:
            kw.setdefault("device", "cpu")
        return store(**kw)

    def fs(root):
        cls = m("store.fs").FileSystemDataStore
        return cls(root, device="cpu") if cpu else cls(root)

    return types.SimpleNamespace(
        pkg=pkg, m=m, store=make, fs=fs, jobs=m("jobs"),
        Z2Scheme=m("store.partitions").Z2Scheme,
        FeatureBatch=m("features.batch").FeatureBatch,
        parse_spec=m("features.sft").parse_spec)


T = _ns("geomesa_tpu_torch", cpu=True)
try:        # the CPU tests hold the port to the JAX package
    import geomesa_tpu  # noqa: F401
    J = _ns("geomesa_tpu", cpu=False)
    PKGS = (J, T)
except ImportError:     # the card's machine has no JAX: gpu tests only
    J = None
    PKGS = (T,)

needs_jax = pytest.mark.skipif(J is None, reason="needs JAX")


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


def seeded(P, n=1000, seed=0, **kw):
    rng = np.random.default_rng(seed)
    sft = P.parse_spec("pts", SPEC)
    ds = P.store(**kw)
    ds.create_schema(sft)
    ds.write("pts", P.FeatureBatch.from_dict(
        sft, [f"p{i}" for i in range(n)],
        {"name": [f"n{i % 5}" for i in range(n)],
         "age": np.arange(n),
         "geom": (rng.uniform(-50, 50, n), rng.uniform(-30, 30, n))}))
    return ds


def ids_of(ds, tn="pts", ecql="INCLUDE"):
    res = ds.query(ecql, tn)
    return [] if res.batch is None else [str(i) for i in res.ids]


def write_files(tmp_path, k=6, rows=10):
    files = []
    for i in range(k):
        f = tmp_path / f"in{i}.csv"
        f.write_text("".join(f"name{i},{i * 10 + j},{j}.0,{i}.0\n"
                             for j in range(rows)))
        files.append(str(f))
    return files


def test_exports_equal_reference():
    j = importlib.import_module("geomesa_tpu.jobs")
    t = importlib.import_module("geomesa_tpu_torch.jobs")
    assert j.__all__ == t.__all__


@needs_jax
class TestJobs:
    def test_query_splits_cover_all(self):
        def run(P):
            ds = seeded(P, 100)
            splits = P.jobs.query_splits(ds, "pts", "age < 50", n_splits=4)
            total = sum(hi - lo for _, lo, hi in (s.payload for s in splits))
            assert total == 50 and len(splits) == 4
            return [(s.index, s.kind, s.payload[1], s.payload[2],
                     [str(i) for i in s.payload[0].ids]) for s in splits]
        j, t = both(run)
        assert t == j

    def test_run_job_reduce(self):
        def run(P):
            ds = seeded(P, 100)
            splits = P.jobs.query_splits(ds, "pts", n_splits=7)

            def count(split):
                b, lo, hi = split.payload
                return hi - lo

            total = P.jobs.run_job(count, splits, reduce_fn=sum)
            assert total == 100
            return total, P.jobs.run_job(count, splits), \
                P.jobs.run_job(count, [], reduce_fn=sum)
        j, t = both(run)
        assert t == j

    def test_schema_copy(self):
        def run(P):
            src = seeded(P, 200)
            dst = P.store()
            n = P.jobs.SchemaCopyJob(src, dst).run("pts", "age < 120")
            assert n == 120
            assert dst.count("pts") == 120
            assert sorted(ids_of(dst)) == sorted(ids_of(src, ecql="age < 120"))
            return n, sorted(ids_of(dst)), dst.get_schema("pts").to_spec()
        j, t = both(run)
        assert t == j

    def test_converter_ingest_parallel(self, tmp_path):
        files = write_files(tmp_path)

        def run(P):
            sft = P.parse_spec("ing", SPEC)
            ds = P.store()
            counts = P.jobs.ConverterIngestJob(ds, sft, CONF,
                                               n_workers=3).run(files)
            assert counts == {"success": 60, "failure": 0, "files": 6}
            assert ds.count("ing") == 60
            res = ds.query("INCLUDE", "ing")
            rows = sorted((str(res.ids[i]), res.batch.col("name").value(i),
                           res.batch.col("age").value(i))
                          for i in range(res.n))
            return counts, rows
        j, t = both(run)
        assert t == j

    def test_fs_partition_splits(self, tmp_path):
        def run(P):
            ds = P.fs(str(tmp_path / P.pkg / "fs"))
            sft = P.parse_spec("pts", SPEC)
            ds.create_schema(sft, scheme=P.Z2Scheme(2))
            rng = np.random.default_rng(4)
            ds.write_dict("pts", [f"f{i}" for i in range(50)],
                          {"name": ["a"] * 50, "age": np.arange(50),
                           "geom": (rng.uniform(-170, 170, 50),
                                    rng.uniform(-80, 80, 50))})
            splits = P.jobs.fs_partition_splits(ds, "pts")
            assert len(splits) >= 2
            assert all(s.kind == "partition" for s in splits)
            return [(s.index, s.kind, s.payload) for s in splits]
        j, t = both(run)
        assert t == j

    def test_attribute_index_job(self):
        """The reference's case: a query before the job, the job, the
        same query again. Both packages keep the type's cached plan
        across the job (the job marks the index dirty and leaves the
        plan cache), so both plan as before and give the same ids."""
        def run(P):
            ds = seeded(P, 50)
            before = ds.query("name = 'n1'", "pts").plan.index
            n = P.jobs.AttributeIndexJob(ds).run("pts", "name")
            assert n == 50
            assert ds.get_schema("pts").attr("name").indexed
            res = ds.query("name = 'n1'", type_name="pts")
            assert res.n == 10
            missing = None
            try:
                P.jobs.AttributeIndexJob(ds).run("pts", "ghost")
            except KeyError as e:
                missing = f"KeyError: {e}"
            return (before, res.plan.index, [str(i) for i in res.ids],
                    ds.get_schema("pts").to_spec(), missing)
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("attr,ecql", [("name", "name = 'n1'"),
                                           ("age", "age = 17")])
    def test_attribute_index_job_then_query_plans_attr(self, attr, ecql):
        """The job on a type no query has planned yet: the next query on
        the attribute plans ``attr:<name>`` in both packages, with the
        same ids in the same order."""
        def run(P):
            ds = seeded(P, 5_000)
            assert P.jobs.AttributeIndexJob(ds).run("pts", attr) == 5_000
            res = ds.query(ecql, "pts")
            return res.plan.index, [str(i) for i in res.ids]
        j, t = both(run)
        assert t == j
        assert t[0] == f"attr:{attr}"


def test_run_job_threads_take_the_callers_device(monkeypatch):
    """A pool thread enters the caller's current CUDA device (none here:
    no CUDA is initialized on the CPU, so nothing is entered)."""
    entered = []
    jobs = T.jobs

    def scope(index):
        entered.append(index)
        import contextlib
        return contextlib.nullcontext()
    monkeypatch.setattr(jobs, "device_scope", scope)
    splits = [jobs.InputSplit(i, i) for i in range(5)]
    names = set()

    def work(s):
        names.add(threading.current_thread().name)
        return s.payload * 2

    assert jobs.run_job(work, splits, n_workers=3) == [0, 2, 4, 6, 8]
    assert entered == [None] * 5
    assert threading.current_thread().name not in names


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_jobs_into_cuda_stores(tmp_path):
    """SchemaCopyJob from a CPU store into a CUDA store and
    ConverterIngestJob into one, each through its thread pool: the ids
    equal the source's, and the copy's columns are on the card."""
    src = seeded(T, 20_000, device="cpu")
    dst = T.m("store.memory").InMemoryDataStore()
    assert T.jobs.SchemaCopyJob(src, dst, n_workers=4).run("pts") == 20_000
    assert sorted(ids_of(dst)) == sorted(ids_of(src))   # splits in any order
    dst._state("pts").ensure_index()
    assert dst._state("pts").scan_data.xhi.device.type == "cuda"
    files = write_files(tmp_path, k=8, rows=500)
    ing = T.m("store.memory").InMemoryDataStore()
    counts = T.jobs.ConverterIngestJob(ing, T.parse_spec("ing", SPEC), CONF,
                                       n_workers=4).run(files)
    assert counts == {"success": 4_000, "failure": 0, "files": 8}
    assert ing.count("ing") == 4_000
