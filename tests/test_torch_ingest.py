"""The port's group-commit ingest pipeline (``ingest/``) against the JAX
package's on the CPU: the writer thread's groups and the fsyncs they
cost, acks, errors through acks, the latency-derived group cap, the
row-token governor (blocking, non-blocking refusal, an oversize batch
admitted alone), the shed pause on the read batchers' queue depth, the
group-commit span and its links, a kill image copied mid-ingest, and
the thread-local off switch of the vectorized converter.

Each scenario runs the same staged batches in both packages. Tolerance:
exact: group and fsync counts, counters, acked rows and query answers
are equal. The staging thread holds the pipeline's queue lock while it
stages, so the writer drains the same groups in both packages."""

import math
import shutil
import threading
import time
import types

import numpy as np
import pytest

import geomesa_tpu.ingest as j_ingest
import geomesa_tpu.metrics as j_metrics
import geomesa_tpu.obs as j_obs
import geomesa_tpu.scan.registry as j_scanreg
import geomesa_tpu.tenants as j_tenants
from geomesa_tpu.convert.converter import converter_for as j_converter_for
from geomesa_tpu.convert.dsl import EvaluationContext as JContext
from geomesa_tpu.convert.vectorized import INGEST_VECTORIZED as J_VEC
from geomesa_tpu.features import FeatureBatch as JFeatureBatch
from geomesa_tpu.features import parse_spec as j_parse_spec
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.store.memory import InMemoryDataStore as JStore
import geomesa_tpu_torch.ingest as t_ingest
import geomesa_tpu_torch.metrics as t_metrics
import geomesa_tpu_torch.obs as t_obs
import geomesa_tpu_torch.scan.registry as t_scanreg
import geomesa_tpu_torch.tenants as t_tenants
from geomesa_tpu_torch.convert.converter import converter_for as t_converter_for
from geomesa_tpu_torch.convert.dsl import EvaluationContext as TContext
from geomesa_tpu_torch.convert.vectorized import INGEST_VECTORIZED as T_VEC
from geomesa_tpu_torch.features import FeatureBatch as TFeatureBatch
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.index.api import Query as TQuery
from geomesa_tpu_torch.store.memory import InMemoryDataStore as TStore
from geomesa_tpu_torch.utils.properties import INGEST_SHED_QUEUE_DEPTH

pytestmark = pytest.mark.ingest

J = types.SimpleNamespace(
    name="jax", ingest=j_ingest, metrics=j_metrics.metrics, obs=j_obs,
    scanreg=j_scanreg, tenants=j_tenants, FeatureBatch=JFeatureBatch,
    parse_spec=j_parse_spec, Query=JQuery, Store=JStore,
    store=lambda **kw: JStore(**kw), converter_for=j_converter_for,
    Context=JContext, VEC=J_VEC)
T = types.SimpleNamespace(
    name="torch", ingest=t_ingest, metrics=t_metrics.metrics, obs=t_obs,
    scanreg=t_scanreg, tenants=t_tenants, FeatureBatch=TFeatureBatch,
    parse_spec=t_parse_spec, Query=TQuery, Store=TStore,
    store=lambda **kw: TStore(device="cpu", **kw),
    converter_for=t_converter_for, Context=TContext, VEC=T_VEC)
PKGS = (J, T)

SPEC = "name:String,mmsi:Integer,dtg:Date,speed:Double,*geom:Point:srid=4326"
QUERY = ("BBOX(geom, -60, -30, 60, 30) AND dtg DURING "
         "2017-03-01T00:00:00Z/2017-03-01T12:00:00Z")


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    for P in PKGS:
        P.ingest.INGEST_SHED_QUEUE_DEPTH.set(None)
        P.ingest.INGEST_LATENCY_BUDGET_MS.set(None)
        P.scanreg.batcher_registry.clear()
        P.obs.trace.TRACE_SAMPLE.set(None)
        P.obs.tracer.clear()
        P.tenants.QOS_ENABLED.set(None)
        P.tenants.tenant_registry.reset()


def _batch(P, n, start=0):
    rng = np.random.default_rng(start)
    sft = P.parse_spec("boats", SPEC)
    return P.FeatureBatch.from_dict(sft, [f"b{i}" for i in range(
        start, start + n)], {
        "name": np.array([f"n{i % 13}" for i in range(n)], dtype=object),
        "mmsi": np.arange(start, start + n, dtype=np.int64),
        "dtg": 1488326400000 + rng.integers(0, 86_400_000, n),
        "speed": np.linspace(0, 30, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    })


def _counter(P, name) -> int:
    return P.metrics.snapshot()["counters"].get(name, 0)


def _ids(res) -> list:
    return sorted(str(i) for i in res.ids)


def stage_all(P, pipe, items, **kw):
    """Stage every (type, batch) while holding the pipeline's queue lock
    (reentrant), with the latency-derived cap off (it follows the host's
    write times), so the writer drains the same groups in each
    package."""
    P.ingest.INGEST_LATENCY_BUDGET_MS.set("0")
    with pipe._cv:
        return [pipe.write(tn, b, **kw) for tn, b in items]


# -- group commit ---------------------------------------------------------------

@pytest.mark.parametrize("fsync", ["always", "never"])
@pytest.mark.parametrize("sizes,group_rows", [
    ([1024] * 8, 4096),
    ([1000, 3000, 500, 4096, 1, 2000, 2000, 700], 4096),
    ([300] * 20, 1000),
    ([5000, 10, 10], 1024),
])
def test_groups_and_fsyncs_equal_reference(tmp_path, fsync, sizes,
                                           group_rows):
    """The same staged batches under the same group cap give the JAX
    pipeline's groups, staged batches and fsyncs, and the same rows
    (the "interval" policy syncs on a timer, so its count is not a
    function of the groups)."""
    def run(P):
        ds = P.store(durable_dir=str(tmp_path / P.name), wal_fsync=fsync)
        ds.create_schema(P.parse_spec("boats", SPEC))
        f0, g0, s0 = (_counter(P, "wal.fsyncs"), _counter(P, "ingest.groups"),
                      _counter(P, "ingest.staged.batches"))
        starts = np.cumsum([0] + sizes[:-1])
        with P.ingest.IngestPipeline(ds, group_rows=group_rows) as pipe:
            acks = stage_all(P, pipe, [("boats", _batch(P, n, int(s)))
                                       for n, s in zip(sizes, starts)])
            for a in acks:
                a.wait(timeout=30.0)
        out = (_counter(P, "wal.fsyncs") - f0,
               _counter(P, "ingest.groups") - g0,
               _counter(P, "ingest.staged.batches") - s0,
               ds.count("boats"), _ids(ds.query(QUERY, "boats")))
        ds.close()
        return out
    want, got = both(run)
    assert got == want
    fsyncs, groups, staged, rows, _ = got
    assert staged == len(sizes) and rows == sum(sizes)
    assert groups <= staged
    assert groups >= math.ceil(sum(sizes) / max(group_rows, max(sizes)))
    assert fsyncs <= groups + 1 if fsync == "always" else fsyncs == 0


class TestGroupCommit:
    def test_fsyncs_bounded_by_groups_not_writes(self, tmp_path):
        def run(P):
            ds = P.store(durable_dir=str(tmp_path / P.name),
                         wal_fsync="always")
            ds.create_schema("boats", SPEC)
            n_batches, rows_each, group_rows = 8, 1024, 4096
            f0 = _counter(P, "wal.fsyncs")
            staged = threading.Event()
            real = ds.write_many

            def gated(type_name, items):
                staged.wait(timeout=10.0)
                return real(type_name, items)
            ds.write_many = gated
            with P.ingest.IngestPipeline(ds, group_rows=group_rows) as pipe:
                acks = [pipe.write("boats", _batch(P, rows_each,
                                                   i * rows_each))
                        for i in range(n_batches)]
                staged.set()
                for a in acks:
                    a.wait(timeout=30.0)
            syncs = _counter(P, "wal.fsyncs") - f0
            max_groups = 1 + math.ceil(
                (n_batches - 1) * rows_each / group_rows)
            assert syncs <= max_groups and syncs < n_batches
            assert ds.count("boats") == n_batches * rows_each
            ds.close()
            return ds.count("boats")
        assert both(run) == (8192, 8192)

    def test_acks_cover_every_staged_batch(self):
        def run(P):
            ds = P.store()
            ds.create_schema("boats", SPEC)
            with P.ingest.IngestPipeline(ds, group_rows=10_000) as pipe:
                acks = [pipe.write("boats", _batch(P, 100, i * 100))
                        for i in range(5)]
                for a in acks:
                    a.wait(timeout=10.0)
                    assert a.done
                empty = pipe.write("boats", _batch(P, 0))
                assert empty.done and empty.wait() is None
            return ds.count("boats"), _ids(ds.query(QUERY, "boats"))
        want, got = both(run)
        assert got == want and got[0] == 500

    def test_write_error_propagates_through_ack(self):
        def run(P):
            ds = P.store()
            ds.create_schema("boats", SPEC)
            e0 = _counter(P, "ingest.errors")
            with P.ingest.IngestPipeline(ds) as pipe:
                ack = pipe.write("missing-type", _batch(P, 10))
                with pytest.raises(KeyError):
                    ack.wait(timeout=10.0)
            with pytest.raises(RuntimeError, match="closed"):
                pipe.write("boats", _batch(P, 1))
            return _counter(P, "ingest.errors") - e0
        assert both(run) == (1, 1)

    def test_latency_budget_shrinks_group_cap(self):
        def run(P):
            pipe = P.ingest.IngestPipeline(P.store(), group_rows=131072)
            try:
                caps = [pipe.effective_group_rows()]
                pipe._cost_ewma = 0.010
                caps.append(pipe.effective_group_rows())
                pipe._cost_ewma = 0.00001
                caps.append(pipe.effective_group_rows())
                pipe._cost_ewma = None
                pipe._observe(1000, 0.5)
                pipe._observe(1000, 0.05)
                caps.append(pipe.effective_group_rows())
                return caps, pipe._cost_ewma, pipe._rate_ewma
            finally:
                pipe.close()
        want, got = both(run)
        assert got == want
        assert got[0][:2] == [131072, 1024]
        assert 49_000 <= got[0][2] <= 50_000

    def test_group_commit_span_links_staged_callers(self):
        """With tracing on, each group commits under a ``group-commit``
        root span linked both ways to every staged caller's span."""
        def run(P):
            P.obs.trace.TRACE_SAMPLE.set("1")
            P.obs.tracer.clear()
            ds = P.store()
            ds.create_schema("boats", SPEC)
            with P.ingest.IngestPipeline(ds, group_rows=4096) as pipe, \
                    P.obs.tracer.span("request", "writes", root=True):
                acks = stage_all(P, pipe, [("boats", _batch(P, 100, i * 100))
                                           for i in range(3)])
                for a in acks:
                    a.wait(timeout=10.0)
            traces = P.obs.tracer.traces()
            spans = [s for t in traces for s in P.obs.tracer.get(
                t["trace_id"])]
            commits = [s for s in spans if s["kind"] == "group-commit"]
            requests = [s for s in spans if s["kind"] == "request"]
            return (len(commits), [s["attrs"] for s in commits],
                    sorted(len(s.get("links", [])) for s in commits),
                    sorted(len(s.get("links", [])) for s in requests))
        want, got = both(run)
        assert got == want
        assert got[0] == 1 and got[1] == [{"rows": 300, "staged": 3}]
        assert got[2] == [3] and got[3] == [3]

    def test_commit_is_watched_by_the_stall_watchdog(self):
        def run(P):
            seen = []
            ds = P.store()
            ds.create_schema("boats", SPEC)
            real = ds.write_many

            def spy(type_name, items):
                seen.append(sorted(op["key"] for op in
                                   P.obs.watchdog._active.values()))
                return real(type_name, items)
            ds.write_many = spy
            with P.ingest.IngestPipeline(ds) as pipe:
                pipe.write("boats", _batch(P, 10)).wait(timeout=10.0)
            return seen
        want, got = both(run)
        assert got == want == [["ingest.commit.boats"]]


class TestGovernor:
    def test_blocking_acquire_waits_for_release(self):
        gov = t_ingest.IngestGovernor(max_inflight_rows=100)
        assert gov.acquire(80)
        done = threading.Event()

        def second():
            assert gov.acquire(80, timeout=10.0)
            done.set()
        t = threading.Thread(target=second)
        t.start()
        time.sleep(0.05)
        assert not done.is_set()
        gov.release(80)
        t.join(timeout=10.0)
        assert done.is_set()
        gov.release(80)
        assert gov.inflight_rows == 0
        assert gov.wait_idle(timeout=1.0)

    def test_nonblocking_refusal_counts(self):
        def run(P):
            gov = P.ingest.IngestGovernor(max_inflight_rows=100)
            before = _counter(P, "ingest.backpressure.refused")
            assert gov.acquire(100)
            assert not gov.acquire(1, block=False)
            assert not gov.acquire(1, timeout=0.01)
            after = _counter(P, "ingest.backpressure.refused")
            gov.release(100)
            return after - before, gov.inflight_rows
        assert both(run) == ((2, 0), (2, 0))

    def test_oversize_batch_admitted_alone(self):
        def run(P):
            gov = P.ingest.IngestGovernor(max_inflight_rows=10)
            out = [gov.acquire(50, timeout=1.0),
                   gov.acquire(1, block=False)]
            gov.release(50)
            out.append(gov.acquire(1, block=False))
            gov.release(1)
            return out
        assert both(run) == ([True, False, True], [True, False, True])

    def test_pipeline_refuses_nonblocking_when_full(self):
        def run(P):
            ds = P.store()
            ds.create_schema("boats", SPEC)
            gate = threading.Event()
            real = ds.write_many
            ds.write_many = lambda tn, items: (gate.wait(10.0),
                                               real(tn, items))[1]
            with P.ingest.IngestPipeline(ds, max_inflight_rows=150) as pipe:
                a = pipe.write("boats", _batch(P, 100))
                refused = pipe.write("boats", _batch(P, 100, 100),
                                     block=False)
                gate.set()
                a.wait(timeout=10.0)
            return refused, ds.count("boats")
        assert both(run) == ((None, 100), (None, 100))

    def test_tenant_row_bucket(self):
        """With QoS on, a tenant's staged rows are charged to its row
        bucket and credited when the group commits."""
        def run(P):
            P.tenants.QOS_ENABLED.set("true")
            prop = type(P.ingest.INGEST_SHED_QUEUE_DEPTH)(
                "geomesa.qos.tenant.small.max.inflight.rows", None)
            prop.set("150")
            try:
                ds = P.store()
                ds.create_schema("boats", SPEC)
                gate = threading.Event()
                real = ds.write_many
                ds.write_many = lambda tn, items: (gate.wait(10.0),
                                                   real(tn, items))[1]
                with P.ingest.IngestPipeline(ds) as pipe:
                    with P.tenants.tenant_scope("small"):
                        a = pipe.write("boats", _batch(P, 100))
                        refused = pipe.write("boats", _batch(P, 100, 100),
                                             block=False)
                    gate.set()
                    a.wait(timeout=10.0)
                    with P.tenants.tenant_scope("small"):
                        b = pipe.write("boats", _batch(P, 100, 200),
                                       block=False)
                    b.wait(timeout=10.0)
                st = P.tenants.tenant_registry.status()["tenants"]["small"]
                return refused, ds.count("boats"), pipe.governor.inflight_rows, \
                    st.get("rows")
            finally:
                prop.set(None)
        want, got = both(run)
        assert got == want and got[:3] == (None, 200, 0)


# -- the shed pause -----------------------------------------------------------

def _gating_store(P):
    class Gating(P.Store):
        """Holds the first query it answers until ``hold`` is set."""
        hold = None

        def query(self, q, *a, **k):
            hold, self.hold = self.hold, None
            if hold is not None:
                hold.wait(10.0)
            return super().query(q, *a, **k)
    kw = {"device": "cpu"} if P is T else {}
    return Gating(**kw)


def test_shed_pause_on_a_deep_read_queue():
    """A shared batcher's queue is held deep (one query in flight, five
    queued behind a lingering leader): the writer pauses once a group
    while the depth passes ``geomesa.ingest.shed.queue.depth``, and not
    once the queue drains."""
    def run(P):
        reads = _gating_store(P)
        reads.create_schema("boats", SPEC)
        reads.write("boats", _batch(P, 500))
        b = P.scanreg.shared_batcher(reads, max_batch=6,
                                     linger_us=30_000_000, adaptive=False)
        hold = reads.hold = threading.Event()
        q = P.Query("boats", "BBOX(geom, -90, -45, 90, 45)")
        threads = [threading.Thread(target=b.query, args=(q,))]
        threads[0].start()
        deadline = time.monotonic() + 10
        while b._in_flight < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        for _ in range(5):
            threads.append(threading.Thread(target=b.query, args=(q,)))
            threads[-1].start()
        while (P.scanreg.batcher_registry.queue_depths().get("boats", 0) < 5
               and time.monotonic() < deadline):
            time.sleep(0.002)
        P.ingest.INGEST_SHED_QUEUE_DEPTH.set("3")
        writes = P.store()
        writes.create_schema("boats", SPEC)
        gov = P.ingest.IngestGovernor()
        try:
            depth = gov.read_queue_depth()
            shed = gov.should_shed()
            p0 = _counter(P, "ingest.shed.pauses")
            with P.ingest.IngestPipeline(writes, group_rows=1000,
                                         governor=gov) as pipe:
                acks = stage_all(P, pipe, [("boats", _batch(P, 600, i * 600))
                                           for i in range(3)])
                for a in acks:
                    a.wait(timeout=10.0)
                paused = _counter(P, "ingest.shed.pauses") - p0
                # the sixth query fills the batch: the leader dispatches
                threads.append(threading.Thread(target=b.query, args=(q,)))
                threads[-1].start()
                hold.set()
                for t in threads:
                    t.join(10.0)
                assert not any(t.is_alive() for t in threads)
                drained = (gov.read_queue_depth(), gov.should_shed())
                pipe.write("boats", _batch(P, 10, 5000)).wait(timeout=10.0)
                after = _counter(P, "ingest.shed.pauses") - p0
        finally:
            hold.set()
            P.ingest.INGEST_SHED_QUEUE_DEPTH.set(None)
        return depth, shed, paused, drained, after, writes.count("boats")
    want, got = both(run)
    assert got == want
    assert got == (5, True, 3, (0, False), 3, 1810)


def test_shed_threshold_lives_in_properties():
    assert t_ingest.INGEST_SHED_QUEUE_DEPTH is INGEST_SHED_QUEUE_DEPTH
    gov = t_ingest.IngestGovernor()
    INGEST_SHED_QUEUE_DEPTH.set("0")
    try:
        assert gov.should_shed() is False   # 0 disables the signal
    finally:
        INGEST_SHED_QUEUE_DEPTH.set(None)


# -- the kill image -------------------------------------------------------------

def test_kill_image_recovers_every_acked_row(tmp_path):
    """A copy of the durable directory taken while the writer thread
    runs reopens (in either package) with at least every row acked
    before the copy began."""
    live, img = tmp_path / "live", tmp_path / "img"
    ds = TStore(device="cpu", durable_dir=str(live), wal_fsync="always")
    ds.create_schema("boats", SPEC)
    acks = []
    with t_ingest.IngestPipeline(ds, group_rows=8192) as pipe:
        for i in range(40):
            acks.append((pipe.write("boats", _batch(T, 1024, i * 1024)),
                         1024))
            if i == 20:
                # let some groups commit, then copy under the writer
                acks[0][0].wait(timeout=10.0)
                acked = sum(n for a, n in acks if a.done)
                shutil.copytree(live, img)
    ds.close()
    assert acked >= 1024
    for P in PKGS:
        kw = {"durable_dir": str(img), "wal_fsync": "always"}
        back = P.store(**kw)
        got = back.count("boats")
        assert acked <= got <= 40 * 1024 and got % 1024 == 0
        ids = set(str(i) for i in back.query("INCLUDE", "boats").ids)
        assert len(ids) == got
        back.close()


# -- the converter's thread-local off switch ------------------------------------

def test_scalar_leg_off_switch_is_per_thread():
    """``geomesa.ingest.vectorized`` off for one thread (config 16's
    scalar leg): that thread converts record at a time, others stay
    columnar, and both give the JAX converter's batches."""
    conf = {"type": "delimited-text", "format": "CSV",
            "id-field": "concat('v', $2)",
            "fields": [{"name": "name", "transform": "$1"},
                       {"name": "mmsi", "transform": "$2::int"},
                       {"name": "dtg", "transform": "isoDate($3)"},
                       {"name": "speed", "transform": "$6::double"},
                       {"name": "geom",
                        "transform": "point($4::double, $5::double)"}]}
    text = "".join(f"vessel{i % 7},{i},2017-03-01T{i % 24:02d}:15:00Z,"
                   f"{-170 + i * 0.7:.5f},{-80 + i * 0.3:.5f},{i % 30}.5\n"
                   for i in range(400))

    def run(P):
        conv = P.converter_for(P.parse_spec("boats", SPEC), conf)
        out = {}

        def convert(tag, off):
            if off:
                P.VEC.thread_local_set("false")
            try:
                ctx = P.Context()
                bs = [b for b, _ in conv.iter_batches(text, ctx,
                                                      batch_rows=64)]
                out[tag] = ([str(i) for b in bs for i in b.ids],
                            ctx.counters(), bool(P.VEC.as_bool()))
            finally:
                P.VEC.thread_local_set(None)
        t = threading.Thread(target=convert, args=("scalar", True))
        t.start()
        t.join(30)
        convert("vectorized", False)
        return out
    want, got = both(run)
    assert got == want
    assert got["scalar"][2] is False and got["vectorized"][2] is True
    assert got["scalar"][:2] == got["vectorized"][:2]
