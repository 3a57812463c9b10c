"""The port's QueryBatcher over the port's store on the CPU: passthrough
exactness, schema isolation, load-gated lingering, failure replay,
adaptive linger and the latency-derived caps. Results are held
against per-query ``query()`` and the JAX reference store, id for id.

Coalescing is driven deterministically rather than by racing threads:
a sacrificial query is gated inside the store (``GatingStore.hold``)
so the batcher has a dispatch in flight, which is exactly the condition
under which the load-gated leader lingers for followers. Filling the
queue to ``max_batch`` then releases the leader without waiting out the
linger window."""

import sys
import threading
import time

import numpy as np
import pytest

from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore, Query
from geomesa_tpu_torch.metrics import MetricsRegistry
from geomesa_tpu_torch.scan.batcher import QueryBatcher, _TypeQueue

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
GATE = "_gate"


class GatingStore(InMemoryDataStore):
    """The port's store on the CPU that records every dispatch the
    batcher makes and can gate a marked scalar ``query()`` on an event
    (to hold a dispatch in flight while the test stages followers). The
    gate hint is stripped before the store sees the query."""

    def __init__(self):
        super().__init__(device="cpu")
        self.scalar_calls: list[str] = []
        self.batched_calls: list[list[str]] = []
        self.hold: threading.Event | None = None

    def query(self, q, *args, **kwargs):
        if getattr(q, "type_name", None) is not None:
            self.scalar_calls.append(q.type_name)
        if getattr(q, "hints", {}).get(GATE):
            q = Query(q.type_name, q.filter)
            if self.hold is not None:
                assert self.hold.wait(10.0), "gated query never released"
        return super().query(q, *args, **kwargs)

    def query_batched(self, queries, *args, **kwargs):
        self.batched_calls.append([q.type_name for q in queries])
        return super().query_batched(queries, *args, **kwargs)


def _fill(ds, type_name: str, n: int = 5000, seed: int = 7):
    ds.create_schema(type_name, "dtg:Date,*geom:Point:srid=4326")
    rng = np.random.default_rng(seed)
    ds.write_dict(type_name, [f"{type_name}{i}" for i in range(n)], {
        "dtg": rng.integers(MS("2020-01-01"), MS("2020-03-01"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    })


def _ecql(x0: float, y0: float, w: float = 60, h: float = 40) -> str:
    return f"BBOX(geom, {x0}, {y0}, {x0 + w}, {y0 + h})"


def _bbox(tn: str, x0: float, y0: float, w: float = 60, h: float = 40):
    return Query(tn, _ecql(x0, y0, w, h))


def _reference(tn: str, x0: float, y0: float, seed: int = 7):
    """The JAX store's answer to the same query on the same rows."""
    ref = JaxStore()
    _fill(ref, tn, seed=seed)
    return list(ref.query(JQuery(tn, _ecql(x0, y0))).ids)


def _gated(tn: str):
    """A sacrificial query the store holds in flight (``GatingStore.hold``)
    so the next leader load-gates into its linger window."""
    q = _bbox(tn, -179.5, -89.5, 0.5, 0.5)
    q.hints[GATE] = True
    return q


def _wait(pred, timeout: float = 5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for batcher state")
        time.sleep(0.001)


def _queued(batcher, tn: str, k: int):
    return lambda: len(getattr(batcher._queues.get(tn), "items", ())) >= k


def _stage_coalesced(batcher, store, queries):
    """Run `queries` (one schema) through the batcher as ONE fused
    dispatch: gate a sacrificial scalar query so the next leader
    lingers, stage each query as it lands in the queue, and let the
    last arrival fill the batch. Returns results in submission order."""
    tn = queries[0].type_name
    store.hold = threading.Event()
    warm = threading.Thread(target=batcher.query, args=(_gated(tn),))
    warm.start()
    _wait(lambda: batcher._in_flight >= 1)
    out: list = [None] * len(queries)
    threads = []
    for k, q in enumerate(queries):
        t = threading.Thread(
            target=lambda k=k, q=q: out.__setitem__(k, batcher.query(q)))
        t.start()
        threads.append(t)
        if k < len(queries) - 1:
            _wait(_queued(batcher, tn, k + 1))
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), "batched caller never resolved"
    store.hold.set()
    warm.join(timeout=10.0)
    store.hold = None
    return out


class TestPassthrough:
    def test_single_query_matches_store_id_for_id(self):
        ds = GatingStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=8, linger_us=2000,
                         registry=MetricsRegistry())
        got = b.query(_bbox("ships", -30, -20))
        want = ds.query(_bbox("ships", -30, -20))
        assert np.array_equal(got.ids, want.ids)
        assert list(got.ids) == _reference("ships", -30, -20)
        # an idle singleton dispatches scalar, never via the fused path,
        # and does not pay the linger window
        assert ds.batched_calls == []
        assert b.stats()["total_queries"] == 1
        assert b.stats()["coalesced_queries"] == 0

    def test_filter_string_form(self):
        ds = GatingStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=8, linger_us=0)
        got = b.query("BBOX(geom, 0, 0, 60, 40)", type_name="ships")
        want = ds.query(_bbox("ships", 0, 0))
        assert np.array_equal(got.ids, want.ids)
        with pytest.raises(ValueError, match="type_name"):
            b.query("BBOX(geom, 0, 0, 1, 1)")

    def test_disabled_batching_passes_through(self):
        ds = GatingStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=1, linger_us=2000)
        got = b.query(_bbox("ships", 10, 5))
        assert np.array_equal(got.ids, ds.query(_bbox("ships", 10, 5)).ids)
        assert ds.batched_calls == []
        assert b._queues == {}

    def test_knn_belongs_to_a_later_slice(self):
        """The analytics slice brought knn: it answers as the JAX
        package's knn_process does, id for id (no longer raising)."""
        from geomesa_tpu.analytics.processes import knn_process
        ds = GatingStore()
        _fill(ds, "ships")
        ref = JaxStore()
        _fill(ref, "ships")
        b = QueryBatcher(ds, max_batch=8)
        ids, d = b.knn("ships", 0.0, 0.0, 5)
        want_ids, want_d = knn_process(ref, "ships", 0.0, 0.0, 5)
        assert list(ids) == list(want_ids) and np.array_equal(d, want_d)


class TestCoalescing:
    def test_batched_ids_exact(self):
        ds = GatingStore()
        _fill(ds, "ships")
        reg = MetricsRegistry()
        b = QueryBatcher(ds, max_batch=4, linger_us=1_000_000, adaptive=False,
                         registry=reg)
        corners = ((-150, -60), (-40, -10), (10, 20), (80, -35))
        queries = [_bbox("ships", x0, y0) for x0, y0 in corners]
        results = _stage_coalesced(b, ds, queries)
        assert ds.batched_calls == [["ships"] * 4]
        for (x0, y0), q, r in zip(corners, queries, results):
            assert "Fused device scan" in r.explain.text
            assert np.array_equal(r.ids, ds.query(q).ids)
            assert list(r.ids) == _reference("ships", x0, y0)
        st = b.stats()
        assert st["coalesced_queries"] == 4
        assert st["batches"] == 2  # sacrificial singleton + fused batch
        assert st["coalesce_ratio"] == pytest.approx(0.8)
        snap = reg.snapshot()
        assert snap["counters"]["batcher.coalesced"] == 4
        assert snap["gauges"]["batcher.queue_depth.ships"] == 0
        assert snap["timers"]["batcher.linger"]["count"] == 2

    def test_no_cross_schema_coalescing(self):
        ds = GatingStore()
        _fill(ds, "ships", seed=1)
        _fill(ds, "planes", seed=2)
        b = QueryBatcher(ds, max_batch=2, linger_us=1_000_000,
                         adaptive=False)
        ds.hold = threading.Event()
        warm = threading.Thread(target=b.query, args=(_gated("ships"),))
        warm.start()
        _wait(lambda: b._in_flight >= 1)
        out = {}
        threads = []
        # interleave the two schemas so a schema-oblivious queue would
        # fuse ships with planes
        for tag, q in (("s1", _bbox("ships", -60, -30)),
                       ("p1", _bbox("planes", -60, -30)),
                       ("s2", _bbox("ships", 40, 10)),
                       ("p2", _bbox("planes", 40, 10))):
            t = threading.Thread(
                target=lambda tag=tag, q=q: out.__setitem__(tag, b.query(q)))
            t.start()
            threads.append(t)
            if tag in ("s1", "p1"):
                tn = "ships" if tag[0] == "s" else "planes"
                _wait(_queued(b, tn, 1))
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        ds.hold.set()
        warm.join(timeout=10.0)
        assert sorted(map(tuple, ds.batched_calls)) == [
            ("planes", "planes"), ("ships", "ships")]
        for tag, tn, seed in (("s1", "ships", 1), ("p1", "planes", 2)):
            want = ds.query(_bbox(tn, -60, -30))
            assert np.array_equal(out[tag].ids, want.ids)
            assert list(out[tag].ids) == _reference(tn, -60, -30, seed)

    def test_linger_fires_under_low_concurrency(self):
        """Two concurrent queries, far below max_batch, still coalesce:
        with a dispatch in flight the leader waits out the linger window
        instead of launching a singleton scan."""
        ds = GatingStore()
        _fill(ds, "ships")
        linger_s = 0.12
        b = QueryBatcher(ds, max_batch=8, linger_us=linger_s * 1e6,
                         adaptive=False)
        ds.hold = threading.Event()
        warm = threading.Thread(target=b.query, args=(_gated("ships"),))
        warm.start()
        _wait(lambda: b._in_flight >= 1)
        t0 = time.monotonic()
        out = [None, None]
        threads = [
            threading.Thread(target=lambda k=k: out.__setitem__(
                k, b.query(_bbox("ships", -20 + 30 * k, -10))))
            for k in range(2)]
        threads[0].start()
        _wait(_queued(b, "ships", 1))
        threads[1].start()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        elapsed = time.monotonic() - t0
        ds.hold.set()
        warm.join(timeout=10.0)
        # one fused dispatch of both, and the leader really lingered
        assert ds.batched_calls == [["ships", "ships"]]
        assert elapsed >= linger_s * 0.8
        for k in range(2):
            want = ds.query(_bbox("ships", -20 + 30 * k, -10))
            assert np.array_equal(out[k].ids, want.ids)


class TestPlanCache:
    def test_counters_across_index_version_change(self):
        """Fused dispatches probe the plan shape-class table (type, index
        version, padded rows, padded batch) and feed the per-query cost
        EWMA of their (type, index version, padded rows); a new index
        version starts new classes, as in the JAX batcher."""
        ds = GatingStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=2, linger_us=1_000_000,
                         adaptive=False)
        _stage_coalesced(b, ds, [_bbox("ships", -60, -30),
                                 _bbox("ships", 20, 0)])
        assert list(b._cost_ewma) == [("ships", 2, 8192)]
        first = b._cost_ewma["ships", 2, 8192]
        assert first > 0
        # the same class again: folded into the same estimate
        _stage_coalesced(b, ds, [_bbox("ships", -100, 10),
                                 _bbox("ships", 60, -50)])
        assert list(b._cost_ewma) == [("ships", 2, 8192)]
        # another index version starts a new class
        ds.get_schema("ships").user_data["geomesa.index.version"] = "1"
        _stage_coalesced(b, ds, [_bbox("ships", -60, -30),
                                 _bbox("ships", 20, 0)])
        assert set(b._cost_ewma) == {("ships", 2, 8192), ("ships", 1, 8192)}
        assert b._last_shape["ships"] == ("ships", 1, 8192)
        st = b.stats()
        assert (st["batches"], st["coalesced_queries"]) == (6, 6)
        assert (st["plan_cache_hits"], st["plan_cache_misses"]) == (1, 2)


class TestLatencyCaps:
    def test_budget_shrinks_the_cap(self):
        b = QueryBatcher(GatingStore(), max_batch=32, latency_budget_ms=10,
                         registry=MetricsRegistry())
        assert b.effective_max_batch("ships") == 32   # no samples yet
        b.store.create_schema("ships", "dtg:Date,*geom:Point:srid=4326")
        shape = b._shape_key("ships", 8)
        b._observe_cost("ships", shape, 0.002)        # 2 ms per query
        assert b.effective_max_batch("ships") == 5
        b._observe_cost("ships", shape, 0.0001)       # EWMA: 1.62 ms
        assert b.effective_max_batch("ships") == 6
        b2 = QueryBatcher(b.store, max_batch=32)
        b2._observe_cost("ships", shape, 1.0)
        assert b2.effective_max_batch("ships") == 32  # no budget set


class TestErrorIsolation:
    def test_batch_failure_replays_per_caller(self):
        class FlakyStore(GatingStore):
            def query_batched(self, queries, *args, **kwargs):
                self.batched_calls.append([q.type_name for q in queries])
                raise RuntimeError("fused scan exploded")

        ds = FlakyStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=2, linger_us=1_000_000,
                         adaptive=False)
        queries = [_bbox("ships", -60, -30), _bbox("ships", 20, 0)]
        results = _stage_coalesced(b, ds, queries)
        assert len(ds.batched_calls) == 1
        for q, r in zip(queries, results):
            assert np.array_equal(r.ids, ds.query(q).ids)

    def test_replayed_errors_land_on_their_caller(self):
        class FlakyStore(GatingStore):
            def query_batched(self, queries, *args, **kwargs):
                raise RuntimeError("fused scan exploded")

        ds = FlakyStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=2, linger_us=1_000_000,
                         adaptive=False)
        # a hint the store does not know: raises
        bad = Query("ships", "BBOX(geom, 0, 0, 1, 1)",
                    hints={"NOT_A_HINT": 1000})
        ds.hold = threading.Event()
        warm = threading.Thread(target=b.query, args=(_gated("ships"),))
        warm.start()
        _wait(lambda: b._in_flight >= 1)
        out, errs = {}, {}

        def run(tag, q):
            try:
                out[tag] = b.query(q)
            except Exception as e:  # noqa: BLE001
                errs[tag] = e
        t1 = threading.Thread(target=run, args=("good", _bbox("ships", 0, 0)))
        t1.start()
        _wait(_queued(b, "ships", 1))
        t2 = threading.Thread(target=run, args=("bad", bad))
        t2.start()
        for t in (t1, t2):
            t.join(timeout=10.0)
        ds.hold.set()
        warm.join(timeout=10.0)
        assert set(out) == {"good"} and set(errs) == {"bad"}
        assert isinstance(errs["bad"], NotImplementedError)


class TestAdaptiveLinger:
    """The EWMA-derived linger budget: pure-function checks over
    synthetic queue states (no sleeping, no thread races)."""

    def _batcher(self, **kw):
        kw.setdefault("max_batch", 8)
        kw.setdefault("linger_us", 2000)
        kw.setdefault("adaptive", True)
        return QueryBatcher(GatingStore(), **kw)

    def test_cold_queue_uses_static_ceiling(self):
        b = self._batcher()
        assert b._effective_linger_s(_TypeQueue()) == pytest.approx(0.002)

    def test_idle_schema_pays_zero_linger(self):
        b = self._batcher()
        tq = _TypeQueue()
        tq.ewma_gap_s = 0.5
        assert b._effective_linger_s(tq) == 0.0

    def test_saturated_schema_scales_with_remaining_slots(self):
        b = self._batcher()
        tq = _TypeQueue()
        tq.ewma_gap_s = 1e-4
        tq.items = [object()]  # leader queued, 7 slots to fill
        assert b._effective_linger_s(tq) == pytest.approx(7e-4)

    def test_clamped_to_the_static_ceiling(self):
        b = self._batcher()
        tq = _TypeQueue()
        tq.ewma_gap_s = 0.0015  # under the window, but 7 slots * gap over
        tq.items = [object()]
        assert b._effective_linger_s(tq) == pytest.approx(0.002)

    def test_static_mode_ignores_the_estimate(self):
        b = self._batcher(adaptive=False)
        tq = _TypeQueue()
        tq.ewma_gap_s = 10.0
        assert b._effective_linger_s(tq) == pytest.approx(0.002)

    def test_ewma_folds_arrivals(self):
        tq = _TypeQueue()
        tq.observe_arrival(10.0)
        assert tq.ewma_gap_s is None  # one arrival = no gap yet
        tq.observe_arrival(10.1)
        assert tq.ewma_gap_s == pytest.approx(0.1)
        tq.observe_arrival(10.2)  # 0.2*0.1 + 0.8*0.1
        assert tq.ewma_gap_s == pytest.approx(0.1)
        tq.observe_arrival(10.9)  # 0.2*0.7 + 0.8*0.1
        assert tq.ewma_gap_s == pytest.approx(0.22)

    def test_adaptive_dispatch_still_exact(self):
        ds = GatingStore()
        _fill(ds, "ships")
        b = QueryBatcher(ds, max_batch=4, linger_us=2000, adaptive=True)
        for k in range(3):
            got = b.query(_bbox("ships", -60 + 40 * k, -30))
            want = ds.query(_bbox("ships", -60 + 40 * k, -30))
            assert np.array_equal(got.ids, want.ids)
        # fast sequential arrivals built an estimate for the schema
        assert b._queues["ships"].ewma_gap_s is not None

    def test_knobs_read_through_properties(self, monkeypatch):
        monkeypatch.setenv("GEOMESA_BATCH_MAX_SIZE", "12")
        monkeypatch.setenv("GEOMESA_BATCH_LINGER_ADAPTIVE", "false")
        monkeypatch.setenv("GEOMESA_BATCH_LINGER_MICROS", "500")
        monkeypatch.setenv("GEOMESA_BATCH_LATENCY_BUDGET_MS", "4")
        b = QueryBatcher(GatingStore())
        assert (b.max_batch, b.adaptive, b.linger_us) == (12, False, 500.0)
        assert b._latency_budget_s() == pytest.approx(0.004)


def test_threaded_callers_exact():
    """16 threads x 4 queries through the batcher, with a short switch
    interval: every result equals per-query query(), whatever
    coalesced, and no admission or count is lost."""
    ds = GatingStore()
    _fill(ds, "ships", n=8000)
    b = QueryBatcher(ds, max_batch=8, linger_us=20_000)
    rng = np.random.default_rng(3)
    corners = rng.uniform([-180, -90], [120, 50], (16, 4, 2))
    out = {}

    def caller(t):
        for k, (x0, y0) in enumerate(corners[t]):
            out[t, k] = b.query(_bbox("ships", x0, y0))
    threads = [threading.Thread(target=caller, args=(t,)) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(out) == 64
    for (t, k), r in out.items():
        x0, y0 = corners[t, k]
        assert np.array_equal(r.ids, ds.query(_bbox("ships", x0, y0)).ids)
    st = b.stats()
    assert st["total_queries"] == 64
    singles = st["batches"] - sum(len(c) > 0 for c in ds.batched_calls)
    assert st["coalesced_queries"] + singles == 64
    assert b.queue_depths() == {}
