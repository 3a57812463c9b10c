"""Query micro-batching: coalesce concurrent ``query()`` calls into one
pass of the batched scan kernels.

The reference amortizes per-request overhead by running filters inside
the scan machinery itself (Accumulo iterators / HBase coprocessors
serving many concurrent scans per tablet server). Here the cost to
amortize is the store's per-query work: one fused scan of every row
answers a whole batch (scan/zscan.py ``stack_queries`` +
``batch_hit_rows``), and this module turns N in-flight queries into one
``store.query_batched`` call and demultiplexes per-caller results.

Admission control is leader/follower with per-schema queues: the first
caller for a schema becomes the leader, lingers up to ``linger_us``
microseconds (or until ``max_batch`` callers are queued), then drains
the queue and dispatches ``store.query_batched``. Followers block until
the leader hands them their ``QueryResult``. Queues are keyed by type
name, so queries never coalesce across schemas. With QoS off
(``geomesa.qos.enabled``, the default) the drain is one global FIFO per
schema; with tenants bound, per-tenant FIFO queues fill each dispatch by
deficit-weighted round-robin (``tenants.weighted_drain``).

Every admission opens a root ``batcher-wait`` span (obs/trace.py); the
leader's ``dispatch`` span links to each waiter, and its subtree is
grafted into every follower's trace before the follower is resolved.
A fused dispatch probes the plan shape-class table (type, index
version, padded row count, padded batch size), runs under the stall
watchdog (``dispatch.<type>``) and reports to ``obs.runtime``.

Lingering is load-gated: an idle singleton dispatches immediately (a
lone query must not pay the linger window as latency), and the wait
only applies when another dispatch is already in flight or followers
are already queued: exactly the situations where arrivals inside the
window can coalesce.

Knobs (system properties / environment):

- ``geomesa.batch.max.size``  (``GEOMESA_BATCH_MAX_SIZE``): max queries
  per fused dispatch, default 32; <= 1 disables batching.
- ``geomesa.batch.linger.micros`` (``GEOMESA_BATCH_LINGER_MICROS``):
  how long a leader waits for followers, default 2000 us.
- ``geomesa.batch.linger.adaptive`` (``GEOMESA_BATCH_LINGER_ADAPTIVE``):
  derive the wait from an EWMA of per-schema inter-arrival time,
  clamped to ``[0, linger_us]`` (the static knob stays the ceiling);
  default true.
- ``geomesa.knn.batch`` (``GEOMESA_KNN_BATCH``): coalesce concurrent
  ``knn()`` calls of one (type, k) into one batched KNN call, default
  true; false sends each through ``knn_process`` alone.
- ``geomesa.batch.latency.budget.ms``
  (``GEOMESA_BATCH_LATENCY_BUDGET_MS``): derive the effective
  ``max_batch`` from the observed per-query cost EWMA of fused
  dispatches (per type, index version and padded row count) so one
  fused batch costs at most this budget, with the static
  ``geomesa.batch.max.size`` as the ceiling. Unset (default) keeps the
  static cap.

Metrics (module-level registry): ``batcher.queries``,
``batcher.batches``, ``batcher.coalesced``, ``batcher.occupancy``,
``batcher.coalesce_ratio``, ``batcher.linger`` (timer),
``batcher.linger_effective_us.<type>``,
``batcher.max_batch_effective.<type>``, ``batcher.queue_depth.<type>``,
``batcher.plan_cache.hit`` / ``.miss``, ``batcher.plan_cache.hit_rate``,
``qos.admission.dispatched{tenant}`` (type-keyed gauges sanitize the
type name).
"""

from __future__ import annotations

import contextvars
import threading
import time

import numpy as np

from ..index.api import Query
from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty
from .zscan import next_pow2

__all__ = ["QueryBatcher", "BATCH_MAX_SIZE", "BATCH_LINGER_MICROS",
           "BATCH_LINGER_ADAPTIVE", "KNN_BATCH", "BATCH_LATENCY_BUDGET_MS"]

BATCH_MAX_SIZE = SystemProperty("geomesa.batch.max.size", "32")
BATCH_LINGER_MICROS = SystemProperty("geomesa.batch.linger.micros", "2000")
BATCH_LINGER_ADAPTIVE = SystemProperty("geomesa.batch.linger.adaptive",
                                       "true")
KNN_BATCH = SystemProperty("geomesa.knn.batch", "true")
BATCH_LATENCY_BUDGET_MS = SystemProperty("geomesa.batch.latency.budget.ms",
                                         None)

# EWMA smoothing for the per-schema inter-arrival estimate: the most
# recent ~5 arrivals dominate, so the estimate tracks load shifts
# quickly without whiplashing on one outlier gap
_EWMA_ALPHA = 0.2


class _Pending:
    __slots__ = ("q", "ev", "result", "error", "span_ctx", "tenant", "ctx")

    def __init__(self, q):
        self.q = q
        self.ev = threading.Event()
        self.result = None
        self.error = None
        # caller's (trace state, span): the leader links its fused
        # dispatch span to every waiter and grafts the dispatch subtree
        # back into their traces (obs/trace.py)
        self.span_ctx = None
        # tenant identity captured at admission (None with QoS off): the
        # leader drains per-tenant FIFO queues by deficit-weighted
        # round-robin instead of one global FIFO (tenants/__init__.py)
        from ..tenants import active_tenant
        self.tenant = active_tenant()
        # the caller's context: the store writes this query's audit
        # record in it (its trace, principal and tenant), not in the
        # leader's that runs the dispatch (audit/hook.py)
        self.ctx = contextvars.copy_context()

    def resolve(self, result=None, error=None):
        self.result, self.error = result, error
        self.ev.set()

    def get(self):
        self.ev.wait()
        if self.error is not None:
            raise self.error
        return self.result


class _TypeQueue:
    __slots__ = ("items", "has_leader", "last_arrival", "ewma_gap_s")

    def __init__(self):
        self.items: list[_Pending] = []
        self.has_leader = False
        self.last_arrival: float | None = None  # monotonic, admission
        self.ewma_gap_s: float | None = None    # None until 2 arrivals

    def observe_arrival(self, now: float):
        """Fold one admission into the inter-arrival EWMA."""
        if self.last_arrival is not None:
            gap = now - self.last_arrival
            self.ewma_gap_s = (gap if self.ewma_gap_s is None
                               else _EWMA_ALPHA * gap
                               + (1.0 - _EWMA_ALPHA) * self.ewma_gap_s)
        self.last_arrival = now


class QueryBatcher:
    """Admission-queue executor over a DataStore's ``query_batched``.

    Thread-safe; one instance fronts one store. Callers on the same
    schema arriving within a linger window share a single fused scan;
    results are exactly what per-query ``store.query()`` would return
    (the store runs non-fusible plans per query).
    """

    def __init__(self, store, max_batch: int | None = None,
                 linger_us: float | None = None, adaptive: bool | None = None,
                 latency_budget_ms: float | None = None,
                 registry=metrics):
        self.store = store
        self.max_batch = int(max_batch if max_batch is not None
                             else BATCH_MAX_SIZE.as_int())
        self._linger_override = (None if linger_us is None
                                 else float(linger_us))
        self.adaptive = (adaptive if adaptive is not None
                         else bool(BATCH_LINGER_ADAPTIVE.as_bool()))
        self._latency_budget_override = latency_budget_ms
        self.registry = registry
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict[str, _TypeQueue] = {}
        # plan shape-class table: keyed (type_name, index_version,
        # padded row count, padded batch size). A miss marks the first
        # fused dispatch of that shape; obs.runtime counts both
        self._plan_keys: set[tuple] = set()
        # latency-derived batch caps: per shape-class EWMA of the
        # per-query cost of one fused dispatch (elapsed / occupancy) and
        # the last observed class per type, so the effective cap can be
        # read without touching the store
        self._cost_ewma: dict[tuple, float] = {}
        self._last_shape: dict[str, tuple] = {}
        # per-(queue key, tenant) DWRR deficit counters: unspent
        # fair-share credit carries across dispatches (tenants plane)
        self._deficits: dict[str, dict[str, float]] = {}
        self._in_flight = 0
        self.total_queries = 0
        self.coalesced_queries = 0
        self.batches = 0
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def linger_us(self) -> float:
        """The linger ceiling in force: an explicit constructor value
        wins; otherwise the knob is re-read live per dispatch."""
        if self._linger_override is not None:
            return self._linger_override
        try:
            return float(BATCH_LINGER_MICROS.get())
        except (TypeError, ValueError):
            return 2000.0

    # -- public surface ----------------------------------------------------

    def query(self, q, type_name: str | None = None):
        """Submit one query; blocks until its result is ready. Mirrors
        ``store.query(q, type_name)`` (ECQL string + type name, or a
        Query object)."""
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        from ..obs import tracer
        if self.max_batch <= 1:
            self._note(1)
            with tracer.span("batcher-wait", q.type_name, root=True):
                return self.store.query(q)
        p = _Pending(q)
        with tracer.span("batcher-wait", q.type_name, root=True) as wsp:
            p.span_ctx = tracer.current()
            with self._cond:
                tq = self._queues.setdefault(q.type_name, _TypeQueue())
                tq.observe_arrival(time.monotonic())
                tq.items.append(p)
                depth = len(tq.items)
                leader = not tq.has_leader
                if leader:
                    tq.has_leader = True
                elif depth >= self.effective_max_batch(q.type_name):
                    self._cond.notify_all()
            self.registry.gauge(
                f"batcher.queue_depth.{sanitize_key(q.type_name)}", depth)
            wsp.set_attr(leader=leader, depth=depth)
            if leader:
                self._lead(q.type_name, tq)
            return p.get()

    def knn(self, type_name: str, qx: float, qy: float, k: int):
        """Submit one KNN query; blocks until (ids, distances) is ready.
        Concurrent callers on the same (type, k) coalesce into ONE
        batched top-k call: the KNN analog of ``query()``'s admission
        queue (``geomesa.knn.batch``)."""
        from ..analytics.processes import knn_process
        enabled = str(KNN_BATCH.get()).lower() in ("true", "1", "yes")
        if not enabled or self.max_batch <= 1:
            self._note(1)
            return knn_process(self.store, type_name, float(qx), float(qy),
                               k)
        from ..obs import tracer
        p = _Pending((float(qx), float(qy)))
        key = f"{type_name}\x00knn\x00{int(k)}"
        with tracer.span("batcher-wait", f"knn:{type_name}", root=True):
            p.span_ctx = tracer.current()
            with self._cond:
                tq = self._queues.setdefault(key, _TypeQueue())
                tq.observe_arrival(time.monotonic())
                tq.items.append(p)
                depth = len(tq.items)
                leader = not tq.has_leader
                if leader:
                    tq.has_leader = True
                elif depth >= self.max_batch:
                    self._cond.notify_all()
            self.registry.gauge(f"batcher.queue_depth.{sanitize_key(key)}",
                                depth)
            if leader:
                self._lead(key, tq, dispatch=lambda _key, chunk:
                           self._dispatch_knn(type_name, int(k), chunk))
            return p.get()

    def stats(self) -> dict:
        """Batching counters (also mirrored into the metrics registry)."""
        total = self.total_queries
        probes = self.cache_hits + self.cache_misses
        return {
            "total_queries": total,
            "batches": self.batches,
            "coalesced_queries": self.coalesced_queries,
            "coalesce_ratio": (self.coalesced_queries / total
                               if total else 0.0),
            "plan_cache_hits": self.cache_hits,
            "plan_cache_misses": self.cache_misses,
            "plan_cache_hit_rate": (self.cache_hits / probes
                                    if probes else 0.0),
        }

    def queue_depths(self) -> dict[str, int]:
        """Per-type pending-queue depth snapshot."""
        with self._lock:
            return {k: len(tq.items) for k, tq in self._queues.items()
                    if tq.items}

    # -- leader path -------------------------------------------------------

    def _lead(self, type_name: str, tq: _TypeQueue, dispatch=None):
        """Linger for followers (only under load), then drain the queue
        in max_batch chunks and dispatch each as one fused scan.
        ``dispatch`` overrides the query dispatcher (the KNN path shares
        the admission and linger machinery)."""
        t0 = time.perf_counter()
        with self._cond:
            # linger pays only when arrivals inside the window can
            # actually coalesce: another dispatch in flight, or
            # followers already queued behind this leader. An idle
            # singleton dispatches immediately.
            cap = self.effective_max_batch(type_name)
            linger_s = self._effective_linger_s(tq)
            self.registry.gauge(
                f"batcher.linger_effective_us.{sanitize_key(type_name)}",
                linger_s * 1e6)
            if linger_s > 0 and (self._in_flight > 0 or len(tq.items) > 1):
                deadline = time.monotonic() + linger_s
                while len(tq.items) < cap:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            chunks = self._drain_chunks(type_name, tq, cap)
            tq.has_leader = False
            self._in_flight += 1
        self.registry.gauge(
            f"batcher.queue_depth.{sanitize_key(type_name)}", 0)
        self.registry.observe("batcher.linger", time.perf_counter() - t0)
        dispatch = dispatch or self._dispatch
        try:
            for chunk in chunks:
                dispatch(type_name, chunk)
        finally:
            with self._cond:
                self._in_flight -= 1

    def _drain_chunks(self, key: str, tq: _TypeQueue,
                      cap: int) -> list[list[_Pending]]:
        """Drain the admission queue into cap-sized dispatch chunks.

        With QoS off every pending item carries ``tenant=None`` and the
        drain is the global FIFO, bit-identically. With tenant
        identities present, items regroup into per-tenant FIFO queues
        filled by deficit-weighted round-robin (``weighted_drain``), so
        coalescing still fuses but a flooding tenant cannot occupy every
        batch slot. Called under ``self._cond``."""
        chunks: list[list[_Pending]] = []
        if not tq.items:
            return chunks
        if {p.tenant for p in tq.items} == {None}:
            while tq.items:
                chunks.append(tq.items[:cap])
                del tq.items[:cap]
            return chunks
        from ..tenants import (DEFAULT_TENANT, tenant_label,
                               tenant_registry, weighted_drain)
        groups: dict[str, list[_Pending]] = {}
        for p in tq.items:
            groups.setdefault(p.tenant or DEFAULT_TENANT, []).append(p)
        tq.items.clear()
        deficits = self._deficits.setdefault(key, {})
        weight_of = lambda t: tenant_registry.policy(t).weight  # noqa: E731
        while any(groups.values()):
            chunk = weighted_drain(groups, deficits, cap, weight_of)
            if not chunk:
                break
            for t in {p.tenant or DEFAULT_TENANT for p in chunk}:
                self.registry.counter(
                    "qos.admission.dispatched",
                    sum(1 for p in chunk
                        if (p.tenant or DEFAULT_TENANT) == t),
                    labels={"tenant": tenant_label(t)})
            chunks.append(chunk)
        return chunks

    def _effective_linger_s(self, tq: _TypeQueue) -> float:
        """The leader's wait budget for this dispatch, in seconds.

        Static mode (``adaptive=False``) always returns the ceiling.
        Adaptive mode sizes the wait from the schema's inter-arrival
        EWMA: no samples yet -> the ceiling; arrivals slower than the
        ceiling -> 0 (no follower can land inside the window);
        otherwise enough gaps to fill the remaining batch slots, clamped
        to the ceiling."""
        ceiling = self.linger_us / 1e6
        if not self.adaptive or ceiling <= 0:
            return max(ceiling, 0.0)
        gap = tq.ewma_gap_s
        if gap is None:
            return ceiling
        if gap >= ceiling:
            return 0.0
        remaining_slots = max(self.max_batch - len(tq.items), 0)
        return min(ceiling, gap * remaining_slots)

    def _dispatch(self, type_name: str, chunk: list[_Pending]):
        from ..audit import caller_contexts
        with caller_contexts([(p.q, p.ctx) for p in chunk]):
            self._dispatch_chunk(type_name, chunk)

    def _dispatch_chunk(self, type_name: str, chunk: list[_Pending]):
        from ..obs import tracer
        occupancy = len(chunk)
        self._note(occupancy)
        dsp = self._open_dispatch_span(tracer, type_name, chunk)
        err = None
        results: list = []
        with dsp:
            dsp.set_attr(occupancy=occupancy)
            try:
                if occupancy == 1:
                    results = [self.store.query(chunk[0].q)]
                else:
                    from ..obs.prof import watchdog
                    from ..obs.runtime import runtime
                    shape = self._shape_key(type_name, occupancy)
                    self._probe_plan_cache(shape)
                    t0 = time.perf_counter()
                    with watchdog.watch(
                            f"dispatch.{sanitize_key(type_name)}",
                            span=dsp):
                        results = self.store.query_batched(
                            [p.q for p in chunk])
                    dt = time.perf_counter() - t0
                    # only fused dispatches feed the cost EWMA: the cap
                    # is about how many queries one fused scan carries
                    # inside the budget
                    self._observe_cost(type_name, shape, dt / occupancy)
                    runtime.note_dispatch("batcher", shape, dt)
            except Exception as e:  # noqa: BLE001
                dsp.annotate("dispatch.failed", error=str(e))
                err = e
        # graft BEFORE resolving: the dispatch subtree lands in every
        # follower's trace while their roots are still open
        tracer.graft(dsp, [p.span_ctx for p in chunk])
        if err is None:
            for p, r in zip(chunk, results):
                p.resolve(result=r)
            return
        # a batch-level failure must not take down every caller: replay
        # each query alone so errors land on exactly the caller that
        # owns them
        for p in chunk:
            try:
                p.resolve(result=self.store.query(p.q))
            except Exception as e:  # noqa: BLE001
                p.resolve(error=e)

    @staticmethod
    def _open_dispatch_span(tracer, name: str, chunk: list[_Pending]):
        """A fused dispatch serves N waiting callers: the span links to
        each waiter and each waiter's span links back, so the N-queries
        -> 1-dispatch fan-in is navigable from both ends."""
        dsp = tracer.span("dispatch", name)
        if dsp.span_id is not None:
            for p in chunk:
                if p.span_ctx:
                    state, wsp = p.span_ctx
                    dsp.link(state.trace_id, wsp.span_id)
                    wsp.link(dsp.trace_id, dsp.span_id)
        return dsp

    def _dispatch_knn(self, type_name: str, k: int, chunk: list[_Pending]):
        """One batched top-k for a drained KNN chunk: the chunk's query
        points go to the batched process in one call; (ids, distances)
        go back per caller. A failure replays each caller alone through
        the batched call, as ``_dispatch`` does, so errors land on the
        caller that owns them and no caller gives way to the host
        z-ring."""
        from ..analytics.processes import knn_batch_process, knn_process
        from ..obs import tracer
        occupancy = len(chunk)
        self._note(occupancy)
        dsp = self._open_dispatch_span(tracer, f"knn:{type_name}", chunk)
        err = None
        results: list = []
        with dsp:
            dsp.set_attr(occupancy=occupancy, k=int(k))
            try:
                if occupancy == 1:
                    qx, qy = chunk[0].q
                    results = [knn_process(self.store, type_name, qx, qy,
                                           k)]
                else:
                    from ..obs.prof import watchdog
                    from ..obs.runtime import runtime
                    qx = np.array([p.q[0] for p in chunk])
                    qy = np.array([p.q[1] for p in chunk])
                    t0 = time.perf_counter()
                    with watchdog.watch(
                            f"dispatch.knn.{sanitize_key(type_name)}",
                            span=dsp):
                        results = knn_batch_process(self.store, type_name,
                                                    qx, qy, k)
                    runtime.note_dispatch(
                        "knn", (type_name, int(k), next_pow2(occupancy)),
                        time.perf_counter() - t0,
                        h2d_bytes=int(qx.nbytes + qy.nbytes))
            except Exception as e:  # noqa: BLE001
                dsp.annotate("dispatch.failed", error=str(e))
                err = e
        tracer.graft(dsp, [p.span_ctx for p in chunk])
        if err is None:
            for p, r in zip(chunk, results):
                p.resolve(result=r)
            return
        for p in chunk:
            try:
                p.resolve(result=knn_batch_process(
                    self.store, type_name, [p.q[0]], [p.q[1]], k)[0])
            except Exception as e:  # noqa: BLE001
                p.resolve(error=e)

    # -- accounting --------------------------------------------------------

    def _note(self, occupancy: int):
        with self._lock:
            self.total_queries += occupancy
            self.batches += 1
            if occupancy > 1:
                self.coalesced_queries += occupancy
            total, co = self.total_queries, self.coalesced_queries
        reg = self.registry
        reg.counter("batcher.queries", occupancy)
        reg.counter("batcher.batches")
        if occupancy > 1:
            reg.counter("batcher.coalesced", occupancy)
        reg.gauge("batcher.occupancy", occupancy)
        reg.gauge("batcher.coalesce_ratio", co / total if total else 0.0)

    def _probe_plan_cache(self, key: tuple):
        with self._lock:
            hit = key in self._plan_keys
            if hit:
                self.cache_hits += 1
            else:
                self._plan_keys.add(key)
                self.cache_misses += 1
            hits, misses = self.cache_hits, self.cache_misses
        reg = self.registry
        reg.counter("batcher.plan_cache.hit" if hit
                    else "batcher.plan_cache.miss")
        reg.gauge("batcher.plan_cache.hit_rate", hits / (hits + misses))
        from ..obs.runtime import runtime
        runtime.note_plan_probe("batcher", key, hit)

    def _shape_key(self, type_name: str, occupancy: int) -> tuple:
        """(type_name, index_version, padded row count, padded batch
        size): the shape class of a fused dispatch. An index version
        bump or a capacity-class change starts new classes for the
        type."""
        version = self.store.get_schema(type_name).index_version
        cap = next_pow2(max(int(self.store.count(type_name)), 1))
        return (type_name, version, cap, next_pow2(occupancy))

    # -- latency-derived batch caps ----------------------------------------

    def _latency_budget_s(self) -> float | None:
        """Per-dispatch wall budget driving the effective batch cap;
        None (the default) disables the derivation."""
        if self._latency_budget_override is not None:
            return float(self._latency_budget_override) / 1e3
        ms = BATCH_LATENCY_BUDGET_MS.as_float()
        return None if ms is None else ms / 1e3

    def _observe_cost(self, type_name: str, shape: tuple,
                      per_query_s: float):
        """Fold one dispatch's per-query cost into the shape-class EWMA,
        keyed by (type, index version, padded row count): the part of
        the shape class that predicts the scan's cost independent of how
        many queries happened to coalesce this time."""
        cls = shape[:3]
        with self._lock:
            prev = self._cost_ewma.get(cls)
            self._cost_ewma[cls] = (
                per_query_s if prev is None
                else _EWMA_ALPHA * per_query_s + (1.0 - _EWMA_ALPHA) * prev)
            self._last_shape[type_name] = cls

    def effective_max_batch(self, type_name: str) -> int:
        """The batch cap in force for ``type_name``: the static knob,
        shrunk so one fused dispatch fits the latency budget given the
        shape class's observed per-query cost. Pure dict reads (never
        touches the store), so it is safe under the admission lock; no
        budget or no cost samples yet -> the static ceiling."""
        budget_s = self._latency_budget_s()
        if budget_s is None or budget_s <= 0:
            return self.max_batch
        cls = self._last_shape.get(type_name)
        cost = self._cost_ewma.get(cls) if cls is not None else None
        if not cost or cost <= 0:
            return self.max_batch
        eff = min(self.max_batch, max(1, int(budget_s / cost)))
        self.registry.gauge(
            f"batcher.max_batch_effective.{sanitize_key(type_name)}", eff)
        return eff
