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
name, so queries never coalesce across schemas. The drain is one global
FIFO per schema (the port has no tenants).

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
  dispatches (per type and index version) so one fused batch costs at
  most this budget, with the static
  ``geomesa.batch.max.size`` as the ceiling. Unset (default) keeps the
  static cap.

Metrics (module-level registry): ``batcher.queries``,
``batcher.batches``, ``batcher.coalesced``, ``batcher.occupancy``,
``batcher.coalesce_ratio``, ``batcher.linger`` (timer),
``batcher.linger_effective_us.<type>``,
``batcher.max_batch_effective.<type>``, ``batcher.queue_depth.<type>``
(type-keyed gauges sanitize the type name).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..index.api import Query
from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

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
    __slots__ = ("q", "ev", "result", "error")

    def __init__(self, q):
        self.q = q
        self.ev = threading.Event()
        self.result = None
        self.error = None

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
        # latency-derived batch caps: per (type, index version) EWMA of
        # the per-query cost of one fused dispatch (elapsed / occupancy)
        # and the last observed class per type, so the effective cap can
        # be read without touching the store
        self._cost_ewma: dict[tuple, float] = {}
        self._last_class: dict[str, tuple] = {}
        self._in_flight = 0
        self.total_queries = 0
        self.coalesced_queries = 0
        self.batches = 0

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
        if self.max_batch <= 1:
            self._note(1)
            return self.store.query(q)
        p = _Pending(q)
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
        p = _Pending((float(qx), float(qy)))
        key = f"{type_name}\x00knn\x00{int(k)}"
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
        self.registry.gauge(f"batcher.queue_depth.{sanitize_key(key)}", depth)
        if leader:
            self._lead(key, tq, dispatch=lambda _key, chunk:
                       self._dispatch_knn(type_name, int(k), chunk))
        return p.get()

    def stats(self) -> dict:
        """Batching counters (also mirrored into the metrics registry)."""
        total = self.total_queries
        return {
            "total_queries": total,
            "batches": self.batches,
            "coalesced_queries": self.coalesced_queries,
            "coalesce_ratio": (self.coalesced_queries / total
                               if total else 0.0),
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
            chunks = [tq.items[i:i + cap] for i in range(0, len(tq.items),
                                                         cap)]
            tq.items = []
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
        occupancy = len(chunk)
        self._note(occupancy)
        try:
            if occupancy == 1:
                results = [self.store.query(chunk[0].q)]
            else:
                t0 = time.perf_counter()
                results = self.store.query_batched([p.q for p in chunk])
                # only fused dispatches feed the cost EWMA: the cap is
                # about how many queries one fused scan carries inside
                # the budget
                self._observe_cost(type_name,
                                   (time.perf_counter() - t0) / occupancy)
        except Exception:  # noqa: BLE001
            # a batch-level failure must not take down every caller:
            # replay each query alone so errors land on exactly the
            # caller that owns them
            for p in chunk:
                try:
                    p.resolve(result=self.store.query(p.q))
                except Exception as e:  # noqa: BLE001
                    p.resolve(error=e)
            return
        for p, r in zip(chunk, results):
            p.resolve(result=r)

    def _dispatch_knn(self, type_name: str, k: int, chunk: list[_Pending]):
        """One batched top-k for a drained KNN chunk: the chunk's query
        points go to the batched process in one call; (ids, distances)
        go back per caller. A failure replays each caller alone through
        the batched call, as ``_dispatch`` does, so errors land on the
        caller that owns them and no caller gives way to the host
        z-ring."""
        from ..analytics.processes import knn_batch_process, knn_process
        occupancy = len(chunk)
        self._note(occupancy)
        try:
            if occupancy == 1:
                qx, qy = chunk[0].q
                results = [knn_process(self.store, type_name, qx, qy, k)]
            else:
                results = knn_batch_process(
                    self.store, type_name, np.array([p.q[0] for p in chunk]),
                    np.array([p.q[1] for p in chunk]), k)
        except Exception:  # noqa: BLE001
            for p in chunk:
                try:
                    p.resolve(result=knn_batch_process(
                        self.store, type_name, [p.q[0]], [p.q[1]], k)[0])
                except Exception as e:  # noqa: BLE001
                    p.resolve(error=e)
            return
        for p, r in zip(chunk, results):
            p.resolve(result=r)

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

    # -- latency-derived batch caps ----------------------------------------

    def _latency_budget_s(self) -> float | None:
        """Per-dispatch wall budget driving the effective batch cap;
        None (the default) disables the derivation."""
        if self._latency_budget_override is not None:
            return float(self._latency_budget_override) / 1e3
        ms = BATCH_LATENCY_BUDGET_MS.as_float()
        return None if ms is None else ms / 1e3

    def _observe_cost(self, type_name: str, per_query_s: float):
        """Fold one fused dispatch's per-query cost into the EWMA of its
        (type, index version): a reindex starts a new estimate, and the
        EWMA follows the type's growth within one."""
        cls = (type_name, self.store.get_schema(type_name).index_version)
        with self._lock:
            prev = self._cost_ewma.get(cls)
            self._cost_ewma[cls] = (
                per_query_s if prev is None
                else _EWMA_ALPHA * per_query_s + (1.0 - _EWMA_ALPHA) * prev)
            self._last_class[type_name] = cls

    def effective_max_batch(self, type_name: str) -> int:
        """The batch cap in force for ``type_name``: the static knob,
        shrunk so one fused dispatch fits the latency budget given the
        type's observed per-query cost. Pure dict reads (never
        touches the store), so it is safe under the admission lock; no
        budget or no cost samples yet -> the static ceiling."""
        budget_s = self._latency_budget_s()
        if budget_s is None or budget_s <= 0:
            return self.max_batch
        cls = self._last_class.get(type_name)
        cost = self._cost_ewma.get(cls) if cls is not None else None
        if not cost or cost <= 0:
            return self.max_batch
        eff = min(self.max_batch, max(1, int(budget_s / cost)))
        self.registry.gauge(
            f"batcher.max_batch_effective.{sanitize_key(type_name)}", eff)
        return eff
