"""The group-commit write plane.

Write amplification of per-caller writes: every ``store.write`` pays
its own journal append (a WAL frame + an fsync decision) and its own
``_TypeState.append`` (plan-cache clear, lazy-result detach, the
in-place copy into the device columns). The pipeline inverts that:
callers stage batches into a bounded queue and a single writer thread
drains it in fused groups, so N staged batches cost ⌈N·rows/group⌉
store writes instead of N.

Group sizing reuses the latency-derived cap of ``scan/batcher.py``: an
EWMA of observed per-row write cost turns
``geomesa.ingest.latency.budget.ms`` into a row cap, so groups grow on
fast stores and shrink under slow fsyncs to keep commit latency
bounded.

Admission control is row-denominated: ``geomesa.ingest.max.inflight.
rows`` tokens cover everything staged but not yet committed. Embedded
callers block (backpressure); a serving front end asks non-blocking and
maps refusal to 429 + Retry-After. Independently, the writer pauses
briefly while the read batchers' queues are deep
(``geomesa.ingest.shed.queue.depth``, which lives in
``utils/properties.py`` beside the SLO loop that lowers it): sustained
ingest yields to query dispatches instead of starving them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from ..features.batch import FeatureBatch
from ..metrics import metrics
from ..utils.properties import INGEST_SHED_QUEUE_DEPTH, SystemProperty

__all__ = ["IngestPipeline", "IngestGovernor", "IngestAck",
           "INGEST_MAX_INFLIGHT_ROWS", "INGEST_GROUP_ROWS",
           "INGEST_LATENCY_BUDGET_MS", "INGEST_SHED_QUEUE_DEPTH"]

INGEST_MAX_INFLIGHT_ROWS = SystemProperty(
    "geomesa.ingest.max.inflight.rows", "262144")
INGEST_GROUP_ROWS = SystemProperty("geomesa.ingest.group.rows", "131072")
INGEST_LATENCY_BUDGET_MS = SystemProperty(
    "geomesa.ingest.latency.budget.ms", "500")
INGEST_SHED_PAUSE_MS = SystemProperty("geomesa.ingest.shed.pause.ms", "5")

_EWMA_ALPHA = 0.2  # matches scan/batcher.py cost smoothing
_MIN_GROUP_ROWS = 1024  # latency cap floor: groups never degenerate to 1


class IngestAck:
    """Per-staged-batch commit handle: set once its fused group's store
    write returns (or fails). An acked batch has been journaled: the
    zero-loss recovery contract covers exactly the acked rows."""

    __slots__ = ("_event", "result", "error")

    def __init__(self):
        self._event = threading.Event()
        self.result = None
        self.error: BaseException | None = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("ingest ack timeout")
        if self.error is not None:
            raise self.error
        return self.result

    def _complete(self, result=None, error: BaseException | None = None):
        self.result = result
        self.error = error
        self._event.set()


class IngestGovernor:
    """Token bucket over in-flight (staged, uncommitted) rows plus the
    read-starvation shed signal."""

    def __init__(self, max_inflight_rows: int | None = None):
        self.max_inflight_rows = int(
            max_inflight_rows
            if max_inflight_rows is not None
            else INGEST_MAX_INFLIGHT_ROWS.as_int())
        self._cv = threading.Condition()
        self._inflight = 0

    @property
    def inflight_rows(self) -> int:
        return self._inflight

    def acquire(self, rows: int, block: bool = True,
                timeout: float | None = None) -> bool:
        """Admit ``rows``; blocks while the bucket is full. An oversize
        batch (> the whole bucket) is admitted alone once the bucket
        drains: refusing it forever would deadlock callers."""
        waited = False
        with self._cv:
            while (self._inflight > 0
                   and self._inflight + rows > self.max_inflight_rows):
                if not block:
                    metrics.counter("ingest.backpressure.refused")
                    return False
                if not waited:
                    waited = True
                    metrics.counter("ingest.backpressure.waits")
                if not self._cv.wait(timeout=timeout):
                    metrics.counter("ingest.backpressure.refused")
                    return False
            self._inflight += rows
            metrics.gauge("ingest.queue.rows", self._inflight)
        return True

    def release(self, rows: int):
        with self._cv:
            self._inflight = max(0, self._inflight - rows)
            metrics.gauge("ingest.queue.rows", self._inflight)
            self._cv.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                if not self._cv.wait(timeout=left):
                    return False
        return True

    # -- read-starvation shed signal --------------------------------------

    @staticmethod
    def read_queue_depth() -> int:
        from ..scan.registry import batcher_registry
        return sum(batcher_registry.queue_depths().values())

    def should_shed(self) -> bool:
        """True while admitting more ingest would starve readers: the
        process-wide read batchers have a deep backlog."""
        threshold = INGEST_SHED_QUEUE_DEPTH.as_int()
        if threshold is None or threshold <= 0:
            return False
        return self.read_queue_depth() > threshold


class IngestPipeline:
    """Bounded-queue group-commit writer over any ``DataStore``.

    Callers ``write()`` staged batches and get an ``IngestAck``; one
    writer thread coalesces same-type runs up to the effective group
    cap and commits them with a single ``store.write_many``: one
    journal append + one state append per group on durable stores.
    """

    def __init__(self, store, group_rows: int | None = None,
                 governor: IngestGovernor | None = None,
                 max_inflight_rows: int | None = None):
        self.store = store
        self.governor = governor or IngestGovernor(max_inflight_rows)
        self._group_rows = int(group_rows if group_rows is not None
                               else INGEST_GROUP_ROWS.as_int())
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._cost_ewma: float | None = None  # seconds per row
        self._rate_ewma: float | None = None  # rows per second
        self._writer = threading.Thread(target=self._run, daemon=True,
                                        name="ingest-pipeline")
        self._writer.start()

    # -- staging -----------------------------------------------------------

    def write(self, type_name: str, batch: FeatureBatch,
              visibilities=None, block: bool = True,
              timeout: float | None = None) -> IngestAck | None:
        """Stage a batch. Blocks on the governor while the in-flight
        bucket is full; with ``block=False`` returns None instead (a
        front end's 429 path). Empty batches ack immediately."""
        if self._closed:
            raise RuntimeError("ingest pipeline is closed")
        ack = IngestAck()
        if batch.n == 0:
            ack._complete()
            return ack
        if not self.governor.acquire(batch.n, block=block, timeout=timeout):
            return None
        # per-tenant row bucket (tenants plane): the staging caller's
        # tenant is charged here and credited by the writer thread when
        # the group commits; the writer has no caller context, so the
        # identity rides the queue entry. QoS off -> tenant is None and
        # the global governor is the only gate, as before.
        from ..tenants import active_tenant, tenant_registry
        tenant = active_tenant()
        if tenant is not None and not tenant_registry.acquire_rows(
                tenant, batch.n, block=block, timeout=timeout):
            self.governor.release(batch.n)
            return None
        with self._cv:
            if self._closed:
                self.governor.release(batch.n)
                if tenant is not None:
                    tenant_registry.release_rows(tenant, batch.n)
                raise RuntimeError("ingest pipeline is closed")
            from ..obs import tracer
            self._q.append((type_name, batch, visibilities, ack,
                            tracer.current(), tenant))
            self._cv.notify()
        return ack

    def flush(self, timeout: float | None = None) -> bool:
        """Block until everything staged so far has committed."""
        return self.governor.wait_idle(timeout=timeout)

    def close(self, timeout: float | None = None):
        self.flush(timeout=timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._writer.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- group sizing ------------------------------------------------------

    def effective_group_rows(self) -> int:
        """Static cap, shrunk to what the latency budget affords at the
        EWMA per-row write cost (scan/batcher.py's effective_max_batch
        shape, row-denominated)."""
        cap = self._group_rows
        budget_ms = INGEST_LATENCY_BUDGET_MS.as_float()
        if budget_ms and budget_ms > 0 and self._cost_ewma:
            cap = min(cap, max(_MIN_GROUP_ROWS,
                               int((budget_ms / 1000.0) / self._cost_ewma)))
        return max(1, cap)

    def _observe(self, rows: int, elapsed_s: float):
        if rows <= 0:
            return
        per_row = elapsed_s / rows
        self._cost_ewma = (per_row if self._cost_ewma is None
                           else _EWMA_ALPHA * per_row
                           + (1.0 - _EWMA_ALPHA) * self._cost_ewma)
        if elapsed_s > 0:
            rate = rows / elapsed_s
            self._rate_ewma = (rate if self._rate_ewma is None
                               else _EWMA_ALPHA * rate
                               + (1.0 - _EWMA_ALPHA) * self._rate_ewma)
            metrics.gauge("ingest.rows.per.s", int(self._rate_ewma))

    def observe_context(self, ctx) -> dict[str, int]:
        """Publish converter counters into ingest metrics (the
        EvaluationContext merge point)."""
        counts = ctx.counters()
        metrics.gauge("ingest.convert.success", counts["success"])
        metrics.gauge("ingest.convert.failure", counts["failure"])
        metrics.gauge("ingest.convert.lines", counts["line"])
        return counts

    # -- writer thread -----------------------------------------------------

    def _next_group(self) -> list | None:
        """Pop a same-type run from the queue head, capped at the
        effective group rows. Returns None once closed and drained."""
        with self._cv:
            while not self._q:
                if self._closed:
                    return None
                self._cv.wait()
            cap = self.effective_group_rows()
            type_name = self._q[0][0]
            group = [self._q.popleft()]
            rows = group[0][1].n
            while (self._q and self._q[0][0] == type_name
                   and rows + self._q[0][1].n <= cap):
                entry = self._q.popleft()
                rows += entry[1].n
                group.append(entry)
            return group

    def _shed_pause(self):
        """Yield to deep read queues, briefly and boundedly: commit
        latency stays finite even under a permanently-saturated read
        tier."""
        if self.governor.should_shed():
            metrics.counter("ingest.shed.pauses")
            pause_ms = INGEST_SHED_PAUSE_MS.as_float() or 0.0
            if pause_ms > 0:
                time.sleep(pause_ms / 1000.0)

    def _run(self):
        while True:
            group = self._next_group()
            if group is None:
                return
            type_name = group[0][0]
            rows = sum(e[1].n for e in group)
            self._shed_pause()
            t0 = time.perf_counter()
            from ..obs import tracer
            gsp = tracer.span("group-commit", type_name, root=True)
            if gsp.span_id is not None:
                # link the commit span to every staged caller's trace so
                # a write's trace resolves to the fsync that durably
                # committed it (and vice versa)
                for e in group:
                    ctx = e[4]
                    if ctx is None:
                        continue
                    state, wsp = ctx
                    gsp.link(state.trace_id, wsp.span_id)
                    wsp.link(gsp.trace_id, gsp.span_id)
            try:
                with gsp:
                    gsp.set_attr(rows=rows, staged=len(group))
                    from ..obs.prof import watchdog
                    with watchdog.watch(f"ingest.commit.{type_name}",
                                        span=gsp):
                        result = self.store.write_many(
                            type_name, [(e[1], e[2]) for e in group])
            except BaseException as exc:  # noqa: BLE001 (the acks carry it)
                metrics.counter("ingest.errors")
                for e in group:
                    e[3]._complete(error=exc)
            else:
                elapsed = time.perf_counter() - t0
                self._observe(rows, elapsed)
                metrics.counter("ingest.rows", rows)
                metrics.counter("ingest.groups")
                metrics.counter("ingest.staged.batches", len(group))
                metrics.gauge("ingest.group.rows", rows)
                metrics.gauge("ingest.group.cap",
                              self.effective_group_rows())
                for e in group:
                    e[3]._complete(result=result)
            finally:
                self.governor.release(rows)
                for e in group:
                    if len(e) > 5 and e[5] is not None:
                        from ..tenants import tenant_registry
                        tenant_registry.release_rows(e[5], e[1].n)
