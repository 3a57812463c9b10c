"""Audit events + writers."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any

__all__ = ["QueryEvent", "AuditLogger"]


@dataclasses.dataclass
class QueryEvent:
    """One audited query (QueryEvent.scala:13 fields, enriched with
    the tracing/serving context the unified hook collects)."""
    type_name: str
    user: str
    filter: str
    hints: dict[str, Any]
    date_ms: int
    plan_time_ms: float
    scan_time_ms: float
    hits: int
    # -- enrichment (hook.py fills these; defaults keep old callers
    # and persisted JSONL compatible) --------------------------------
    trace_id: str | None = None
    surface: str | None = None      # memory/mesh/remote/replicated/...
    index: str | None = None        # index chosen by the planner
    rows_scanned: int | None = None  # scanned vs. `hits` returned
    cache_hit: bool = False
    batched: bool = False
    hedged: bool = False
    tenant: str | None = None       # QoS tenant (tenants plane)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)


class AuditLogger:
    """Keeps a bounded in-memory ring and optionally appends JSONL to a
    file (the async table writer of AccumuloAuditService, minus the
    table).

    Thread-safe: concurrent web workers audit through one logger, so
    ring appends and file writes serialize under a lock, and each event
    is written as one whole line + flush (no interleaved partial
    lines). ``query()`` snapshots the ring under the same lock so
    readers never iterate a deque mid-append."""

    def __init__(self, path: str | None = None, capacity: int = 10_000):
        import collections
        self.path = path
        self.capacity = capacity
        self.events: "collections.deque[QueryEvent]" = \
            collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def write(self, event: QueryEvent):
        line = (event.to_json() + "\n") if self.path else None
        with self._lock:
            self.events.append(event)
            if line is not None:
                with open(self.path, "a") as fh:
                    fh.write(line)
                    fh.flush()

    def record(self, type_name: str, filter_str: str, hints: dict,
               plan_time_ms: float, scan_time_ms: float, hits: int,
               user: str = "unknown", **enrich):
        self.write(QueryEvent(type_name, user, filter_str, hints,
                              int(time.time() * 1000), plan_time_ms,
                              scan_time_ms, hits, **enrich))

    def query(self, type_name: str | None = None,
              since_ms: int | None = None) -> list[QueryEvent]:
        with self._lock:
            out = list(self.events)
        if type_name is not None:
            out = [e for e in out if e.type_name == type_name]
        if since_ms is not None:
            out = [e for e in out if e.date_ms >= since_ms]
        return out
