"""Query timeout management.

Analog of ThreadManagement (geomesa-index-api/.../utils/
ThreadManagement.scala — a reaper sweeping open readers and killing
those past their timeout). A kernel launch is not interruptible, so
enforcement is at the store's stage boundaries: a ManagedQuery is
checked between pipeline stages via ``check()`` and the reaper marks
overdue queries terminated so their next check raises. The reaper's
thread starts at the first registration, never at import."""

from __future__ import annotations

import threading
import time

__all__ = ["ManagedQuery", "ThreadManagement", "QueryTimeout"]


class QueryTimeout(RuntimeError):
    pass


class ManagedQuery:
    def __init__(self, type_name: str, filter_str: str, timeout_s: float):
        self.type_name = type_name
        self.filter_str = filter_str
        self.timeout_s = timeout_s
        self.start = time.monotonic()
        self._terminated = threading.Event()

    @property
    def deadline(self) -> float:
        return self.start + self.timeout_s

    @property
    def overdue(self) -> bool:
        return time.monotonic() > self.deadline

    def terminate(self):
        self._terminated.set()

    def check(self):
        """Raise if the reaper (or the deadline) killed this query.
        Call between pipeline stages."""
        if self._terminated.is_set() or self.overdue:
            self._terminated.set()
            raise QueryTimeout(
                f"query on {self.type_name!r} exceeded "
                f"{self.timeout_s}s: {self.filter_str!r}")


class ThreadManagement:
    """Registry + background reaper (5s sweep in the reference; the
    interval is configurable here and the sweep also runs inline on
    register to keep tests deterministic)."""

    def __init__(self, sweep_interval_s: float = 5.0):
        self.sweep_interval_s = sweep_interval_s
        self._open: set[ManagedQuery] = set()
        self._lock = threading.Lock()
        self._reaper: threading.Thread | None = None
        self._stop = threading.Event()

    def register(self, q: ManagedQuery) -> ManagedQuery:
        with self._lock:
            self._open.add(q)
            if self._reaper is None:
                self._reaper = threading.Thread(target=self._run, daemon=True)
                self._reaper.start()
        return q

    def complete(self, q: ManagedQuery):
        with self._lock:
            self._open.discard(q)

    def sweep(self) -> int:
        """Terminate overdue queries; returns how many were killed."""
        killed = 0
        with self._lock:
            for q in list(self._open):
                if q.overdue:
                    q.terminate()
                    self._open.discard(q)
                    killed += 1
        return killed

    def _run(self):
        while not self._stop.wait(self.sweep_interval_s):
            self.sweep()

    def shutdown(self):
        self._stop.set()
