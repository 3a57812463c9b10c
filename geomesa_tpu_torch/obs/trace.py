"""Dapper-style request tracing (the observability substrate the
serving, multi-host and multi-tenant tiers report through).

Model
-----
A **trace** is a tree of **spans** sharing one ``trace_id``. Spans are
propagated in-process through a ``contextvars.ContextVar`` (so nested
``with tracer.span(...)`` calls parent correctly across the async-free
thread-per-request server) and across the wire through the
``X-GeoMesa-Trace`` header (``trace_id:span_id:sampled``), so one trace
stitches the RemoteDataStore client leg, the web handler, and the
downstream cluster shard legs into a single tree.

Two capture policies compose:

- **head sampling** — ``geomesa.trace.sample`` (probability 0..1)
  decides at the local root whether the trace is kept regardless of
  outcome; the decision rides the wire flag so downstream processes
  keep their halves too;
- **slow-query always-capture** — every local root buffers its spans,
  and if the root exceeds ``geomesa.trace.slow.ms`` the trace is kept
  even when sampling said no. Set the threshold to 0 to disable.

Kept traces land in a bounded in-memory ring (total spans capped by
``geomesa.trace.max.spans``, oldest trace evicted whole) and are
optionally appended as JSONL to ``geomesa.trace.path``. ``traces()``
and ``get(trace_id)`` read the ring (the list / get-by-id documents a
``/rest/trace`` surface serves).

Fan-in legs (the batcher's fused dispatch serving N coalesced queries,
the ingest group commit covering N staged batches) record **links** to
the waiting callers' spans; ``Tracer.graft`` additionally clones the
dispatch subtree into each follower's trace so a follower's slow-query
capture still shows where its time went.
"""

from __future__ import annotations

import contextvars
import json
import random
import threading
import time
from collections import OrderedDict

from ..utils.properties import SystemProperty

__all__ = [
    "TRACE_HEADER", "TRACE_SAMPLE", "TRACE_SLOW_MS", "TRACE_MAX_SPANS",
    "TRACE_PATH", "Span", "Tracer", "tracer", "annotate", "set_flag",
    "get_flag", "current_trace_id",
]

TRACE_HEADER = "X-GeoMesa-Trace"

TRACE_SAMPLE = SystemProperty("geomesa.trace.sample", "0")
TRACE_SLOW_MS = SystemProperty("geomesa.trace.slow.ms", "1000")
TRACE_MAX_SPANS = SystemProperty("geomesa.trace.max.spans", "8192")
TRACE_PATH = SystemProperty("geomesa.trace.path", None)


def _new_id() -> str:
    return f"{random.getrandbits(64):016x}"


class _TraceState:
    """Per-trace bookkeeping shared by every span of one local trace:
    the head-sampling decision, the finished-span buffer (kept or
    dropped wholesale when the local root ends), and the flags dict
    cross-layer instrumentation writes into (cache_hit, hedged, ...)
    so the audit hook can read them without plumbing arguments through
    every tier."""

    __slots__ = ("trace_id", "sampled", "spans", "flags", "start_ms")

    def __init__(self, trace_id: str, sampled: bool):
        self.trace_id = trace_id
        self.sampled = sampled
        self.spans: list[Span] = []
        self.flags: dict = {}
        self.start_ms = int(time.time() * 1000)


# (state, current span) — None outside any trace
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_trace_ctx", default=None)


class Span:
    """One timed operation. Context manager: entering makes it the
    current span for the calling context; exiting records it into the
    trace buffer and, for the local root, decides keep/drop."""

    __slots__ = ("trace_id", "span_id", "parent_id", "kind", "name",
                 "start_ms", "duration_ms", "attrs", "annotations",
                 "links", "error", "_t0", "_state", "_token", "_root")

    def __init__(self, state: _TraceState, kind: str, name: str,
                 parent_id: str | None, root: bool):
        self.trace_id = state.trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.kind = kind
        self.name = name
        self.start_ms = int(time.time() * 1000)
        self.duration_ms = 0.0
        self.attrs: dict = {}
        self.annotations: list = []
        self.links: list = []
        self.error: str | None = None
        self._t0 = time.perf_counter()
        self._state = state
        self._token = None
        self._root = root

    # -- enrichment -------------------------------------------------
    def annotate(self, text: str, **attrs):
        note = {"t_ms": round((time.perf_counter() - self._t0) * 1000, 3),
                "text": str(text)}
        if attrs:
            note.update(attrs)
        self.annotations.append(note)

    def set_attr(self, **attrs):
        self.attrs.update(attrs)

    def link(self, trace_id: str, span_id: str):
        self.links.append({"trace_id": trace_id, "span_id": span_id})

    def set_flag(self, name: str, value=True):
        """Set a trace-level flag (read by the audit hook) directly on
        this span's trace — usable from callback threads that do not
        carry the caller's contextvars."""
        self._state.flags[name] = value

    # -- context protocol -------------------------------------------
    def __enter__(self):
        self._token = _CTX.set((self._state, self))
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and self.error is None:
            self.error = f"{type(exc).__name__}: {exc}"
        self.finish()
        return False

    def finish(self):
        if self._token is not None:
            try:
                _CTX.reset(self._token)
            except ValueError:
                # crossed a context boundary (finished in a different
                # context than it was entered in); current-span cleanup
                # is best-effort there
                pass
            self._token = None
        if self.duration_ms == 0.0:
            self.duration_ms = round(
                (time.perf_counter() - self._t0) * 1000, 3)
        self._state.spans.append(self)
        if self._root:
            tracer._finalize(self._state, self)

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "kind": self.kind,
             "name": self.name, "start_ms": self.start_ms,
             "duration_ms": self.duration_ms}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.annotations:
            d["annotations"] = list(self.annotations)
        if self.links:
            d["links"] = list(self.links)
        if self.error:
            d["error"] = self.error
        return d

    def _clone_into(self, state: _TraceState,
                    parent_id: str | None) -> "Span":
        c = Span.__new__(Span)
        c.trace_id = state.trace_id
        c.span_id = self.span_id      # identity preserved: the link
        c.parent_id = parent_id       # from the follower resolves it
        c.kind = self.kind
        c.name = self.name
        c.start_ms = self.start_ms
        c.duration_ms = self.duration_ms
        c.attrs = dict(self.attrs)
        c.annotations = list(self.annotations)
        c.links = list(self.links)
        c.error = self.error
        c._t0 = self._t0
        c._state = state
        c._token = None
        c._root = False
        return c


class _NullSpan:
    """No-op stand-in when tracing is inactive for this call path:
    every method is a cheap no-op so instrumentation sites never
    branch."""

    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, text, **attrs):
        pass

    def set_attr(self, **attrs):
        pass

    def link(self, trace_id, span_id):
        pass

    def set_flag(self, name, value=True):
        pass

    def finish(self):
        pass


_NULL = _NullSpan()


class Tracer:
    """Process-wide tracer: span factory + bounded ring of kept
    traces."""

    def __init__(self):
        self._lock = threading.Lock()
        # trace_id -> list[span dict]; bounded by total span count
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        self._span_count = 0

    # -- configuration ---------------------------------------------
    @staticmethod
    def sample_rate() -> float:
        try:
            return float(TRACE_SAMPLE.get() or 0)
        except (TypeError, ValueError):
            return 0.0

    @staticmethod
    def slow_ms() -> float:
        try:
            return float(TRACE_SLOW_MS.get() or 0)
        except (TypeError, ValueError):
            return 0.0

    def enabled(self) -> bool:
        return self.sample_rate() > 0 or self.slow_ms() > 0

    # -- span factory ----------------------------------------------
    def span(self, kind: str, name: str = "", *, root: bool = False,
             remote: str | None = None):
        """Open a span. Child spans attach to the current context and
        no-op when there is none; ``root=True`` starts a new local
        trace (serving entry points: web handler, batcher admission,
        ingest group commit); ``remote`` is an incoming
        ``X-GeoMesa-Trace`` header value continuing a wire trace."""
        cur = _CTX.get()
        if cur is not None:
            state, parent = cur
            return Span(state, kind, name or kind, parent.span_id, False)
        wire = self.extract(remote) if remote else None
        if wire is not None:
            tid, parent_id, wire_sampled = wire
            if not (wire_sampled or self.enabled()):
                return _NULL
            state = _TraceState(tid, wire_sampled or self._head_sample())
            return Span(state, kind, name or kind, parent_id, True)
        if not root or not self.enabled():
            return _NULL
        state = _TraceState(_new_id(), self._head_sample())
        return Span(state, kind, name or kind, None, True)

    def _head_sample(self) -> bool:
        rate = self.sample_rate()
        if rate <= 0:
            return False
        if rate >= 1:
            return True
        return random.random() < rate

    # -- context access --------------------------------------------
    @staticmethod
    def current():
        """(state, span) of the calling context, or None. Capture this
        to link/graft across threads (batcher followers, scatter
        legs)."""
        return _CTX.get()

    @staticmethod
    def current_span():
        cur = _CTX.get()
        return cur[1] if cur is not None else _NULL

    # -- wire propagation ------------------------------------------
    def inject(self) -> str | None:
        """Header value carrying the current span context, or None."""
        cur = _CTX.get()
        if cur is None:
            return None
        state, span = cur
        return f"{state.trace_id}:{span.span_id}:{int(state.sampled)}"

    @staticmethod
    def extract(header: str | None):
        """Parse ``trace_id:span_id:sampled`` -> tuple or None."""
        if not header:
            return None
        parts = str(header).strip().split(":")
        if len(parts) != 3 or not parts[0] or not parts[1]:
            return None
        return parts[0], parts[1], parts[2] == "1"

    # -- fan-in stitching ------------------------------------------
    def graft(self, span: Span, targets) -> int:
        """Clone ``span`` and its finished descendants into each
        target context's trace (the batcher's fused dispatch subtree
        into every coalesced follower), re-parenting the subtree root
        under the target's current span. Span ids are preserved so the
        follower's recorded link resolves to the grafted copy. Returns
        the number of traces grafted into."""
        if isinstance(span, _NullSpan):
            return 0
        src = span._state
        by_id = {s.span_id: s for s in src.spans}
        subtree = []
        for s in src.spans:
            pid = s.span_id
            while pid is not None:
                if pid == span.span_id:
                    subtree.append(s)
                    break
                parent = by_id.get(pid)
                pid = parent.parent_id if parent is not None else None
        n = 0
        for ctx in targets:
            if not ctx:
                continue
            state, tspan = ctx
            if state is src:
                continue          # the leader already owns the subtree
            for s in subtree:
                state.spans.append(s._clone_into(
                    state, tspan.span_id if s is span else s.parent_id))
            n += 1
        return n

    # -- ring ------------------------------------------------------
    def _finalize(self, state: _TraceState, root: Span):
        keep = state.sampled
        if not keep:
            slow = self.slow_ms()
            keep = slow > 0 and root.duration_ms >= slow
        if not keep:
            state.spans.clear()
            return
        spans = [s.to_dict() for s in list(state.spans)]
        try:
            cap = int(float(TRACE_MAX_SPANS.get() or 8192))
        except (TypeError, ValueError):
            cap = 8192
        with self._lock:
            if state.trace_id in self._traces:
                # a second local root of the same wire trace (e.g. two
                # scatter legs hitting one shard server): merge
                self._span_count -= len(self._traces[state.trace_id])
                spans = self._traces.pop(state.trace_id) + spans
            self._traces[state.trace_id] = spans
            self._span_count += len(spans)
            while self._span_count > cap and len(self._traces) > 1:
                _, old = self._traces.popitem(last=False)
                self._span_count -= len(old)
        path = TRACE_PATH.get()
        if path:
            try:
                with open(path, "a") as fh:
                    for d in spans:
                        fh.write(json.dumps(d, default=str) + "\n")
            except OSError:
                pass

    def traces(self, limit: int = 50) -> list[dict]:
        """Newest-first trace summaries for ``GET /rest/trace``."""
        with self._lock:
            items = list(self._traces.items())
        out = []
        for tid, spans in reversed(items[-max(0, int(limit)):]):
            roots = [s for s in spans if s.get("parent_id") is None]
            head = roots[0] if roots else spans[0]
            out.append({
                "trace_id": tid, "spans": len(spans),
                "root_kind": head["kind"], "root_name": head["name"],
                "start_ms": head["start_ms"],
                "duration_ms": head["duration_ms"],
                "error": any(s.get("error") for s in spans),
                "kinds": sorted({s["kind"] for s in spans}),
            })
        return out

    def get(self, trace_id: str) -> list[dict] | None:
        with self._lock:
            spans = self._traces.get(trace_id)
            return list(spans) if spans is not None else None

    def clear(self):
        with self._lock:
            self._traces.clear()
            self._span_count = 0


tracer = Tracer()


# -- module-level conveniences (cheap no-ops outside a trace) --------
def annotate(text: str, **attrs):
    cur = _CTX.get()
    if cur is not None:
        cur[1].annotate(text, **attrs)


def set_flag(name: str, value=True):
    cur = _CTX.get()
    if cur is not None:
        cur[0].flags[name] = value


def get_flag(name: str, default=None):
    cur = _CTX.get()
    if cur is not None:
        return cur[0].flags.get(name, default)
    return default


def current_trace_id() -> str | None:
    cur = _CTX.get()
    return cur[0].trace_id if cur is not None else None
