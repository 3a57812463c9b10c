"""The unified query-audit hook: every query surface (memory / mesh /
remote / replicated / cluster) records its ``QueryEvent`` through
``audit_query`` so the audit plane is complete instead of
store-dependent.

Three pieces make that work:

- **global fallback logger** — a store constructed without an explicit
  ``AuditLogger`` records into the process-wide ring (JSONL path from
  ``geomesa.audit.path``), so an audit surface fronting a cluster
  coordinator or remote client still answers;
- **delegation suppression** — a fronting tier (cluster coordinator,
  replica router) records ONE event for the whole query and runs its
  delegate legs under ``delegated_scope()``; the inner stores' hooks
  see the contextvar and skip, so one logical query never
  double-audits. The scope is a contextvar, so it survives the
  coordinator's ``contextvars.copy_context()``-wrapped scatter
  threads;
- **context enrichment** — the hook stamps each event with the current
  trace id, the authenticated principal (web tier sets
  ``principal_scope``), and the cache/hedge flags instrumentation set
  on the trace (obs.set_flag), without any surface having to plumb
  those arguments through;
- **caller attribution** — a fan-in tier that runs other callers'
  queries on its own thread (the batcher's leader) names each query's
  caller context in ``caller_contexts``; the store writes that query's
  event inside its caller's context (``caller_context``), so a fused
  query is audited under its own caller's trace, principal and tenant.
  The JAX package audits it under the leader's (ROADMAP.md section 3).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

from ..utils.properties import SystemProperty
from .events import AuditLogger

__all__ = ["AUDIT_PATH", "global_audit", "audit_query",
           "delegated_scope", "principal_scope", "current_principal",
           "caller_contexts", "caller_context"]

AUDIT_PATH = SystemProperty("geomesa.audit.path", None)

_global: AuditLogger | None = None
_global_lock = threading.Lock()

_suppress: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_audit_suppress", default=False)
_principal: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_audit_principal", default=None)
# id(query) -> (query, the caller's contextvars.Context)
_callers: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_audit_callers", default=None)


def global_audit() -> AuditLogger:
    """The process-wide fallback logger (lazy; picks up
    ``geomesa.audit.path`` at first use)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = AuditLogger(path=AUDIT_PATH.get())
        return _global


def _reset_global():
    """Test hook: drop the cached global logger so a changed
    ``geomesa.audit.path`` takes effect."""
    global _global
    with _global_lock:
        _global = None


@contextlib.contextmanager
def delegated_scope():
    """Mark the dynamic extent of a fronting tier's delegate calls:
    inner surfaces skip auditing (the tier records the one event)."""
    token = _suppress.set(True)
    try:
        yield
    finally:
        _suppress.reset(token)


@contextlib.contextmanager
def principal_scope(principal: str | None):
    token = _principal.set(principal)
    try:
        yield
    finally:
        _principal.reset(token)


def current_principal() -> str | None:
    return _principal.get()


@contextlib.contextmanager
def caller_contexts(pairs):
    """Name the caller context of each query run in this block:
    ``pairs`` of (query object, ``contextvars.Context`` copied on the
    caller's thread)."""
    token = _callers.set({id(q): (q, ctx) for q, ctx in pairs})
    try:
        yield
    finally:
        _callers.reset(token)


def caller_context(query) -> contextvars.Context | None:
    """The caller context ``caller_contexts`` named for this query
    object, or None (the query runs on its caller's own thread)."""
    named = _callers.get()
    hit = named.get(id(query)) if named else None
    return hit[1] if hit is not None and hit[0] is query else None


def audit_query(audit: AuditLogger | None, surface: str,
                type_name: str, filter_str: str, hints: dict | None,
                plan_ms: float, scan_ms: float, hits: int, *,
                index: str | None = None,
                rows_scanned: int | None = None,
                batched: bool = False,
                user: str | None = None) -> bool:
    """Record one query through the shared hook. ``audit`` is the
    surface's own logger (None -> global fallback). Returns False when
    suppressed by an enclosing ``delegated_scope``."""
    if _suppress.get():
        return False
    from ..obs import current_trace_id, get_flag
    from ..tenants import active_tenant
    logger = audit if audit is not None else global_audit()
    logger.record(
        type_name, filter_str, hints or {},
        round(float(plan_ms), 3), round(float(scan_ms), 3), int(hits),
        user=user or current_principal() or "unknown",
        trace_id=current_trace_id(), surface=surface, index=index,
        rows_scanned=rows_scanned,
        cache_hit=bool(get_flag("cache_hit", False)),
        batched=batched or bool(get_flag("batched", False)),
        hedged=bool(get_flag("hedged", False)),
        tenant=active_tenant())
    return True
