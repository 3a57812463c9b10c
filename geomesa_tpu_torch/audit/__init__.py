"""Query auditing (index/audit/QueryEvent.scala:13 +
AccumuloAuditService analog): every query surface records an event —
type name, filter, hints, plan/scan timings, hit count, trace id,
index chosen, rows scanned, cache/batch/hedge flags, principal —
through the unified hook in hook.py to a pluggable writer (in-memory
ring, JSONL file)."""

from .events import AuditLogger, QueryEvent
from .hook import (AUDIT_PATH, audit_query, caller_context, caller_contexts,
                   current_principal, delegated_scope, global_audit,
                   principal_scope)

__all__ = ["AuditLogger", "QueryEvent", "AUDIT_PATH", "audit_query",
           "delegated_scope", "principal_scope", "current_principal",
           "global_audit", "caller_contexts", "caller_context"]
