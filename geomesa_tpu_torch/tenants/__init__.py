"""The tenant isolation plane: identity, policy, and per-tenant budgets.

Millions of users means noisy neighbors. Every scaling primitive the
serving tier owns — retry/hedge budgets, load shedding, fused batch
admission, the cache byte budget, the ingest row bucket — is
process-global by default, so one abusive caller degrades everyone.
This module is the shared spine that makes them tenant-aware:

- **identity** — ``geomesa.web.auth.tokens`` maps bearer tokens to
  tenant names (``tok1:alice,tok2:bob``); the legacy single
  ``geomesa.web.auth.token`` (and anonymous callers) resolve to the
  ``default`` tenant. A serving front end resolves the token once per
  request and runs the handler under ``tenant_scope``; a contextvar
  carries the name through batcher admission, retries, copied contexts
  (``contextvars.copy_context``), ingest staging and cache lookups
  without any surface plumbing arguments.
- **policy** — ``TenantPolicy`` reads per-tenant knobs LIVE
  (``geomesa.qos.tenant.<name>.weight`` etc., falling back to the
  process-wide ``geomesa.qos.*`` defaults), so operators can retune a
  running tier per tenant.
- **state** — ``TenantRegistry`` owns each tenant's ``RetryBudget``,
  web in-flight counter and ingest row bucket, and publishes the
  ``/rest/qos`` status document.
- **fair share** — ``weighted_drain`` is the deficit-weighted
  round-robin the batcher uses to fill fused dispatch chunks from
  per-tenant FIFO queues: a 2:1 weight ratio yields a 2:1 dispatch
  share under contention, an idle tenant's deficit resets instead of
  accumulating, and order WITHIN a tenant stays FIFO.

Kill switch: ``geomesa.qos.enabled`` (default false). Off,
``active_tenant()`` is None everywhere, so every touch point takes its
pre-QoS path bit-identically — admission order, shed decisions, cache
keys and budgets are unchanged.

Metric labels always pass tenant names through ``tenant_label``
(``sanitize_key``), and the registry's ``geomesa.metrics.max.series``
guard bounds per-tenant series cardinality (overflow collapses to
``other``).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from dataclasses import dataclass

from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

__all__ = ["QOS_ENABLED", "WEB_AUTH_TOKENS", "DEFAULT_TENANT",
           "TenantPolicy", "TenantRegistry", "tenant_registry",
           "qos_enabled", "tenant_scope", "active_tenant",
           "tenant_budget", "tenant_label", "weighted_drain"]

# master kill switch: off (the default) is bit-identical to the
# pre-QoS serving tier on every touched surface
QOS_ENABLED = SystemProperty("geomesa.qos.enabled", "false")
# "token:tenant,token2:tenant2" — the multi-tenant face of the single
# geomesa.web.auth.token (which keeps gating mutations and maps to the
# "default" tenant)
WEB_AUTH_TOKENS = SystemProperty("geomesa.web.auth.tokens", None)

# process-wide per-tenant defaults; geomesa.qos.tenant.<name>.<suffix>
# overrides any of them for one tenant
QOS_WEIGHT = SystemProperty("geomesa.qos.weight", "1")
QOS_RETRY_BUDGET = SystemProperty("geomesa.qos.retry.budget", "10")
QOS_MAX_INFLIGHT = SystemProperty("geomesa.qos.max.inflight", None)
QOS_MAX_INFLIGHT_ROWS = SystemProperty("geomesa.qos.max.inflight.rows",
                                       None)
QOS_CACHE_MAX_BYTES = SystemProperty("geomesa.qos.cache.max.bytes", None)
QOS_VISIBILITY = SystemProperty("geomesa.qos.visibility", None)

DEFAULT_TENANT = "default"

_tenant: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_qos_tenant", default=None)


def qos_enabled() -> bool:
    """Re-read per call: the kill switch works on a live tier."""
    return str(QOS_ENABLED.get()).lower() in ("true", "1", "yes")


@contextlib.contextmanager
def tenant_scope(name: str | None):
    """Bind the calling context's tenant identity (web auth sets it;
    copied contexts — hedge attempts, scatter legs — inherit it)."""
    token = _tenant.set(name)
    try:
        yield
    finally:
        _tenant.reset(token)


def active_tenant() -> str | None:
    """The context's tenant, or None when QoS is disabled — the single
    gate every touch point checks, so the off path never branches."""
    if not qos_enabled():
        return None
    return _tenant.get()


def tenant_label(name: str) -> str:
    """Metric-safe tenant label: hostile/odd names collapse through
    ``sanitize_key`` so a tenant id can never mint unbounded or
    exposition-breaking label values."""
    return sanitize_key(str(name)) or "other"


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's QoS envelope, resolved from live knobs."""
    name: str
    weight: float = 1.0
    retry_budget: float = 10.0
    max_inflight: int | None = None
    max_inflight_rows: int | None = None
    cache_max_bytes: int | None = None
    visibility: str = ""


class _TenantState:
    __slots__ = ("budget", "inflight", "rows", "sheds", "row_refusals")

    def __init__(self, budget):
        self.budget = budget
        self.inflight = 0
        self.rows = 0
        self.sheds = 0
        self.row_refusals = 0


class TenantRegistry:
    """Token resolution, live policy reads, and per-tenant runtime
    state (retry budget, web in-flight count, ingest row bucket)."""

    def __init__(self, registry=metrics):
        self._registry = registry
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._state: dict[str, _TenantState] = {}

    # -- identity ----------------------------------------------------------

    def resolve_token(self, token: str | None) -> str:
        """Bearer token -> tenant name. Unknown/absent tokens (and the
        legacy single ``geomesa.web.auth.token``) are the ``default``
        tenant, so pre-QoS deployments keep one well-defined bucket."""
        raw = WEB_AUTH_TOKENS.get()
        if token and raw:
            for part in str(raw).split(","):
                tok, _, name = part.strip().partition(":")
                if tok and name and tok == token:
                    return name
        return DEFAULT_TENANT

    # -- policy ------------------------------------------------------------

    def policy(self, tenant: str) -> TenantPolicy:
        """Read the tenant's knobs LIVE (per-tenant override wins over
        the process-wide ``geomesa.qos.*`` default)."""
        def raw(suffix: str, default_prop: SystemProperty):
            v = SystemProperty(
                f"geomesa.qos.tenant.{tenant}.{suffix}", None).get()
            return v if v is not None else default_prop.get()

        def as_f(suffix, default_prop, fallback):
            v = raw(suffix, default_prop)
            try:
                return fallback if v is None else float(v)
            except (TypeError, ValueError):
                return fallback

        def as_i(suffix, default_prop):
            v = raw(suffix, default_prop)
            try:
                return None if v is None else int(v)
            except (TypeError, ValueError):
                return None

        return TenantPolicy(
            name=tenant,
            weight=max(as_f("weight", QOS_WEIGHT, 1.0), 1e-3),
            retry_budget=max(as_f("retry.budget", QOS_RETRY_BUDGET,
                                  10.0), 0.0),
            max_inflight=as_i("max.inflight", QOS_MAX_INFLIGHT),
            max_inflight_rows=as_i("max.inflight.rows",
                                   QOS_MAX_INFLIGHT_ROWS),
            cache_max_bytes=as_i("cache.max.bytes", QOS_CACHE_MAX_BYTES),
            visibility=str(raw("visibility", QOS_VISIBILITY) or ""))

    # -- state -------------------------------------------------------------

    def state(self, tenant: str) -> _TenantState:
        with self._lock:
            st = self._state.get(tenant)
            if st is None:
                from ..resilience.policy import RetryBudget
                st = _TenantState(
                    RetryBudget(capacity=self.policy(tenant).retry_budget))
                self._state[tenant] = st
                self._registry.gauge("qos.tenants", len(self._state))
            return st

    def retry_budget(self, tenant: str):
        return self.state(tenant).budget

    # -- web in-flight caps ------------------------------------------------

    def try_acquire_inflight(self, tenant: str) -> bool:
        """One web request slot for ``tenant``; False = shed (503) —
        only THIS tenant is over its cap, others keep proceeding."""
        cap = self.policy(tenant).max_inflight
        label = tenant_label(tenant)
        with self._lock:
            st = self.state(tenant)
            if cap is not None and st.inflight >= cap:
                st.sheds += 1
                self._registry.counter("qos.web.sheds",
                                       labels={"tenant": label})
                return False
            st.inflight += 1
            self._registry.gauge("qos.web.inflight", st.inflight,
                                 labels={"tenant": label})
        return True

    def release_inflight(self, tenant: str):
        with self._lock:
            st = self.state(tenant)
            st.inflight = max(0, st.inflight - 1)
            self._registry.gauge("qos.web.inflight", st.inflight,
                                 labels={"tenant": tenant_label(tenant)})

    # -- ingest row buckets ------------------------------------------------

    def acquire_rows(self, tenant: str, rows: int, block: bool = True,
                     timeout: float | None = None) -> bool:
        """Admit ``rows`` against the tenant's in-flight bucket
        (``IngestGovernor.acquire`` semantics: an oversize batch is
        admitted alone once the bucket drains). No cap configured ->
        rows are tracked for status but never refused."""
        cap = self.policy(tenant).max_inflight_rows
        label = tenant_label(tenant)
        with self._cv:
            st = self.state(tenant)
            if cap is not None:
                while st.rows > 0 and st.rows + rows > cap:
                    if not block:
                        st.row_refusals += 1
                        self._registry.counter(
                            "qos.ingest.refused", labels={"tenant": label})
                        return False
                    if not self._cv.wait(timeout=timeout):
                        st.row_refusals += 1
                        self._registry.counter(
                            "qos.ingest.refused", labels={"tenant": label})
                        return False
            st.rows += rows
            self._registry.gauge("qos.ingest.rows", st.rows,
                                 labels={"tenant": label})
        return True

    def release_rows(self, tenant: str, rows: int):
        with self._cv:
            st = self.state(tenant)
            st.rows = max(0, st.rows - rows)
            self._registry.gauge("qos.ingest.rows", st.rows,
                                 labels={"tenant": tenant_label(tenant)})
            self._cv.notify_all()

    # -- surfaces ----------------------------------------------------------

    def status(self) -> dict:
        """The ``/rest/qos`` document: every tenant seen so far with
        its live policy and runtime budget state."""
        with self._lock:
            tenants = {}
            for name, st in self._state.items():
                pol = self.policy(name)
                tenants[name] = {
                    "weight": pol.weight,
                    "inflight": st.inflight,
                    "max_inflight": pol.max_inflight,
                    "inflight_rows": st.rows,
                    "max_inflight_rows": pol.max_inflight_rows,
                    "retry_budget_tokens": round(st.budget.tokens, 3),
                    "retry_budget_capacity":
                        round(st.budget.effective_capacity(), 3),
                    "cache_max_bytes": pol.cache_max_bytes,
                    "visibility": pol.visibility,
                    "sheds": st.sheds,
                    "row_refusals": st.row_refusals,
                }
        return {"enabled": qos_enabled(), "tenants": tenants}

    def reset(self):
        """Drop all tenant state (test/bench hygiene)."""
        with self._lock:
            self._state.clear()


def tenant_budget():
    """The active tenant's RetryBudget, or None when QoS is off / no
    tenant is bound — retry/hedge policies substitute it for their
    shared budget so one tenant draining retries cannot suppress
    another's hedging."""
    t = active_tenant()
    if t is None:
        return None
    return tenant_registry.retry_budget(t)


def weighted_drain(queues: dict, deficits: dict, cap: int,
                   weight_of=None) -> list:
    """One deficit-weighted round-robin fill: pop up to ``cap`` items
    across per-tenant FIFO ``queues`` (mutated in place). Each round
    credits every backlogged tenant ``weight`` deficit and spends whole
    units, so sustained 2:1 weights dispatch 2:1 shares. ``deficits``
    persists across calls (unspent credit carries to the next chunk);
    a tenant whose queue is empty has its deficit dropped — idle
    tenants never bank unbounded credit."""
    out: list = []
    for t in list(deficits):
        if not queues.get(t):
            deficits.pop(t)
    active = sorted(t for t, q in queues.items() if q)
    if not active:
        return out
    weights = {t: max(float(weight_of(t)) if weight_of else 1.0, 1e-3)
               for t in active}
    while len(out) < cap and any(queues[t] for t in active):
        for t in active:
            q = queues[t]
            if not q:
                deficits.pop(t, None)
                continue
            deficits[t] = deficits.get(t, 0.0) + weights[t]
            while deficits[t] >= 1.0 and q and len(out) < cap:
                out.append(q.pop(0))
                deficits[t] -= 1.0
            if not q:
                deficits.pop(t, None)
            if len(out) >= cap:
                break
    return out


tenant_registry = TenantRegistry()
