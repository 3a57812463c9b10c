"""Retry policy: exponential backoff + full jitter, deadlines, budget.

The reference never writes this logic — Accumulo Thrift scanners and
HBase RPC retry, back off and fail over inside the client stacks, so
GeoMesaDataStore sees transient faults as slow calls, not errors. The
port's networked tier is stdlib TCP; this module is the missing client
stack under ``SocketBus``:

- full-jitter exponential backoff (sleep ~ U(0, min(cap, base *
  2^attempt))) so synchronized clients don't retry in lockstep;
- per-call total deadline on top of the attempt cap, so a retried call
  has bounded worst-case latency;
- a token-bucket retry budget shared across calls: each first attempt
  deposits a fraction of a token, each retry withdraws one, so a hard
  outage degrades to ~ratio extra load instead of a retry storm;
- classification by the EXCEPTION, not the call site: raisers tag
  errors with ``retryable`` (and optionally ``retry_after_s``, the
  server's explicit backpressure) and the default classifier falls back
  to connection/timeout types.

Every retry counts ``resilience.retries`` (and a per-site
``resilience.retries.<name>``) in the metrics registry and annotates the
current trace span. With QoS on and a tenant bound, a call charges that
tenant's own budget (``tenants.tenant_budget``) instead of the policy's.
"""

from __future__ import annotations

import random
import threading
import time

from ..metrics import metrics
from ..utils.properties import SystemProperty

__all__ = ["RetryPolicy", "RetryBudget", "default_retryable",
           "RETRY_ATTEMPTS", "RETRY_BASE_MS", "RETRY_CAP_MS",
           "RETRY_DEADLINE", "RETRY_BUDGET_SCALE"]

# layered knobs (env -> process override -> default), the JAX package's
RETRY_ATTEMPTS = SystemProperty("geomesa.retry.attempts", "5")
RETRY_BASE_MS = SystemProperty("geomesa.retry.base.ms", "50")
RETRY_CAP_MS = SystemProperty("geomesa.retry.cap.ms", "2000")
RETRY_DEADLINE = SystemProperty("geomesa.retry.deadline", "30s")
# live multiplier on every budget's capacity (0..1]: shrinking it stops
# retries from amplifying an outage
RETRY_BUDGET_SCALE = SystemProperty("geomesa.retry.budget.scale", "1")


def default_retryable(exc: BaseException) -> bool:
    """An explicit ``retryable`` tag on the exception wins; untagged
    connection-shaped failures (reset, refused, timeout) retry."""
    tag = getattr(exc, "retryable", None)
    if tag is not None:
        return bool(tag)
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


class RetryBudget:
    """Token bucket bounding retry amplification: first attempts
    deposit ``ratio`` tokens (capped), retries withdraw one. During a
    full outage the extra retry load converges to ~ratio of the offered
    load instead of multiplying it."""

    def __init__(self, capacity: float = 10.0, ratio: float = 0.2):
        self.capacity = float(capacity)
        self.ratio = float(ratio)
        self._tokens = float(capacity)
        self._lock = threading.Lock()

    def effective_capacity(self) -> float:
        """Capacity after the live ``geomesa.retry.budget.scale``
        multiplier, re-read per call."""
        try:
            scale = float(RETRY_BUDGET_SCALE.get() or 1.0)
        except (TypeError, ValueError):
            scale = 1.0
        return self.capacity * min(max(scale, 0.0), 1.0)

    def deposit(self):
        with self._lock:
            self._tokens = min(self.effective_capacity(),
                               self._tokens + self.ratio)

    def try_withdraw(self) -> bool:
        with self._lock:
            cap = self.effective_capacity()
            if self._tokens > cap:
                # the scale was tightened while tokens were banked:
                # clamp down so the stored surplus cannot fund a storm
                self._tokens = cap
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class RetryPolicy:
    """Run a callable with bounded retries.

    ``call(fn)`` invokes ``fn()`` until it returns, raises a
    non-retryable error, or the policy gives up (attempt cap, total
    deadline, or drained budget) — then the LAST error propagates
    unchanged, so callers keep their typed exceptions."""

    def __init__(self, max_attempts: int | None = None,
                 base_s: float | None = None, cap_s: float | None = None,
                 total_deadline_s: float | None = None,
                 budget: RetryBudget | None = None,
                 sleep=time.sleep, rng: random.Random | None = None,
                 registry=metrics):
        self.max_attempts = (RETRY_ATTEMPTS.as_int()
                             if max_attempts is None else int(max_attempts))
        self.base_s = ((RETRY_BASE_MS.as_float() or 50.0) / 1e3
                       if base_s is None else float(base_s))
        self.cap_s = ((RETRY_CAP_MS.as_float() or 2000.0) / 1e3
                      if cap_s is None else float(cap_s))
        self.total_deadline_s = (RETRY_DEADLINE.as_seconds()
                                 if total_deadline_s is None
                                 else total_deadline_s)
        self.budget = budget
        self._sleep = sleep
        self._rng = rng or random
        self._registry = registry

    def _call_budget(self):
        """The budget THIS call charges: with QoS on and a tenant bound,
        the tenant's own RetryBudget (so one tenant exhausting retries
        cannot drain anybody else's); otherwise the policy's shared
        budget."""
        from ..tenants import tenant_budget
        tb = tenant_budget()
        return tb if tb is not None else self.budget

    def backoff_s(self, attempt: int) -> float:
        """Full jitter: U(0, min(cap, base * 2^(attempt-1)))."""
        ceiling = min(self.cap_s, self.base_s * (2 ** max(attempt - 1, 0)))
        return self._rng.uniform(0.0, ceiling)

    def call(self, fn, *, retryable=None, on_retry=None, name: str = ""):
        classify = retryable or default_retryable
        deadline = (None if self.total_deadline_s is None
                    else time.monotonic() + self.total_deadline_s)
        budget = self._call_budget()
        if budget is not None:
            budget.deposit()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                attempt += 1
                if not classify(e) or attempt >= self.max_attempts:
                    raise
                # server-directed backpressure overrides the computed
                # backoff
                delay = getattr(e, "retry_after_s", None)
                if delay is None:
                    delay = self.backoff_s(attempt)
                if deadline is not None \
                        and time.monotonic() + delay > deadline:
                    raise
                if budget is not None and not budget.try_withdraw():
                    self._registry.counter("resilience.budget.exhausted")
                    from ..tenants import active_tenant, tenant_label
                    t = active_tenant()
                    if t is not None:
                        self._registry.counter(
                            "qos.retry.exhausted",
                            labels={"tenant": tenant_label(t)})
                    raise
                self._registry.counter("resilience.retries")
                if name:
                    self._registry.counter(f"resilience.retries.{name}")
                from ..obs import annotate
                annotate("retry", name=name, attempt=attempt,
                         error=type(e).__name__,
                         delay_ms=round(delay * 1000, 3))
                if on_retry is not None:
                    on_retry(e, attempt, delay)
                self._sleep(delay)
