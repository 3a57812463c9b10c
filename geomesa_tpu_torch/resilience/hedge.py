"""Speculative request hedging: the tail-at-scale playbook.

A p99-slow call is usually slow for reasons a SECOND, independent
attempt does not share (a GC pause, a contended socket, one slow
replica). The hedge recipe: send the request, wait roughly the
endpoint's p99 latency, and if no answer has landed, send it again —
first success wins, the loser's result is discarded. Done naively this
doubles load during an outage, so every hedge is CHARGED to the shared
``RetryBudget`` (policy.py): when the budget is drained the call
degrades to a single attempt instead of amplifying a storm.

``HedgePolicy.call`` is the shared helper: a caller wraps each
idempotent read attempt in it, with the delay from ``delay_s`` (the
``BreakerBoard``'s per-endpoint p99 estimate, floored at
``geomesa.hedge.min.delay.ms``) and, for a scatter leg, a deadline on
top. Writes and non-idempotent calls NEVER hedge: a hedge that executes
twice must be invisible, and only idempotent reads are.

Rules enforced here:

- first success resolves the call; a losing attempt that completes
  later is discarded (``resilience.hedge.cancelled``) — no caller ever
  sees two deliveries;
- a failed first attempt hedges IMMEDIATELY (no point waiting out the
  delay when we already know the answer was an error);
- the hedge only launches if the budget grants a token
  (``resilience.hedge.suppressed.budget`` otherwise);
- all attempts failing raises the LAST error unchanged; a deadline
  expiring with no resolution raises ``TimeoutError``.

Properties: ``geomesa.hedge.enabled`` (default true; an operator's
switch that callers read before hedging, not a choice of
implementation) and ``geomesa.hedge.min.delay.ms`` (default 10): the
floor keeps a microsecond-fast endpoint from hedging every call on EWMA
noise.

Metrics: ``resilience.hedge.attempts`` / ``.wins`` / ``.losses`` /
``.cancelled`` / ``.suppressed.budget`` (plus per-name variants of
attempts/wins for the serving tier's dashboards).
"""

from __future__ import annotations

import contextvars
import threading
import time

from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

__all__ = ["HedgePolicy", "HEDGE_ENABLED", "HEDGE_MIN_DELAY_MS"]

HEDGE_ENABLED = SystemProperty("geomesa.hedge.enabled", "true")
HEDGE_MIN_DELAY_MS = SystemProperty("geomesa.hedge.min.delay.ms", "10")


class HedgePolicy:
    """Run a callable with one speculative backup attempt.

    ``budget`` is the shared RetryBudget hedges are charged to (None =
    unmetered). ``clock``/``wait`` are injectable for deterministic
    timing tests: ``wait(cond, timeout)`` parks the caller on the
    condition for up to ``timeout`` seconds (default: real
    ``cond.wait``)."""

    def __init__(self, budget=None, min_delay_s: float | None = None,
                 registry=metrics, clock=time.monotonic, wait=None):
        self.budget = budget
        self._min_delay_override = min_delay_s
        self._registry = registry
        self._clock = clock
        self._wait = wait if wait is not None \
            else (lambda cond, timeout: cond.wait(timeout))

    # -- knobs -------------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        """Process-wide kill switch, re-read per call so operators can
        flip hedging on a live tier."""
        return str(HEDGE_ENABLED.get()).lower() in ("true", "1", "yes")

    def min_delay_s(self) -> float:
        if self._min_delay_override is not None:
            return float(self._min_delay_override)
        return (HEDGE_MIN_DELAY_MS.as_float() or 10.0) / 1e3

    def delay_s(self, p99_s: float | None) -> float | None:
        """The speculative-send delay for an endpoint whose p99-ish
        latency estimate is ``p99_s``: the estimate floored at the
        min-delay knob. None (no estimate yet) means don't hedge —
        guessing a delay with no signal just doubles load."""
        if p99_s is None:
            return None
        return max(float(p99_s), self.min_delay_s())

    # -- the hedged call ---------------------------------------------------

    def call(self, fn, delay_s: float, *, deadline_s: float | None = None,
             name: str = "", on_hedge=None):
        """Invoke ``fn()`` with one backup attempt after ``delay_s`` of
        silence (or immediately if the first attempt fails). Returns
        the first success; raises the last error when every attempt
        fails, or ``TimeoutError`` when ``deadline_s`` elapses with no
        resolution. ``on_hedge()`` fires when the backup launches (the
        cluster tier counts its own leg hedges through it)."""
        cond = threading.Condition()
        # winner holds (attempt_index, value) so win/loss attribution
        # survives the race; resolved stops late losers from delivering
        state = {"winner": None, "errs": [], "running": 0,
                 "resolved": False}
        key = sanitize_key(name) if name else ""
        # with QoS on, hedges are charged to the caller's TENANT budget
        # (tenants plane): tenant A burning its retries cannot suppress
        # tenant B's hedging
        from ..tenants import active_tenant, tenant_budget, tenant_label
        budget = tenant_budget() or self.budget
        tenant = active_tenant()

        def attempt(idx: int):
            try:
                v = fn()
            except Exception as e:  # noqa: BLE001 — attempt boundary
                with cond:
                    state["errs"].append(e)
                    state["running"] -= 1
                    cond.notify_all()
                return
            with cond:
                if state["winner"] is None and not state["resolved"]:
                    state["winner"] = (idx, v)
                else:
                    # the race was already decided: this result is
                    # discarded, never delivered twice
                    self._registry.counter("resilience.hedge.cancelled")
                state["running"] -= 1
                cond.notify_all()

        def launch(idx: int):
            # each attempt runs under a copy of the caller's context so
            # trace spans parent into the live trace (and the audit
            # hook's delegation scope reaches hedged attempts too);
            # copies are independent, so concurrent attempts never
            # re-enter one Context
            state["running"] += 1
            ctx = contextvars.copy_context()
            threading.Thread(target=ctx.run, args=(attempt, idx),
                             daemon=True,
                             name=f"hedge-{name or 'call'}-{idx}").start()

        t0 = self._clock()
        hedge_at = t0 + max(float(delay_s), 0.0)
        deadline_t = None if deadline_s is None else t0 + float(deadline_s)
        hedged, can_hedge = False, True
        with cond:
            launch(0)
            while state["winner"] is None:
                now = self._clock()
                if deadline_t is not None and now >= deadline_t:
                    state["resolved"] = True
                    raise TimeoutError(
                        f"hedged call {name or fn!r} exceeded its "
                        f"{deadline_s:g}s deadline")
                if state["running"] == 0 and (hedged or not can_hedge):
                    # every attempt has failed and no backup can launch
                    state["resolved"] = True
                    raise state["errs"][-1]
                if not hedged and can_hedge \
                        and (state["running"] == 0 or now >= hedge_at):
                    if budget is not None \
                            and not budget.try_withdraw():
                        self._registry.counter(
                            "resilience.hedge.suppressed.budget")
                        if tenant is not None:
                            self._registry.counter(
                                "qos.hedge.suppressed",
                                labels={"tenant": tenant_label(tenant)})
                        can_hedge = False
                        continue
                    hedged = True
                    self._registry.counter("resilience.hedge.attempts")
                    if key:
                        self._registry.counter(
                            f"resilience.hedge.attempts.{key}")
                    from ..obs import annotate, set_flag
                    annotate("hedge.launched", name=name,
                             delay_ms=round((now - t0) * 1000, 3))
                    set_flag("hedged")
                    if on_hedge is not None:
                        on_hedge()
                    launch(1)
                    continue
                timeout = None
                if not hedged and can_hedge:
                    timeout = hedge_at - now
                if deadline_t is not None:
                    remaining = deadline_t - now
                    timeout = (remaining if timeout is None
                               else min(timeout, remaining))
                self._wait(cond, max(timeout, 0.0005)
                           if timeout is not None else None)
            idx, value = state["winner"]
            state["resolved"] = True
        if hedged:
            # the loser is still on the wire; its socket finishes (or
            # times out) in the background and its result is discarded
            # on arrival (counted ``resilience.hedge.cancelled`` by the
            # attempt closure) — the closest an HTTP client gets to
            # true cancellation
            won = idx == 1
            self._registry.counter("resilience.hedge.wins" if won
                                   else "resilience.hedge.losses")
            if key and won:
                self._registry.counter(f"resilience.hedge.wins.{key}")
        return value
