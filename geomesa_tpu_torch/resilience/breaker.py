"""Per-endpoint circuit breaker: closed / open / half-open.

Against a down server, every call otherwise burns its full socket
timeout before failing — with a 60s client timeout, ten queued queries
are ten minutes of hang. The breaker watches transport failures per
endpoint; past the trip condition it OPENS and calls fail in
microseconds (``CircuitOpenError``) until a reset timeout elapses, then
HALF-OPEN lets a bounded number of probe calls through — one success
re-closes, a failure re-opens. The same state machine HBase clients
get from their RPC stack's fast-fail mode (SURVEY.md 2.6).

Two trip conditions:

- legacy (default): ``geomesa.breaker.failures`` CONSECUTIVE failures.
  Simple, but one threshold can't fit both a 10 qps and a 10k qps
  endpoint — at high qps interleaved successes keep resetting it while
  the endpoint drops half its traffic.
- sliding error-rate window (``geomesa.breaker.window`` = N recent
  calls): trip when failures / recent calls >= ``geomesa.breaker.
  error.rate`` AND at least ``geomesa.breaker.min.volume`` calls are
  in the window (a cold endpoint's first failure is not a 100% error
  rate worth tripping on). Rate-based tripping reacts in O(window)
  calls regardless of qps and doesn't flap on isolated failures.

``BreakerBoard`` additionally keeps a per-endpoint latency EWMA
(mean + deviation, so a p99-ish upper estimate falls out) fed by the
callers that time their attempts: the signal hedged requests need to
pick their speculative delay. Exposed as ``resilience.latency.*``
gauges and by ``latencies()``.

State transitions and fast-fails count into the metrics registry
(``resilience.breaker.opened`` / ``.half_open`` / ``.closed`` /
``.fast_fail``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

__all__ = ["CircuitBreaker", "CircuitOpenError", "BreakerBoard",
           "BREAKER_FAILURES", "BREAKER_RESET_MS", "BREAKER_WINDOW",
           "BREAKER_ERROR_RATE", "BREAKER_MIN_VOLUME"]

BREAKER_FAILURES = SystemProperty("geomesa.breaker.failures", "5")
BREAKER_RESET_MS = SystemProperty("geomesa.breaker.reset.ms", "5000")
# sliding-window trip condition (opt-in): window size in calls; unset
# keeps the legacy consecutive-failures behavior
BREAKER_WINDOW = SystemProperty("geomesa.breaker.window", None)
BREAKER_ERROR_RATE = SystemProperty("geomesa.breaker.error.rate", "0.5")
BREAKER_MIN_VOLUME = SystemProperty("geomesa.breaker.min.volume", "10")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(ConnectionError):
    """Fast-fail: the endpoint's breaker is open. NOT retryable — the
    point is to shed load off a known-dead endpoint immediately;
    ``retry_after_s`` says when the next half-open probe is due."""

    retryable = False

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit open for {name!r} (retry in {retry_after_s:.2f}s)")
        self.endpoint = name
        self.retry_after_s = max(retry_after_s, 0.0)


class CircuitBreaker:
    """One endpoint's health gate. Callers bracket each attempt:

        breaker.acquire()          # raises CircuitOpenError when open
        ...transport attempt...
        breaker.success() / breaker.failure()

    Only TRANSPORT-level failures should be recorded as failures; an
    application error in a well-formed response (404, 400) proves the
    endpoint alive and should record success."""

    def __init__(self, name: str = "", failure_threshold: int | None = None,
                 reset_timeout_s: float | None = None,
                 half_open_max: int = 1, clock=time.monotonic,
                 registry=metrics, window: int | None = None,
                 error_rate: float | None = None,
                 min_volume: int | None = None):
        self.name = name
        self.failure_threshold = (BREAKER_FAILURES.as_int()
                                  if failure_threshold is None
                                  else int(failure_threshold))
        self.reset_timeout_s = (
            (BREAKER_RESET_MS.as_float() or 5000.0) / 1e3
            if reset_timeout_s is None else float(reset_timeout_s))
        self.half_open_max = int(half_open_max)
        # sliding error-rate window: explicit arg wins, then the knob;
        # unset (None/0) falls back to consecutive-failure counting
        self.window = (BREAKER_WINDOW.as_int() if window is None
                       else int(window)) or None
        self.error_rate = (BREAKER_ERROR_RATE.as_float() or 0.5
                           if error_rate is None else float(error_rate))
        self.min_volume = (BREAKER_MIN_VOLUME.as_int() or 10
                           if min_volume is None else int(min_volume))
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._outcomes: deque[bool] = deque(maxlen=self.window or 1)
        self._opened_at = 0.0
        self._probes_inflight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def acquire(self):
        with self._lock:
            if self._state == CLOSED:
                return
            now = self._clock()
            due = self._opened_at + self.reset_timeout_s
            if self._state == OPEN:
                if now < due:
                    self._registry.counter("resilience.breaker.fast_fail")
                    raise CircuitOpenError(self.name, due - now)
                self._transition(HALF_OPEN)
            # half-open: a bounded probe quota feels the endpoint out
            if self._probes_inflight >= self.half_open_max:
                self._registry.counter("resilience.breaker.fast_fail")
                raise CircuitOpenError(self.name, self.reset_timeout_s)
            self._probes_inflight += 1

    def success(self):
        with self._lock:
            self._consecutive_failures = 0
            if self.window:
                self._outcomes.append(False)
            if self._state != CLOSED:
                self._probes_inflight = max(self._probes_inflight - 1, 0)
                self._transition(CLOSED)

    def failure(self):
        with self._lock:
            self._consecutive_failures += 1
            if self.window:
                self._outcomes.append(True)
            if self._state == HALF_OPEN:
                self._probes_inflight = max(self._probes_inflight - 1, 0)
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == CLOSED and self._should_trip():
                self._opened_at = self._clock()
                self._transition(OPEN)

    def _should_trip(self) -> bool:
        # lock held. Window mode: failures / recent calls crosses the
        # rate threshold with enough volume to mean something; legacy
        # mode: a consecutive-failure run.
        if self.window:
            n = len(self._outcomes)
            if n < self.min_volume:
                return False
            return sum(self._outcomes) / n >= self.error_rate
        return self._consecutive_failures >= self.failure_threshold

    def _transition(self, state: str):
        # lock held
        if state != self._state:
            self._state = state
            if state == HALF_OPEN:
                self._probes_inflight = 0
            elif state == OPEN:
                # a re-closed breaker starts with a clean slate: the
                # window's stale failures must not instantly re-trip it
                self._outcomes.clear()
            self._registry.counter(
                f"resilience.breaker.{'opened' if state == OPEN else state}")


class _LatencyEwma:
    """EWMA of call latency mean + mean absolute deviation. The p99-ish
    estimate is mean + 3·deviation — crude but monotone in tail weight,
    cheap to keep per endpoint, and exactly the signal a hedged request
    needs to pick its speculative-send delay."""

    __slots__ = ("alpha", "mean_s", "dev_s", "count")

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.mean_s = 0.0
        self.dev_s = 0.0
        self.count = 0

    def update(self, seconds: float):
        if self.count == 0:
            self.mean_s = seconds
        else:
            err = abs(seconds - self.mean_s)
            self.dev_s += self.alpha * (err - self.dev_s)
            self.mean_s += self.alpha * (seconds - self.mean_s)
        self.count += 1

    @property
    def p99_s(self) -> float:
        return self.mean_s + 3.0 * self.dev_s

    def to_json_object(self) -> dict:
        return {"mean_ms": round(self.mean_s * 1e3, 3),
                "p99_ms": round(self.p99_s * 1e3, 3),
                "count": self.count}


class BreakerBoard:
    """Lazily-built breaker per endpoint key (e.g. a route segment), so
    one dead route fails fast without tripping the rest. Also the
    per-endpoint latency ledger: callers feed ``observe`` with each
    successful attempt's wall time, and ``latencies`` serves the EWMA
    mean / p99-ish estimates (also the ``resilience.latency.p99.<key>``
    gauges)."""

    def __init__(self, registry=metrics, **breaker_kwargs):
        self._kw = breaker_kwargs
        self._registry = registry
        self._breakers: dict[str, CircuitBreaker] = {}
        self._latency: dict[str, _LatencyEwma] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(
                    name=key, registry=self._registry, **self._kw)
            return b

    def states(self) -> dict[str, str]:
        with self._lock:
            return {k: b.state for k, b in self._breakers.items()}

    # -- latency ledger ----------------------------------------------------

    def observe(self, key: str, seconds: float):
        """Record one successful call's latency for ``key``. The gauge
        key is sanitized — ``key`` is often derived from request paths
        or type names, and a hostile one (newlines, spaces, unbounded
        length) must not corrupt the registry's exposition or a
        delimited report row."""
        with self._lock:
            e = self._latency.get(key)
            if e is None:
                e = self._latency[key] = _LatencyEwma()
            e.update(seconds)
            p99_ms = e.p99_s * 1e3
        self._registry.gauge(
            f"resilience.latency.p99.{sanitize_key(key)}", p99_ms)

    def latency_p99_s(self, key: str) -> float | None:
        """Current p99-ish estimate for ``key`` (None before any
        observation) — the hedged-request delay input."""
        with self._lock:
            e = self._latency.get(key)
            return e.p99_s if e is not None and e.count else None

    def latencies(self) -> dict[str, dict]:
        with self._lock:
            return {k: e.to_json_object()
                    for k, e in self._latency.items()}
