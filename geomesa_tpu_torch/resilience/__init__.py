"""Network resilience: the retry policy with backoff, jitter, deadline
and a shared retry budget (``policy.py``), which the socket bus's client
rides on (``store/socketbus.py``); per-endpoint circuit breakers with the
consecutive-failure and sliding error-rate trip conditions and a latency
EWMA per endpoint (``breaker.py``); p99-delayed speculative hedging of
idempotent reads, charged to the tenant's or the shared retry budget
(``hedge.py``); and a seeded fault-injecting TCP proxy that proves
recovery end to end (``chaos.py``). Each emits ``resilience.*``
metrics."""

from .breaker import (BREAKER_ERROR_RATE, BREAKER_FAILURES,
                      BREAKER_MIN_VOLUME, BREAKER_RESET_MS, BREAKER_WINDOW,
                      BreakerBoard, CircuitBreaker, CircuitOpenError)
from .chaos import ChaosProxy
from .hedge import HEDGE_ENABLED, HEDGE_MIN_DELAY_MS, HedgePolicy
from .policy import (RETRY_ATTEMPTS, RETRY_BASE_MS, RETRY_BUDGET_SCALE,
                     RETRY_CAP_MS, RETRY_DEADLINE, RetryBudget, RetryPolicy,
                     default_retryable)

__all__ = ["RetryPolicy", "RetryBudget", "default_retryable",
           "CircuitBreaker", "CircuitOpenError", "BreakerBoard",
           "ChaosProxy", "HedgePolicy",
           "RETRY_ATTEMPTS", "RETRY_BASE_MS", "RETRY_CAP_MS",
           "RETRY_DEADLINE", "RETRY_BUDGET_SCALE",
           "BREAKER_FAILURES", "BREAKER_RESET_MS", "BREAKER_WINDOW",
           "BREAKER_ERROR_RATE", "BREAKER_MIN_VOLUME",
           "HEDGE_ENABLED", "HEDGE_MIN_DELAY_MS"]
