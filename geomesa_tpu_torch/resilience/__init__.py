"""Network resilience: the retry policy (backoff, jitter, deadline and a
shared retry budget) that the socket bus's client rides on
(``store/socketbus.py``). The circuit breakers, hedging and the chaos
proxy of the JAX package's ``resilience/`` are queue 1 item 7b of
ROADMAP.md section 6."""

from .policy import (RETRY_ATTEMPTS, RETRY_BASE_MS, RETRY_BUDGET_SCALE,
                     RETRY_CAP_MS, RETRY_DEADLINE, RetryBudget, RetryPolicy,
                     default_retryable)

__all__ = ["RetryPolicy", "RetryBudget", "default_retryable",
           "RETRY_ATTEMPTS", "RETRY_BASE_MS", "RETRY_CAP_MS",
           "RETRY_DEADLINE", "RETRY_BUDGET_SCALE"]
