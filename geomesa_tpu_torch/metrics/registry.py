"""Lightweight metrics registry (MetricsConfig analog,
metrics/config/MetricsConfig.scala:26): counters and gauges with
optional labels, and timers backed by fixed-log-bucket histograms
(p50/p95/p99 in ``snapshot()``). The serving path's batcher records into
the module-level ``metrics``."""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left

__all__ = ["MetricsRegistry", "metrics", "sanitize_key", "labeled_key"]

# metric-key material derived from user-controlled strings (type names)
# must not corrupt a registry dump: no whitespace or control characters,
# bounded length
_KEY_BAD = re.compile(r"[^0-9A-Za-z._:/-]+")
_KEY_MAX = 64


def sanitize_key(raw: str) -> str:
    """Make untrusted text safe as a metric-key segment: collapse
    anything outside [0-9A-Za-z._:/-] to ``_`` and cap the length."""
    s = _KEY_BAD.sub("_", str(raw))
    if len(s) > _KEY_MAX:
        s = s[:_KEY_MAX]
    return s or "_"


def _esc_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def labeled_key(name: str, labels: dict | None) -> str:
    """Registry key for a labeled metric: ``name{k="v",...}`` with
    sorted keys, Prometheus-style escaping. Label names are sanitized
    like key segments; values only escaped (they sit inside quotes)."""
    if not labels:
        return name
    inner = ",".join(f'{sanitize_key(k)}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


# Fixed log-spaced histogram bounds: sqrt(2) steps from 1us to ~46000 s
# (64 buckets + overflow). Quantiles interpolate inside the matched
# bucket, so the relative error is bounded by the step (~±20%) at a
# fixed 65-slot cost per timer.
_BOUNDS = tuple(1e-6 * 2 ** (i / 2) for i in range(64))


class _Timer:
    """Timer = count/sum/max + a fixed-log-bucket histogram."""

    __slots__ = ("count", "total_s", "max_s", "buckets")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.buckets = [0] * (len(_BOUNDS) + 1)

    def update(self, seconds: float):
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)
        self.buckets[bisect_left(_BOUNDS, seconds)] += 1

    @property
    def mean_ms(self) -> float:
        return (self.total_s / self.count * 1000) if self.count else 0.0

    def quantile_s(self, q: float) -> float:
        """Histogram quantile estimate in seconds: find the bucket the
        rank lands in, interpolate linearly within it."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = _BOUNDS[i - 1] if i > 0 else 0.0
                hi = _BOUNDS[i] if i < len(_BOUNDS) else self.max_s
                hi = min(max(hi, lo), self.max_s) if self.max_s else hi
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.max_s


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._timers: dict[str, _Timer] = {}
        self._gauges: dict[str, float] = {}

    def counter(self, name: str, inc: int = 1,
                labels: dict | None = None):
        key = labeled_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + inc

    def gauge(self, name: str, value: float,
              labels: dict | None = None):
        key = labeled_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, seconds: float,
                labels: dict | None = None):
        """Record one duration directly (for callers that measured it
        themselves)."""
        key = labeled_key(name, labels)
        with self._lock:
            self._timers.setdefault(key, _Timer()).update(seconds)

    def time(self, name: str, labels: dict | None = None):
        reg = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                reg.observe(name, time.perf_counter() - self.t0, labels)

        return _Ctx()

    def snapshot(self) -> dict:
        """JSON-safe snapshot; non-finite gauge values map to None."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: (v if isinstance(v, (int, float))
                               and math.isfinite(v) else None)
                           for k, v in self._gauges.items()},
                "timers": {k: {"count": t.count,
                               "mean_ms": round(t.mean_ms, 3),
                               "max_ms": round(t.max_s * 1000, 3),
                               "p50_ms": round(t.quantile_s(0.50) * 1000, 3),
                               "p95_ms": round(t.quantile_s(0.95) * 1000, 3),
                               "p99_ms": round(t.quantile_s(0.99) * 1000, 3)}
                           for k, t in self._timers.items()},
            }


metrics = MetricsRegistry()
