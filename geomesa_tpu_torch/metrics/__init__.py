"""Metrics registry of the port (counters, gauges, histogram timers,
the Prometheus exposition) and its reporters."""

from .registry import (MetricsRegistry, labeled_key, metrics,
                       prometheus_text, sanitize_key, split_key)

__all__ = ["MetricsRegistry", "labeled_key", "metrics", "prometheus_text",
           "sanitize_key", "split_key"]
