"""Metrics registry of the port (counters, gauges, histogram timers)."""

from .registry import MetricsRegistry, labeled_key, metrics, sanitize_key

__all__ = ["MetricsRegistry", "labeled_key", "metrics", "sanitize_key"]
