"""Lightweight metrics registry (MetricsConfig analog,
metrics/config/MetricsConfig.scala:26): counters/gauges with optional
labels, timers backed by fixed-log-bucket histograms (p50/p95/p99 and
sparse cumulative buckets in ``snapshot()``), a per-family cardinality
guard on labeled series, a delimited-file reporter hook, and the
Prometheus text exposition (format 0.0.4) that a scrape endpoint
serves."""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left

from ..utils.properties import SystemProperty

__all__ = ["MetricsRegistry", "metrics", "sanitize_key",
           "labeled_key", "split_key", "prometheus_text",
           "METRICS_MAX_SERIES"]

# per-family labeled-series ceiling: a hostile or runaway label value
# stream (type names, principals) must not grow the registry without
# bound — past the cap new label combinations collapse into one
# all-``other`` series and ``metrics.series.dropped`` counts the loss
METRICS_MAX_SERIES = SystemProperty("geomesa.metrics.max.series", "256")

# metric-key material derived from user-controlled strings (type names,
# endpoint routes) must not corrupt the registry dump: no whitespace or
# control characters, bounded length
_KEY_BAD = re.compile(r"[^0-9A-Za-z._:/-]+")
_KEY_MAX = 64


def sanitize_key(raw: str) -> str:
    """Make untrusted text safe as a metric-key segment: collapse
    anything outside [0-9A-Za-z._:/-] (spaces, newlines, quotes, ...)
    to ``_`` and cap the length, so a hostile type name or endpoint
    string cannot break the ``/rest/metrics`` registry dump or smuggle
    newlines into delimited reports."""
    s = _KEY_BAD.sub("_", str(raw))
    if len(s) > _KEY_MAX:
        s = s[:_KEY_MAX]
    return s or "_"


def _esc_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def labeled_key(name: str, labels: dict | None) -> str:
    """Registry key for a labeled metric: ``name{k="v",...}`` with
    sorted keys, Prometheus-style escaping. Label *names* are
    sanitized like key segments; values only escaped (they end up
    inside quotes)."""
    if not labels:
        return name
    inner = ",".join(f'{sanitize_key(k)}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


_LABELED = re.compile(r"^([^{]+)\{(.*)\}$")


def split_key(key: str) -> tuple[str, str]:
    """Inverse of labeled_key at the exposition layer: returns
    (base name, label body or '')."""
    m = _LABELED.match(key)
    return (m.group(1), m.group(2)) if m else (key, "")


# Fixed log-spaced histogram bounds: sqrt(2) steps from 1µs to ~46000s
# (64 buckets + overflow). Quantiles interpolate inside the matched
# bucket, so the relative error is bounded by the step (~±20%) at a
# fixed 65-slot cost per timer — cheap enough to leave on everywhere.
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

    def cumulative(self) -> list:
        """Sparse cumulative bucket pairs ``[upper_bound_s, count<=bound]``
        for occupied buckets only, terminated by ``[None, total]`` (the
        ``+Inf`` bucket) — the shape Prometheus ``_bucket`` lines need."""
        out, running = [], 0
        for i, c in enumerate(self.buckets[:-1]):
            if c == 0:
                continue
            running += c
            out.append([round(_BOUNDS[i], 9), running])
        out.append([None, self.count])
        return out


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._timers: dict[str, _Timer] = {}
        self._gauges: dict[str, float] = {}
        # family name -> label bodies seen, for the cardinality guard
        self._series: dict[str, set[str]] = {}

    def _series_key(self, name: str, labels: dict | None) -> str:
        """Registry key with the per-family cardinality guard applied
        (caller holds ``self._lock``): past ``geomesa.metrics.max.series``
        distinct label bodies, a NEW combination collapses into the
        family's all-``other`` series (admitted once, so the family
        tops out at cap+1) and ``metrics.series.dropped`` counts it."""
        if not labels:
            return name
        key = labeled_key(name, labels)
        body = key[len(name) + 1:-1]
        seen = self._series.setdefault(name, set())
        if body in seen:
            return key
        try:
            cap = int(METRICS_MAX_SERIES.get() or 256)
        except (TypeError, ValueError):
            cap = 256
        if len(seen) < cap:
            seen.add(body)
            return key
        self._counters["metrics.series.dropped"] = \
            self._counters.get("metrics.series.dropped", 0) + 1
        over = labeled_key(name, {k: "other" for k in labels})
        seen.add(over[len(name) + 1:-1])
        return over

    def counter(self, name: str, inc: int = 1,
                labels: dict | None = None):
        with self._lock:
            key = self._series_key(name, labels)
            self._counters[key] = self._counters.get(key, 0) + inc

    def gauge(self, name: str, value: float,
              labels: dict | None = None):
        with self._lock:
            self._gauges[self._series_key(name, labels)] = value

    def observe(self, name: str, seconds: float,
                labels: dict | None = None):
        """Record one duration directly (for callers that measured it
        themselves)."""
        with self._lock:
            key = self._series_key(name, labels)
            self._timers.setdefault(key, _Timer()).update(seconds)

    def time(self, name: str, labels: dict | None = None):
        reg = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                with reg._lock:
                    key = reg._series_key(name, labels)
                    reg._timers.setdefault(key, _Timer()).update(dt)

        return _Ctx()

    def snapshot(self) -> dict:
        """JSON-safe snapshot. Non-finite gauge values (an EWMA can
        divide to inf/nan before warm-up) map to None — json.dumps
        would otherwise emit bare ``Infinity``/``NaN``, which is not
        JSON and breaks ``/rest/metrics`` consumers."""
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
                               "p99_ms": round(t.quantile_s(0.99) * 1000, 3),
                               # sparse cumulative histogram: [le_s, n]
                               # pairs for occupied buckets, None = +Inf
                               "buckets": t.cumulative()}
                           for k, t in self._timers.items()},
            }

    def report_delimited(self, path: str, delimiter: str = "\t"):
        """Append a snapshot via DelimitedFileReporter (single row
        format owner; see reporters.py)."""
        from .reporters import DelimitedFileReporter
        DelimitedFileReporter(path, delimiter).report(self.snapshot())

    def prometheus_text(self) -> str:
        return prometheus_text(self.snapshot())


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_BAD.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] in "_:"):
        n = "_" + n
    return "geomesa_" + n


def _prom_line(name: str, label_body: str, extra: str, value) -> str:
    body = ",".join(x for x in (label_body, extra) if x)
    return (f"{name}{{{body}}} {value!r}" if body
            else f"{name} {value!r}")


def prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition (format version 0.0.4) of a
    snapshot: counters as ``_total`` counters, gauges as gauges
    (non-finite samples dropped), timers as summaries with
    p50/p95/p99 quantiles. Labeled registry keys split back into
    name + label body; ``# TYPE`` emitted once per metric family."""
    families: dict[str, tuple[str, list[str]]] = {}

    def fam(prom: str, mtype: str) -> list[str]:
        if prom not in families:
            families[prom] = (mtype, [])
        return families[prom][1]

    for key, v in sorted(snapshot.get("counters", {}).items()):
        base, lbl = split_key(key)
        prom = _prom_name(base) + "_total"
        fam(prom, "counter").append(_prom_line(prom, lbl, "", float(v)))
    for key, v in sorted(snapshot.get("gauges", {}).items()):
        if v is None or not math.isfinite(float(v)):
            continue
        base, lbl = split_key(key)
        prom = _prom_name(base)
        fam(prom, "gauge").append(_prom_line(prom, lbl, "", float(v)))
    for key, t in sorted(snapshot.get("timers", {}).items()):
        base, lbl = split_key(key)
        prom = _prom_name(base) + "_seconds"
        lines = fam(prom, "summary")
        for q, field in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                         ("0.99", "p99_ms")):
            val = t.get(field)
            if val is None:
                continue
            lines.append(_prom_line(prom, lbl, f'quantile="{q}"',
                                    float(val) / 1000.0))
        cnt = fam(prom + "_count", "")
        cnt.append(_prom_line(prom + "_count", lbl, "",
                              float(t.get("count", 0))))
        mean = t.get("mean_ms")
        if mean is not None:
            s = fam(prom + "_sum", "")
            s.append(_prom_line(
                prom + "_sum", lbl, "",
                float(mean) / 1000.0 * float(t.get("count", 0))))
        # native histogram family alongside the summary (Grafana
        # heatmaps need cumulative ``le`` buckets, which a summary
        # cannot express). A distinct ``_hist`` family name keeps the
        # 0.0.4 one-``# TYPE``-per-family rule intact.
        bks = t.get("buckets")
        if bks:
            hprom = _prom_name(base) + "_seconds_hist"
            hl = fam(hprom, "histogram")
            for le, cum in bks:
                le_txt = "+Inf" if le is None else f"{float(le):g}"
                hl.append(_prom_line(hprom + "_bucket", lbl,
                                     f'le="{le_txt}"', float(cum)))
            hl.append(_prom_line(hprom + "_count", lbl, "",
                                 float(t.get("count", 0))))
            if mean is not None:
                hl.append(_prom_line(
                    hprom + "_sum", lbl, "",
                    float(mean) / 1000.0 * float(t.get("count", 0))))

    out: list[str] = []
    for prom, (mtype, lines) in families.items():
        if mtype:
            out.append(f"# TYPE {prom} {mtype}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")


metrics = MetricsRegistry()
