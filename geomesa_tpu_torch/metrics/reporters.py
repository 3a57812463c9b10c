"""Metric reporters (geomesa-metrics reporters analog:
DelimitedFileReporter, graphite/ganglia from MetricsConfig.scala:26).
Reporters format a registry snapshot; PeriodicReporter drives any of
them on an interval thread."""

from __future__ import annotations

import json
import threading
import time
from typing import Callable

__all__ = ["DelimitedFileReporter", "GraphiteLineReporter",
           "JsonLineReporter", "PeriodicReporter"]


def _flatten(snapshot: dict) -> list[tuple[str, float]]:
    out: list[tuple[str, float]] = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        out.append((f"counters.{name}", float(v)))
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        # snapshot() maps non-finite gauges to None; a delimited report
        # has no null, so those samples are simply dropped
        if v is None:
            continue
        out.append((f"gauges.{name}", float(v)))
    for name, t in sorted(snapshot.get("timers", {}).items()):
        for field, val in t.items():
            # histogram bucket lists are structured, not scalar — they
            # belong to the Prometheus exposition, not delimited rows
            if val is None or not isinstance(val, (int, float)):
                continue
            out.append((f"timers.{name}.{field}", float(val)))
    return out


class DelimitedFileReporter:
    """Append TSV/CSV rows: timestamp, metric, value."""

    def __init__(self, path: str, delimiter: str = "\t"):
        self.path = path
        self.delimiter = delimiter

    def report(self, snapshot: dict):
        ts = int(time.time() * 1000)
        with open(self.path, "a") as fh:
            for name, value in _flatten(snapshot):
                fh.write(self.delimiter.join(
                    (str(ts), name, repr(value))) + "\n")


class GraphiteLineReporter:
    """Graphite plaintext protocol lines ('<path> <value> <epoch>')
    handed to a sink callable — a socket send, a file append, a test
    list. Prefix mirrors the reporter config's metric prefix."""

    def __init__(self, sink: Callable[[str], None], prefix: str = "geomesa"):
        self.sink = sink
        self.prefix = prefix

    def report(self, snapshot: dict):
        epoch = int(time.time())
        for name, value in _flatten(snapshot):
            self.sink(f"{self.prefix}.{name} {value} {epoch}")


class JsonLineReporter:
    """One JSON object per report (log aggregation friendly)."""

    def __init__(self, path: str):
        self.path = path

    def report(self, snapshot: dict):
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"ts": int(time.time() * 1000),
                                 **snapshot}, sort_keys=True) + "\n")


class PeriodicReporter:
    def __init__(self, registry, reporter, interval_s: float = 60.0):
        self.registry = registry
        self.reporter = reporter
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "PeriodicReporter":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.reporter.report(self.registry.snapshot())

    def stop(self, final_report: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()  # let an in-flight report finish first
            self._thread = None
        if final_report:
            self.reporter.report(self.registry.snapshot())
