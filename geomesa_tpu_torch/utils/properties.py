"""System properties: layered config flags.

Analog of GeoMesaSystemProperties.SystemProperty (geomesa-utils/.../conf/
GeoMesaSystemProperties.scala:17-60): a named flag resolved, in order,
from (1) a thread-local override, (2) the process environment (dots
become underscores, uppercased), (3) a process-wide override map, (4) the
declared default. Typed accessors mirror the reference
(`.toInt/.toBoolean` -> as_int/as_bool)."""

from __future__ import annotations

import os
import re
import threading

__all__ = ["SystemProperty", "HOST_RANGES_TARGET", "QUERY_TIMEOUT",
           "WAL_FSYNC", "WAL_SEGMENT_BYTES", "WAL_INTERVAL_MS",
           "INTEGRITY_QUARANTINE", "SQL_PLANNER", "PLANNER_RECALIBRATE",
           "SQL_DISTRIBUTED", "SQL_BROADCAST_ROWS",
           "INGEST_SHED_QUEUE_DEPTH"]

_overrides: dict[str, str] = {}
_tls = threading.local()


class SystemProperty:
    def __init__(self, name: str, default: str | None = None):
        self.name = name
        self.default = default

    def get(self) -> str | None:
        tl = getattr(_tls, "values", {})
        if self.name in tl:
            return tl[self.name]
        env = self.name.replace(".", "_").upper()
        if env in os.environ:
            return os.environ[env]
        if self.name in _overrides:
            return _overrides[self.name]
        return self.default

    def set(self, value: str | None):
        """Process-wide override (None clears)."""
        if value is None:
            _overrides.pop(self.name, None)
        else:
            _overrides[self.name] = str(value)

    def get_override(self) -> str | None:
        """The process-wide override layer only (None = unset), ignoring
        the environment and the default: lets a caller (the SLO reaction
        loop) save the exact override state it found and later restore
        it with ``set``."""
        return _overrides.get(self.name)

    def thread_local_set(self, value: str | None):
        """Override for the calling thread only (None clears); it wins
        over the environment and the process-wide override."""
        tl = getattr(_tls, "values", None)
        if tl is None:
            tl = _tls.values = {}
        if value is None:
            tl.pop(self.name, None)
        else:
            tl[self.name] = str(value)

    # -- typed accessors ---------------------------------------------------

    def as_int(self) -> int | None:
        v = self.get()
        return None if v is None else int(v)

    def as_float(self) -> float | None:
        v = self.get()
        return None if v is None else float(v)

    def as_bool(self) -> bool | None:
        v = self.get()
        return None if v is None else v.strip().lower() in ("true", "1", "yes")

    def as_seconds(self) -> float | None:
        """Duration strings: '10s', '5 minutes', '100ms', bare seconds."""
        v = self.get()
        if v is None:
            return None
        m = re.match(r"^\s*([\d.]+)\s*([a-zA-Z]*)\s*$", v)
        if not m:
            raise ValueError(f"bad duration {v!r}")
        n = float(m.group(1))
        unit = m.group(2).lower()
        mult = {"": 1.0, "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
                "ms": 1e-3, "millis": 1e-3, "milliseconds": 1e-3,
                "m": 60.0, "min": 60.0, "minute": 60.0, "minutes": 60.0,
                "h": 3600.0, "hour": 3600.0, "hours": 3600.0}.get(unit)
        if mult is None:
            raise ValueError(f"bad duration unit {unit!r}")
        return n * mult


# coarser range target for the host index tiers, which re-check every
# candidate exactly: deep decompositions are a per-query cost that a
# selective query stream never earns back
HOST_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.host", "256")

# a query's deadline in seconds (or a duration string), checked at the
# store's stage boundaries; the TIMEOUT hint overrides it per query
QUERY_TIMEOUT = SystemProperty("geomesa.query.timeout", None)

# the write-ahead log (wal/log.py): its fsync policy ("always",
# "interval" or "never"), its segment rotation threshold in bytes, and
# the flush cadence of the "interval" policy
WAL_FSYNC = SystemProperty("geomesa.wal.fsync", "always")
WAL_SEGMENT_BYTES = SystemProperty("geomesa.wal.segment.bytes",
                                   str(64 * 1024 * 1024))
WAL_INTERVAL_MS = SystemProperty("geomesa.wal.interval.ms", "50")

# rename a checkpoint that fails verification at load to *.corrupt
INTEGRITY_QUARANTINE = SystemProperty("geomesa.integrity.quarantine", "true")

# the SQL planner (sql/planner.py): "false" restores the exact-count
# static-threshold strategy choice and keeps joins in statement order;
# the recalibration of the per-leg cost coefficient from a cluster's
# observed leg latencies ("false" pins the static default)
SQL_PLANNER = SystemProperty("geomesa.sql.planner", "true")
PLANNER_RECALIBRATE = SystemProperty("geomesa.sql.planner.recalibrate",
                                     "true")

# distributed SQL (sql/distributed.py): "false" sends every statement
# over a cluster down the single-node path; the largest row count a join
# side may have and still be broadcast to every shard group
SQL_DISTRIBUTED = SystemProperty("geomesa.sql.distributed", "true")
SQL_BROADCAST_ROWS = SystemProperty("geomesa.sql.broadcast.rows", "100000")

# the ingest pipeline's shed threshold (queued batches); the SLO reaction
# loop (obs/slo.py) lowers it while a fast burn fires
INGEST_SHED_QUEUE_DEPTH = SystemProperty("geomesa.ingest.shed.queue.depth",
                                         "64")
