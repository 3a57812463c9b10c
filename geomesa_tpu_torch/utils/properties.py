"""System properties: layered config flags.

Analog of GeoMesaSystemProperties.SystemProperty (geomesa-utils/.../conf/
GeoMesaSystemProperties.scala:17-60): a named flag resolved, in order,
from (1) the process environment (dots become underscores, uppercased),
(2) a process-wide override map, (3) the declared default. Typed
accessors mirror the reference (`.toInt/.toBoolean` -> as_int/as_bool)."""

from __future__ import annotations

import os

__all__ = ["SystemProperty", "HOST_RANGES_TARGET", "WAL_FSYNC",
           "WAL_SEGMENT_BYTES", "WAL_INTERVAL_MS", "INTEGRITY_QUARANTINE"]

_overrides: dict[str, str] = {}


class SystemProperty:
    def __init__(self, name: str, default: str | None = None):
        self.name = name
        self.default = default

    def get(self) -> str | None:
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


# coarser range target for the host index tiers, which re-check every
# candidate exactly: deep decompositions are a per-query cost that a
# selective query stream never earns back
HOST_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.host", "256")

# the write-ahead log (wal/log.py): its fsync policy ("always",
# "interval" or "never"), its segment rotation threshold in bytes, and
# the flush cadence of the "interval" policy
WAL_FSYNC = SystemProperty("geomesa.wal.fsync", "always")
WAL_SEGMENT_BYTES = SystemProperty("geomesa.wal.segment.bytes",
                                   str(64 * 1024 * 1024))
WAL_INTERVAL_MS = SystemProperty("geomesa.wal.interval.ms", "50")

# rename a checkpoint that fails verification at load to *.corrupt
INTEGRITY_QUARANTINE = SystemProperty("geomesa.integrity.quarantine", "true")
