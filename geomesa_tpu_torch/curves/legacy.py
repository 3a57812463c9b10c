"""The legacy z3 curve of index version 1 (LegacyZ3SFC.scala:16).

A store written by an old version keeps its z3 sort order under this
curve, so it can still be read, deleted from and migrated: it differs
from the current Z3SFC by *semi-normalized* dimensions, a ceil-based
normalization over precision 2^21-1 for lon/lat and 2^20-1 for time
(NormalizedDimension.scala:83-97 SemiNormalizedDimension:
ceil((x-min)/(max-min) * precision)), where the current curve floors
onto 2^21 bins.
"""

from __future__ import annotations

import numpy as np

from . import zorder
from .timebin import TimePeriod, max_offset

__all__ = ["SemiNormalizedDimension", "LegacyZ3SFC", "legacy_z3sfc"]


class SemiNormalizedDimension:
    """ceil-based normalization (NormalizedDimension.scala:83-87):
    ``normalize`` is a bare ``ceil((x-min)/(max-min)*precision)`` with NO
    clamping, and ``denormalize`` returns ``min`` for bin 0 and cell
    *midpoints* otherwise (the "doesn't correctly bin lower bound"
    quirk of the old writer)."""

    def __init__(self, lo: float, hi: float, precision: int):
        self.lo = lo
        self.hi = hi
        self.precision = precision  # the max index, not a bit count

    def normalize(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        i = np.ceil((x - self.lo) / (self.hi - self.lo) * self.precision)
        return i.astype(np.int64)

    def lenient(self, x) -> np.ndarray:
        """lenientIndex arithmetic (LegacyZ3SFC.scala:24-29): the ceil
        clamped at the dimension's MINIMUM as a double (max(-180.0, i)
        for longitude), so far-out west/south inputs give negative
        indices like -180 that alias through the 21-bit mask exactly as
        the old writer's did."""
        x = np.asarray(x, np.float64)
        i = np.ceil((x - self.lo) / (self.hi - self.lo) * self.precision)
        return np.maximum(i, self.lo).astype(np.int64)

    def denormalize(self, i) -> np.ndarray:
        i = np.asarray(i)
        mid = (i - 0.5) * (self.hi - self.lo) / self.precision + self.lo
        return np.where(i == 0, self.lo, mid)


class LegacyZ3SFC:
    """The old z3 scheme: 21-bit semi-normalized lon/lat, 20-bit
    semi-normalized time (LegacyZ3SFC.scala:16-22). ``index`` follows
    the old lenient write path, so legacy rows are found where the old
    writer put them; ``invert`` decodes legacy z values."""

    # bits per dimension of the interleave (time uses 20 of its 21, and
    # legacy time cells never pass 2^20-1, so covers over the 21-bit
    # cube stay correct)
    precision = zorder.Z3_BITS

    def __init__(self, period: TimePeriod | str = TimePeriod.WEEK):
        self.period = TimePeriod.parse(period)
        self.lon = SemiNormalizedDimension(-180.0, 180.0, 2 ** 21 - 1)
        self.lat = SemiNormalizedDimension(-90.0, 90.0, 2 ** 21 - 1)
        self.time = SemiNormalizedDimension(
            0.0, float(max_offset(self.period)), 2 ** 20 - 1)

    def index(self, x, y, t, lenient: bool = False) -> np.ndarray:
        """x/y doubles, t = the offset in the time bin.

        Strict by default: out-of-range values raise (they would alias
        through the 21-bit mask). ``lenient`` skips the check and
        reproduces the old lenientIndex arithmetic, aliasing included:
        it finds whatever cell the old writer used
        (LegacyZ3SFC.scala:24-29)."""
        if lenient:
            return zorder.z3_encode(self.lon.lenient(x), self.lat.lenient(y),
                                    self.time.lenient(t))
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        t = np.asarray(t, np.float64)
        if (np.any(x < -180) or np.any(x > 180) or np.any(y < -90)
                or np.any(y > 90) or np.any(t < 0)
                or np.any(t > self.time.hi)):
            raise ValueError("value(s) out of bounds for legacy z3 index "
                             "(pass lenient=True to reproduce the old "
                             "aliasing write path)")
        return zorder.z3_encode(self.lon.normalize(x), self.lat.normalize(y),
                                self.time.normalize(t))

    def invert(self, z):
        xi, yi, ti = zorder.z3_decode(z)
        return (self.lon.denormalize(xi), self.lat.denormalize(yi),
                self.time.denormalize(ti).astype(np.int64))

    def ranges(self, xy, t, precision: int = 64,
               max_ranges: int | None = None) -> np.ndarray:
        """Covering z ranges under the legacy ceil normalization, so a
        version-1 index prunes with the cells its writer used. ceil is
        monotone, so [normalize(lo), normalize(hi)] covers [lo, hi]."""
        from .zranges import merge_ranges, zranges

        def norm(dim, v):
            return int(np.clip(dim.normalize(v), 0, dim.precision))

        out = []
        for (xmin, ymin, xmax, ymax) in xy:
            for (tmin, tmax) in t:
                lo = (norm(self.lon, xmin), norm(self.lat, ymin),
                      norm(self.time, tmin))
                hi = (norm(self.lon, xmax), norm(self.lat, ymax),
                      norm(self.time, tmax))
                out.append(zranges(lo, hi, self.precision,
                                   precision=precision,
                                   max_ranges=max_ranges))
        if not out:
            return np.empty((0, 2), dtype=np.int64)
        return merge_ranges(np.concatenate(out, axis=0))


_CACHE: dict[TimePeriod, LegacyZ3SFC] = {}


def legacy_z3sfc(period: TimePeriod | str) -> LegacyZ3SFC:
    period = TimePeriod.parse(period)
    if period not in _CACHE:
        _CACHE[period] = LegacyZ3SFC(period)
    return _CACHE[period]
