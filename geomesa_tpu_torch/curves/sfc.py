"""Space-filling curve front-ends: Z2SFC and Z3SFC.

API mirrors the reference's ``SpaceFillingCurve`` /
``SpaceTimeFillingCurve`` (geomesa-z3/.../curve/SpaceFillingCurve.scala:13,44
and Z2SFC.scala / Z3SFC.scala), vectorized over numpy arrays:

- ``index(x, y[, t])``    normalized-int interleave -> z key(s)
- ``invert(z)``           z3 key(s) -> bin-center (x, y, t offset)
- ``ranges(boxes, ...)``  query boxes -> covering z ranges

Out-of-bounds behavior matches the reference: strict by default
(ValueError), clamped when ``lenient=True`` (Z3SFC.scala:33-50). A
lenient ``index`` of equal-length 1-D columns runs the native fused
encoder (``native/src/zencode.cpp``: one pass instead of about 30 numpy
temporaries); ``index_plain`` is its numpy twin, which also serves
scalars, broadcasting and the strict path.
"""

from __future__ import annotations

import numpy as np

from .. import native
from . import timebin, zorder
from .normalize import normalized_lat, normalized_lon, normalized_time
from .timebin import TimePeriod
from .zranges import merge_ranges as _merge_ranges, zranges as _zranges

__all__ = ["Z2SFC", "Z3SFC", "z2sfc", "z3sfc"]


def _native_index(fn_name: str, arrays, extra=()) -> np.ndarray | None:
    """A native encoder over EQUAL-LENGTH 1-D inputs, as uint64 like the
    numpy path; None when the inputs need numpy's broadcasting (scalars,
    other lengths: the C loop would read out of bounds)."""
    if any(np.ndim(a) != 1 for a in arrays) or len({len(a)
                                                    for a in arrays}) != 1:
        return None
    lib = native.library()
    cast = [np.ascontiguousarray(a, dtype=np.float64) for a in arrays]
    out = np.empty(len(cast[0]), dtype=np.int64)
    getattr(lib, fn_name)(*[native.ptr(a, native.F64P) for a in cast],
                          len(out), *extra, native.ptr(out, native.I64P))
    return out.view(np.uint64)


def _bounded(dims_and_values, lenient: bool, what: str):
    """Shared strict/lenient bounds handling: raise on out-of-bounds
    values unless lenient, in which case clamp (Z3SFC.scala:33-50)."""
    out = []
    for dim, values in dims_and_values:
        values = np.asarray(values, dtype=np.float64)
        if lenient:
            out.append(dim.clamp(values))
        else:
            if bool(np.any(~dim.in_bounds(values))):
                raise ValueError(f"value(s) out of bounds for {what}")
            out.append(values)
    return out


class Z2SFC:
    """2-D z-order curve, 31 bits per dimension (Z2SFC.scala:15)."""

    def __init__(self, precision: int = zorder.Z2_BITS):
        self.precision = precision
        self.lon = normalized_lon(precision)
        self.lat = normalized_lat(precision)

    def index(self, x, y, lenient: bool = False) -> np.ndarray:
        if lenient and self.precision == zorder.Z2_BITS:
            out = _native_index("geomesa_z2_encode", (x, y))
            if out is not None:
                return out
        return self.index_plain(x, y, lenient)

    def index_plain(self, x, y, lenient: bool = False) -> np.ndarray:
        """``index`` in numpy (the native encoder's plain twin)."""
        x, y = _bounded([(self.lon, x), (self.lat, y)], lenient, "z2 index")
        return zorder.z2_encode(self.lon.normalize(x), self.lat.normalize(y))

    def ranges(self, xy, precision: int = 64,
               max_ranges: int | None = None) -> np.ndarray:
        """xy: iterable of (xmin, ymin, xmax, ymax) boxes -> [n,2] z ranges."""
        out = []
        for (xmin, ymin, xmax, ymax) in xy:
            lo = (self.lon.normalize(xmin), self.lat.normalize(ymin))
            hi = (self.lon.normalize(xmax), self.lat.normalize(ymax))
            out.append(_zranges(lo, hi, self.precision, precision=precision,
                                max_ranges=max_ranges))
        if not out:
            return np.empty((0, 2), dtype=np.int64)
        return _merge_ranges(np.concatenate(out, axis=0))


class Z3SFC:
    """3-D (lon, lat, binned-time-offset) z-order curve, 21 bits per
    dimension (Z3SFC.scala:22)."""

    def __init__(self, period: TimePeriod | str = TimePeriod.WEEK,
                 precision: int = zorder.Z3_BITS):
        self.period = TimePeriod.parse(period)
        self.precision = precision
        self.lon = normalized_lon(precision)
        self.lat = normalized_lat(precision)
        self.time = normalized_time(precision,
                                    float(timebin.max_offset(self.period)))

    def index(self, x, y, t, lenient: bool = False) -> np.ndarray:
        """x/y doubles, t = offset within the time bin (not epoch millis)."""
        if lenient and self.precision == zorder.Z3_BITS:
            out = _native_index("geomesa_z3_encode", (x, y, t),
                                extra=(float(self.time.max),))
            if out is not None:
                return out
        return self.index_plain(x, y, t, lenient)

    def index_plain(self, x, y, t, lenient: bool = False) -> np.ndarray:
        """``index`` in numpy (the native encoder's plain twin)."""
        x, y, t = _bounded([(self.lon, x), (self.lat, y), (self.time, t)],
                           lenient, "z3 index")
        return zorder.z3_encode(self.lon.normalize(x), self.lat.normalize(y),
                                self.time.normalize(t))

    def invert(self, z):
        """z3 key(s) -> the bin centers (x, y) and the time offset."""
        xi, yi, ti = zorder.z3_decode(z)
        return (self.lon.denormalize(xi), self.lat.denormalize(yi),
                self.time.denormalize(ti).astype(np.int64))

    def ranges(self, xy, t, precision: int = 64,
               max_ranges: int | None = None) -> np.ndarray:
        """xy: (xmin, ymin, xmax, ymax) boxes; t: (tmin, tmax) offset pairs
        within one time bin -> [n,2] covering z ranges."""
        out = []
        for (xmin, ymin, xmax, ymax) in xy:
            for (tmin, tmax) in t:
                lo = (self.lon.normalize(xmin), self.lat.normalize(ymin),
                      self.time.normalize(tmin))
                hi = (self.lon.normalize(xmax), self.lat.normalize(ymax),
                      self.time.normalize(tmax))
                out.append(_zranges(lo, hi, self.precision,
                                    precision=precision,
                                    max_ranges=max_ranges))
        if not out:
            return np.empty((0, 2), dtype=np.int64)
        return _merge_ranges(np.concatenate(out, axis=0))


_Z3_CACHE: dict[TimePeriod, Z3SFC] = {}
_Z2 = Z2SFC()


def z3sfc(period: TimePeriod | str) -> Z3SFC:
    period = TimePeriod.parse(period)
    if period not in _Z3_CACHE:
        _Z3_CACHE[period] = Z3SFC(period)
    return _Z3_CACHE[period]


def z2sfc() -> Z2SFC:
    return _Z2
