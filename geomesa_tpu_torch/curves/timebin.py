"""Epoch binning of timestamps: (bin, offset) pairs.

Mirrors the reference's ``BinnedTime``
(geomesa-z3/.../curve/BinnedTime.scala:44-121): a timestamp is split into
a small integer *bin* (days / weeks / calendar-months / calendar-years
since the java epoch) and an *offset* into that bin (millis / seconds /
seconds / minutes respectively).

All functions are vectorized over int64 epoch-millis numpy arrays.
Calendar-aware month/year binning uses numpy ``datetime64`` truncation,
which agrees with joda's ``monthsBetween(Epoch, d)`` /
``yearsBetween(Epoch, d)`` because the anchor is exactly
1970-01-01T00:00:00Z (the first instant of a month and a year).
"""

from __future__ import annotations

import enum

import numpy as np

from .. import native

__all__ = ["TimePeriod", "max_offset", "max_date_millis", "to_binned",
           "to_binned_plain", "bins_of_interval", "NATIVE_BINNED_ROWS"]

MILLIS_PER_DAY = 86_400_000
MILLIS_PER_WEEK = 7 * MILLIS_PER_DAY
MAX_BIN = 32767  # Short.MaxValue in the reference; bins are int16-sized


class TimePeriod(str, enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @classmethod
    def parse(cls, s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return cls(s.lower())


def max_offset(period: TimePeriod) -> int:
    """Max indexable offset within a bin (BinnedTime.scala:115-121).

    Day => millis/day; Week => seconds/week; Month => seconds in 31 days;
    Year => minutes in 52 weeks.
    """
    period = TimePeriod.parse(period)
    if period is TimePeriod.DAY:
        return MILLIS_PER_DAY
    if period is TimePeriod.WEEK:
        return MILLIS_PER_WEEK // 1000
    if period is TimePeriod.MONTH:
        return (MILLIS_PER_DAY // 1000) * 31
    return (MILLIS_PER_WEEK // 60_000) * 52


def _epoch_ms(dt64) -> np.ndarray:
    return dt64.astype("datetime64[ms]").astype(np.int64)


def max_date_millis(period: TimePeriod) -> int:
    """Exclusive max indexable date, in epoch millis (bin fits a Short)."""
    period = TimePeriod.parse(period)
    n = MAX_BIN + 1
    if period is TimePeriod.DAY:
        return n * MILLIS_PER_DAY
    if period is TimePeriod.WEEK:
        return n * MILLIS_PER_WEEK
    if period is TimePeriod.MONTH:
        return int(_epoch_ms(np.datetime64(n, "M")))
    return int(_epoch_ms(np.datetime64(n, "Y")))


# a lenient 1-D column of at least this many DAY or WEEK millis is
# binned by the native library (constant-divisor multiply-shift; numpy's
# int64 division loops a scalar divide)
NATIVE_BINNED_ROWS = 4096


def to_binned(millis, period: TimePeriod, lenient: bool = False):
    """Vectorized epoch-millis -> (bins:int32, offsets:int64).

    Matches BinnedTime.scala to{Day,Week,Month,Year}And* semantics.
    With ``lenient`` out-of-range values clamp instead of raising. A
    lenient DAY or WEEK column of NATIVE_BINNED_ROWS or more runs the
    native binning (``native/src/zbuild.cpp``); ``to_binned_plain`` is
    its numpy twin, and the path of every other call.
    """
    period = TimePeriod.parse(period)
    millis = np.asarray(millis, dtype=np.int64)
    if (lenient and period in (TimePeriod.DAY, TimePeriod.WEEK)
            and millis.ndim == 1 and len(millis) >= NATIVE_BINNED_ROWS):
        return _native_binned(millis, period)
    return to_binned_plain(millis, period, lenient)


def _native_binned(millis: np.ndarray, period: TimePeriod):
    """(bins, offsets) of a 1-D DAY or WEEK column, clamped as lenient."""
    millis = np.ascontiguousarray(millis, dtype=np.int64)
    bins = np.empty(len(millis), dtype=np.int32)
    offs = np.empty(len(millis), dtype=np.int64)
    rc = native.library().geomesa_binned(
        native.ptr(millis, native.I64P), len(millis),
        0 if period is TimePeriod.DAY else 1,
        native.ptr(bins, native.I32P), native.ptr(offs, native.I64P))
    if rc != 0:
        raise RuntimeError(f"geomesa_binned failed ({rc})")
    return bins, offs


def to_binned_plain(millis, period: TimePeriod, lenient: bool = False):
    """``to_binned`` in numpy (the native binning's plain twin)."""
    period = TimePeriod.parse(period)
    millis = np.asarray(millis, dtype=np.int64)
    lo, hi = 0, max_date_millis(period)
    if lenient:
        millis = np.clip(millis, lo, hi - 1)
    elif bool(np.any((millis < lo) | (millis >= hi))):
        bad = millis[(millis < lo) | (millis >= hi)]
        raise ValueError(
            f"date exceeds indexable range [0, {hi}) for period {period.value}: "
            f"{bad[:3].tolist()}")

    if period is TimePeriod.DAY:
        bins = millis // MILLIS_PER_DAY
        offs = millis - bins * MILLIS_PER_DAY
    elif period is TimePeriod.WEEK:
        bins = millis // MILLIS_PER_WEEK
        offs = (millis - bins * MILLIS_PER_WEEK) // 1000
    else:
        unit = "M" if period is TimePeriod.MONTH else "Y"
        dt = millis.astype("datetime64[ms]")
        binned = dt.astype(f"datetime64[{unit}]")
        bins = binned.astype(np.int64)
        start = _epoch_ms(binned)
        if period is TimePeriod.MONTH:
            offs = (millis - start) // 1000
        else:
            offs = (millis - start) // 60_000
    return bins.astype(np.int32), offs.astype(np.int64)


def bins_of_interval(lo_millis: int, hi_millis: int, period: TimePeriod):
    """All (bin, lo_offset, hi_offset) triples covering [lo, hi] millis,
    clamped to the indexable range: the per-bin fan-out of the query
    planner (Z3IndexKeySpace.scala:100-116). Interior bins cover the
    whole period; edge bins carry partial offsets.

    Returns (bins:int32[], lo_offs:int64[], hi_offs:int64[]) with
    inclusive offset bounds.
    """
    period = TimePeriod.parse(period)
    hi_cap = max_date_millis(period) - 1
    # intervals entirely outside the indexable range match nothing; test
    # BEFORE clamping so they don't collapse onto a spurious boundary bin
    if hi_millis < lo_millis or hi_millis < 0 or lo_millis > hi_cap:
        return (np.empty(0, np.int32), np.empty(0, np.int64), np.empty(0, np.int64))
    lo_millis = int(np.clip(lo_millis, 0, hi_cap))
    hi_millis = int(np.clip(hi_millis, 0, hi_cap))
    lo_bin, lo_off = to_binned(lo_millis, period)
    hi_bin, hi_off = to_binned(hi_millis, period)
    lo_bin, hi_bin = int(lo_bin), int(hi_bin)
    bins = np.arange(lo_bin, hi_bin + 1, dtype=np.int32)
    full = max_offset(period)
    lo_offs = np.full(bins.shape, 0, dtype=np.int64)
    hi_offs = np.full(bins.shape, full, dtype=np.int64)
    lo_offs[0] = int(lo_off)
    hi_offs[-1] = int(hi_off)
    return bins, lo_offs, hi_offs
