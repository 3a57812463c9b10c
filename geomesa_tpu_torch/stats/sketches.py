"""Statistical sketch algebra (geomesa-utils/.../stats/Stat.scala:29).

The reference's algebra -- ``observe`` / ``merge (+)`` / ``to_json`` /
``serialize`` -- over whole FeatureBatch columns as vectorized numpy
ops, on the host.

Sketches: Count, MinMax, Enumeration, TopK, Frequency (count-min),
Histogram (BinnedArray), DescriptiveStats (moments), GroupBy, SeqStat,
Z3Histogram, Z3Frequency. The DSL string constructors (``Count()``,
``MinMax(attr)``, ``Histogram(attr,20,lo,hi)``, semicolon-joined)
match the reference's StatParser grammar.

Departures from the JAX package (ROADMAP.md section 3): a string hashes
by a 64-bit blake2b of its UTF-8 bytes (Frequency's buckets, MinMax's
distinct set), the same in every process, where the JAX package's
``hash()`` is salted per process; and a Boolean column is observed as
a number (False 0, True 1), where the JAX package raises TypeError.
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Any

import numpy as np

from ..curves import TimePeriod, timebin, z3sfc
from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              NumericColumn, PointColumn, StringColumn)

__all__ = ["Stat", "CountStat", "MinMax", "EnumerationStat", "TopK",
           "Frequency", "Histogram", "DescriptiveStats", "GroupBy",
           "SeqStat", "Z3Histogram", "Z3Frequency", "parse_stat"]


def stable_hash(s: str) -> int:
    """64-bit hash of a string's UTF-8 bytes, equal in every process."""
    return int.from_bytes(hashlib.blake2b(
        s.encode("utf-8"), digest_size=8).digest(), "little")


def _value_hash(v) -> int:
    return stable_hash(v) if isinstance(v, str) else hash(v)


def _col_values(batch: FeatureBatch, attr: str):
    """Column -> (values array, valid mask) in sketch space."""
    col = batch.col(attr)
    if isinstance(col, (NumericColumn, BoolColumn)):
        return col.values, col.valid
    if isinstance(col, DateColumn):
        return col.millis, col.valid
    if isinstance(col, StringColumn):
        vals = np.where(col.codes >= 0, col.vocab[np.maximum(col.codes, 0)], None)
        return vals, col.codes >= 0
    if isinstance(col, PointColumn):
        return (col.x, col.y), col.valid
    raise TypeError(f"unsupported stat column: {type(col).__name__}")


class Stat:
    """Base sketch."""

    def observe(self, batch: FeatureBatch) -> None:
        raise NotImplementedError

    def merge(self, other: "Stat") -> "Stat":
        """In-place combine (the reference's +=); returns self."""
        raise NotImplementedError

    def __iadd__(self, other: "Stat") -> "Stat":
        return self.merge(other)

    def __add__(self, other: "Stat") -> "Stat":
        import copy
        out = copy.deepcopy(self)
        out.merge(other)
        return out

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    def to_json_object(self) -> Any:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_json_object())

    def clear(self) -> None:
        raise NotImplementedError


class CountStat(Stat):
    def __init__(self):
        self.count = 0

    def observe(self, batch: FeatureBatch) -> None:
        self.count += batch.n

    def merge(self, other: "CountStat") -> "CountStat":
        self.count += other.count
        return self

    @property
    def is_empty(self) -> bool:
        return self.count == 0

    def to_json_object(self):
        return {"count": self.count}


class MinMax(Stat):
    """Min/max bounds + HLL-style cardinality estimate (simplified to a
    hash-set-sampling estimator; the reference uses HyperLogLog)."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.min: Any = None
        self.max: Any = None
        self._hashes: set[int] = set()

    def observe(self, batch: FeatureBatch) -> None:
        vals, valid = _col_values(batch, self.attribute)
        if isinstance(vals, tuple):  # geometry: track envelope
            x, y = vals
            x, y = x[valid], y[valid]
            if len(x) == 0:
                return
            lo = (float(x.min()), float(y.min()))
            hi = (float(x.max()), float(y.max()))
            self.min = lo if self.min is None else (
                min(self.min[0], lo[0]), min(self.min[1], lo[1]))
            self.max = hi if self.max is None else (
                max(self.max[0], hi[0]), max(self.max[1], hi[1]))
            return
        vals = vals[valid]
        if len(vals) == 0:
            return
        if vals.dtype == object:
            vmin, vmax = min(vals), max(vals)
        else:
            vmin, vmax = vals.min(), vals.max()
            vmin = vmin.item()
            vmax = vmax.item()
        self.min = vmin if self.min is None else min(self.min, vmin)
        self.max = vmax if self.max is None else max(self.max, vmax)
        # bounded-size distinct estimate
        if len(self._hashes) < 10_000:
            self._hashes.update(_value_hash(v) for v in
                                (vals[:: max(1, len(vals) // 1000)]).tolist())

    def merge(self, other: "MinMax") -> "MinMax":
        for v in (other.min,):
            if v is not None:
                self.min = v if self.min is None else min(self.min, v)
        for v in (other.max,):
            if v is not None:
                self.max = v if self.max is None else max(self.max, v)
        self._hashes |= other._hashes
        return self

    @property
    def cardinality(self) -> int:
        return len(self._hashes)

    @property
    def is_empty(self) -> bool:
        return self.min is None

    def to_json_object(self):
        return {"min": self.min, "max": self.max,
                "cardinality": self.cardinality}


class EnumerationStat(Stat):
    """Exact value counts (utils/stats/EnumerationStat)."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.counts: dict[Any, int] = {}

    def observe(self, batch: FeatureBatch) -> None:
        col = batch.col(self.attribute)
        if isinstance(col, StringColumn):
            # vectorized: bincount over dictionary codes
            valid = col.codes >= 0
            bc = np.bincount(col.codes[valid], minlength=len(col.vocab))
            for code in np.flatnonzero(bc):
                v = str(col.vocab[code])
                self.counts[v] = self.counts.get(v, 0) + int(bc[code])
            return
        vals, valid = _col_values(batch, self.attribute)
        uniq, cnt = np.unique(np.asarray(vals)[valid], return_counts=True)
        for v, c in zip(uniq.tolist(), cnt.tolist()):
            self.counts[v] = self.counts.get(v, 0) + int(c)

    def merge(self, other: "EnumerationStat") -> "EnumerationStat":
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        return self

    @property
    def is_empty(self) -> bool:
        return not self.counts

    def to_json_object(self):
        return {str(k): v for k, v in sorted(
            self.counts.items(), key=lambda kv: (-kv[1], str(kv[0])))}


class TopK(Stat):
    """Top-k heavy hitters (reference wraps clearspring StreamSummary;
    here a capped exact counter with eviction — same output contract)."""

    CAPACITY = 10 * 128  # matches StreamSummary default-ish working size

    def __init__(self, attribute: str, k: int = 10):
        self.attribute = attribute
        self.k = k
        self.counts: dict[Any, int] = {}

    def observe(self, batch: FeatureBatch) -> None:
        en = EnumerationStat(self.attribute)
        en.observe(batch)
        for v, c in en.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        self._evict()

    def _evict(self):
        if len(self.counts) > self.CAPACITY:
            keep = sorted(self.counts.items(), key=lambda kv: -kv[1])
            self.counts = dict(keep[:self.CAPACITY])

    def merge(self, other: "TopK") -> "TopK":
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        self._evict()
        return self

    def topk(self) -> list[tuple[Any, int]]:
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], str(kv[0])))[:self.k]

    @property
    def is_empty(self) -> bool:
        return not self.counts

    def to_json_object(self):
        return [{"value": v, "count": c} for v, c in self.topk()]


class Frequency(Stat):
    """Count-min sketch (utils/stats/Frequency), vectorized: values hash
    through d=4 row hashes onto w=2^precision buckets."""

    D = 4

    def __init__(self, attribute: str, precision: int = 12):
        self.attribute = attribute
        self.precision = precision
        self.width = 1 << precision
        self.table = np.zeros((self.D, self.width), dtype=np.int64)
        self.total = 0

    _SEEDS = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F],
                      dtype=np.uint64)

    def _bits(self, vals: np.ndarray) -> np.ndarray:
        """The 64-bit key of each value. Numeric values key by their
        exact 64-bit patterns (floats via bit view, not truncation) so
        observe() and count() agree for any value type."""
        if vals.dtype == object:
            return np.array([self._scalar_bits(v) for v in vals],
                            dtype=np.uint64)
        if vals.dtype.kind == "f":
            return vals.astype(np.float64).view(np.uint64)
        return vals.astype(np.int64).view(np.uint64)

    def _hash(self, vals: np.ndarray) -> np.ndarray:
        """(D, n) bucket indices via multiply-shift hashing."""
        return self._buckets(self._bits(vals))

    def _buckets(self, h: np.ndarray) -> np.ndarray:
        out = np.empty((self.D, len(h)), dtype=np.int64)
        for d in range(self.D):
            mixed = (h * self._SEEDS[d])
            mixed ^= mixed >> np.uint64(33)
            out[d] = (mixed % np.uint64(self.width)).astype(np.int64)
        return out

    def observe(self, batch: FeatureBatch, weight: int = 1) -> None:
        col = batch.col(self.attribute)
        if isinstance(col, StringColumn):
            # each distinct string hashed once, gathered by code
            vh = np.array([stable_hash(str(v)) for v in col.vocab],
                          dtype=np.uint64)
            codes = col.codes[col.codes >= 0]
            self._observe_bits(vh[codes], weight)
            return
        vals, valid = _col_values(batch, self.attribute)
        self.observe_values(np.asarray(vals)[valid], weight)

    def observe_values(self, vals: np.ndarray, weight: int = 1) -> None:
        """Value-level update (also the hook for key-derived sketches
        like Z3Frequency). ``weight`` scales each observation — the
        write path observes strided subsamples of huge batches and
        passes the stride so differently-sampled batches stay
        comparable (same contract as Z3Histogram.observe)."""
        if len(vals) == 0:
            return
        self._observe_bits(self._bits(vals), weight)

    def _observe_bits(self, h: np.ndarray, weight: int) -> None:
        if len(h) == 0:
            return
        idx = self._buckets(h)
        for d in range(self.D):
            self.table[d] += np.bincount(
                idx[d], minlength=self.width) * int(weight)
        self.total += len(h) * int(weight)

    @staticmethod
    def _scalar_bits(v) -> int:
        if isinstance(v, (bool, np.bool_)):
            return int(v)
        if isinstance(v, (int, np.integer)):
            return int(np.int64(v).view(np.uint64))
        if isinstance(v, (float, np.floating)):
            return int(np.float64(v).view(np.uint64))
        return _value_hash(v) & 0xFFFFFFFFFFFFFFFF

    def count(self, value) -> int:
        idx = self._hash(np.array([value], dtype=object))
        return int(min(self.table[d, idx[d, 0]] for d in range(self.D)))

    def count_value(self, value: np.int64) -> int:
        """count() for an exact-typed (non-object) scalar key."""
        idx = self._hash(np.array([value], dtype=np.int64))
        return int(min(self.table[d, idx[d, 0]] for d in range(self.D)))

    def merge(self, other: "Frequency") -> "Frequency":
        self.table += other.table
        self.total += other.total
        return self

    @property
    def is_empty(self) -> bool:
        return self.total == 0

    def to_json_object(self):
        return {"precision": self.precision, "total": self.total}


class Histogram(Stat):
    """Fixed-width binned histogram over [min, max] (utils/stats/
    Histogram + BinnedArray): values below/above clamp to the end bins."""

    def __init__(self, attribute: str, bins: int, lo, hi):
        self.attribute = attribute
        self.bins = bins
        self.lo = lo
        self.hi = hi
        self.counts = np.zeros(bins, dtype=np.int64)

    def _to_f64(self, v) -> float:
        if isinstance(v, str):
            try:
                return float(np.datetime64(v.rstrip("Z"), "ms").astype(np.int64))
            except ValueError:
                raise TypeError(f"non-numeric histogram bound: {v!r}")
        return float(v)

    def observe(self, batch: FeatureBatch) -> None:
        vals, valid = _col_values(batch, self.attribute)
        if isinstance(vals, tuple):
            raise TypeError("use Z3Histogram for geometries")
        vals = np.asarray(vals[valid], dtype=np.float64)
        if len(vals) == 0:
            return
        lo, hi = self._to_f64(self.lo), self._to_f64(self.hi)
        width = (hi - lo) / self.bins if hi > lo else 1.0
        idx = np.clip(((vals - lo) / width).astype(np.int64), 0, self.bins - 1)
        self.counts += np.bincount(idx, minlength=self.bins)

    def bin_bounds(self, i: int) -> tuple[float, float]:
        lo, hi = self._to_f64(self.lo), self._to_f64(self.hi)
        width = (hi - lo) / self.bins
        return lo + i * width, lo + (i + 1) * width

    def merge(self, other: "Histogram") -> "Histogram":
        if (other.bins != self.bins or other.lo != self.lo
                or other.hi != self.hi):
            raise ValueError("histogram shape mismatch")
        self.counts += other.counts
        return self

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    @property
    def is_empty(self) -> bool:
        return self.total == 0

    def to_json_object(self):
        return {"lower-bound": self.lo, "upper-bound": self.hi,
                "bins": self.counts.tolist()}


class DescriptiveStats(Stat):
    """Streaming moments: count/min/max/mean/variance/skew/kurtosis
    (utils/stats/DescriptiveStats), merged with the parallel-moments
    formulas."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.n = 0
        self.min = np.inf
        self.max = -np.inf
        self.m1 = 0.0
        self.m2 = 0.0
        self.m3 = 0.0
        self.m4 = 0.0

    def observe(self, batch: FeatureBatch) -> None:
        vals, valid = _col_values(batch, self.attribute)
        v = np.asarray(vals[valid], dtype=np.float64)
        if len(v) == 0:
            return
        other = DescriptiveStats(self.attribute)
        other.n = len(v)
        other.min = float(v.min())
        other.max = float(v.max())
        other.m1 = float(v.mean())
        d = v - other.m1
        other.m2 = float((d ** 2).sum())
        other.m3 = float((d ** 3).sum())
        other.m4 = float((d ** 4).sum())
        self.merge(other)

    def merge(self, o: "DescriptiveStats") -> "DescriptiveStats":
        if o.n == 0:
            return self
        if self.n == 0:
            self.__dict__.update({k: getattr(o, k) for k in
                                  ("n", "min", "max", "m1", "m2", "m3", "m4")})
            return self
        n1, n2 = self.n, o.n
        n = n1 + n2
        delta = o.m1 - self.m1
        d_n = delta / n
        d2 = delta * d_n
        m1 = self.m1 + n2 * d_n
        m2 = self.m2 + o.m2 + d2 * n1 * n2
        m3 = (self.m3 + o.m3 + d2 * d_n * n1 * n2 * (n1 - n2)
              + 3.0 * d_n * (n1 * o.m2 - n2 * self.m2))
        m4 = (self.m4 + o.m4
              + d2 * d_n * d_n * n1 * n2 * (n1 * n1 - n1 * n2 + n2 * n2)
              + 6.0 * d_n * d_n * (n1 * n1 * o.m2 + n2 * n2 * self.m2)
              + 4.0 * d_n * (n1 * o.m3 - n2 * self.m3))
        self.n, self.m1, self.m2, self.m3, self.m4 = n, m1, m2, m3, m4
        self.min = min(self.min, o.min)
        self.max = max(self.max, o.max)
        return self

    @property
    def mean(self) -> float:
        return self.m1

    @property
    def variance(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def stddev(self) -> float:
        return float(np.sqrt(self.variance))

    @property
    def skewness(self) -> float:
        if self.n < 2 or self.m2 == 0:
            return 0.0
        return float(np.sqrt(self.n) * self.m3 / self.m2 ** 1.5)

    @property
    def kurtosis(self) -> float:
        if self.m2 == 0:
            return 0.0
        return float(self.n * self.m4 / (self.m2 * self.m2) - 3.0)

    @property
    def is_empty(self) -> bool:
        return self.n == 0

    def to_json_object(self):
        if self.is_empty:
            return {"count": 0}
        return {"count": self.n, "minimum": self.min, "maximum": self.max,
                "mean": self.mean, "stddev": self.stddev,
                "skewness": self.skewness, "kurtosis": self.kurtosis}


class GroupBy(Stat):
    """Group a sub-stat by the values of an attribute (utils/stats/GroupBy)."""

    def __init__(self, attribute: str, sub_spec: str):
        self.attribute = attribute
        self.sub_spec = sub_spec
        self.groups: dict[Any, Stat] = {}

    def observe(self, batch: FeatureBatch) -> None:
        vals, valid = _col_values(batch, self.attribute)
        vals = np.asarray(vals)
        uniq = np.unique(vals[valid].astype(str) if vals.dtype == object
                         else vals[valid])
        for v in uniq.tolist():
            sel = np.flatnonzero(valid & (vals == v))
            sub = batch.take(sel)
            if v not in self.groups:
                self.groups[v] = parse_stat(self.sub_spec)
            self.groups[v].observe(sub)

    def merge(self, other: "GroupBy") -> "GroupBy":
        import copy
        for v, s in other.groups.items():
            if v in self.groups:
                self.groups[v].merge(s)
            else:
                # copy: adopting by reference would alias future observes
                self.groups[v] = copy.deepcopy(s)
        return self

    @property
    def is_empty(self) -> bool:
        return not self.groups

    def to_json_object(self):
        return [{str(k): v.to_json_object()} for k, v in
                sorted(self.groups.items(), key=lambda kv: str(kv[0]))]


class SeqStat(Stat):
    """Multiple stats observed together (semicolon-joined specs)."""

    def __init__(self, stats: list[Stat]):
        self.stats = stats

    def observe(self, batch: FeatureBatch) -> None:
        for s in self.stats:
            s.observe(batch)

    def merge(self, other: "SeqStat") -> "SeqStat":
        for a, b in zip(self.stats, other.stats):
            a.merge(b)
        return self

    @property
    def is_empty(self) -> bool:
        return all(s.is_empty for s in self.stats)

    def to_json_object(self):
        return [s.to_json_object() for s in self.stats]


class Z3Histogram(Stat):
    """Counts binned by (time bin, coarse z3 cell)
    (utils/stats/Z3Histogram.scala:33) — the sketch behind the
    stats-based spatio-temporal cost estimator."""

    def __init__(self, geom: str, dtg: str,
                 period: TimePeriod | str = TimePeriod.WEEK,
                 length: int = 1024):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.length = length
        self.bins: dict[int, np.ndarray] = {}
        # z bits kept: log2(length) of the leading z3 bits
        self._shift = 63 - int(np.log2(length))
        # incrementally-maintained aggregates: the cost estimator reads
        # these per query, so they must never require an O(bins) walk
        self.total = 0
        self.bin_mass: dict[int, int] = {}
        self.cell_mass = np.zeros(length, dtype=np.int64)

    def observe(self, batch: FeatureBatch, weight: int = 1) -> None:
        """``weight`` scales this batch's counts — the write path
        observes a strided subsample of huge batches and passes the
        stride so masses stay comparable across differently-sampled
        batches."""
        gcol = batch.col(self.geom)
        if not isinstance(gcol, PointColumn):
            raise TypeError("Z3Histogram requires a point geometry")
        ms = batch.col(self.dtg).millis
        valid = gcol.valid & batch.col(self.dtg).valid
        if not valid.any():
            return
        x, y, ms = gcol.x[valid], gcol.y[valid], ms[valid]
        tbins, offs = timebin.to_binned(ms, self.period, lenient=True)
        sfc = z3sfc(self.period)
        z = sfc.index(x, y, np.minimum(offs, int(sfc.time.max)), lenient=True)
        cell = (z >> np.uint64(self._shift)).astype(np.int64)
        # one fused bincount over (time bin, cell) composite keys. The
        # grid is sized by the DISTINCT bins present (np.unique remap),
        # not by the max absolute bin — keying by tbins.max() made a
        # single clamped far-future timestamp (bin 32767) allocate a
        # ~270MB transient regardless of batch size
        ubins, inv = np.unique(tbins, return_inverse=True)
        key = inv.astype(np.int64) * self.length + cell
        grid = np.bincount(
            key, minlength=len(ubins) * self.length
        ).reshape(len(ubins), self.length)
        if weight != 1:
            grid = grid * int(weight)
        for j, b in enumerate(ubins.tolist()):
            arr = self.bins.setdefault(int(b),
                                       np.zeros(self.length, dtype=np.int64))
            arr += grid[j]
            m = int(grid[j].sum())
            self.bin_mass[int(b)] = self.bin_mass.get(int(b), 0) + m
            self.total += m
        self.cell_mass += grid.sum(axis=0)

    def count(self, time_bin: int, cell: int) -> int:
        arr = self.bins.get(time_bin)
        return int(arr[cell]) if arr is not None else 0

    def merge(self, other: "Z3Histogram") -> "Z3Histogram":
        for b, arr in other.bins.items():
            if b in self.bins:
                self.bins[b] += arr
            else:
                self.bins[b] = arr.copy()
            self.bin_mass[b] = self.bin_mass.get(b, 0) + int(arr.sum())
        self.total += other.total
        self.cell_mass += other.cell_mass
        return self

    @property
    def is_empty(self) -> bool:
        return not self.bins

    def to_json_object(self):
        return {str(b): int(a.sum()) for b, a in sorted(self.bins.items())}


class Z3Frequency(Stat):
    """Count-min sketch over (time bin, coarse z3 cell) keys
    (utils/stats/Z3Frequency.scala) — approximate per-cell counts with
    bounded memory where Z3Histogram keeps exact per-bin arrays."""

    def __init__(self, geom: str, dtg: str,
                 period: TimePeriod | str = TimePeriod.WEEK,
                 precision: int = 12):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.precision = precision
        self._freq = Frequency("__z3__", precision)
        # coarse cell = leading bits of z3 (same resolution rule as
        # Z3Histogram's 1024 cells)
        self._shift = 63 - 10

    def _keys(self, batch: FeatureBatch) -> np.ndarray:
        gcol = batch.col(self.geom)
        if not isinstance(gcol, PointColumn):
            raise TypeError("Z3Frequency requires a point geometry")
        ms = batch.col(self.dtg).millis
        valid = gcol.valid & batch.col(self.dtg).valid
        x, y, ms = gcol.x[valid], gcol.y[valid], ms[valid]
        tbins, offs = timebin.to_binned(ms, self.period, lenient=True)
        sfc = z3sfc(self.period)
        z = sfc.index(x, y, np.minimum(offs, int(sfc.time.max)),
                      lenient=True)
        cell = (z >> np.uint64(self._shift)).astype(np.int64)
        # bin lives in the LOW 16 bits: the multiply-shift hash folds
        # high bits only once, so keys differing near the top would
        # collide into identical buckets
        return (cell << np.int64(16)) | (tbins.astype(np.int64) & 0xFFFF)

    def observe(self, batch: FeatureBatch) -> None:
        self._freq.observe_values(self._keys(batch))

    def count(self, time_bin: int, cell: int) -> int:
        key = np.int64((int(cell) << 16) | (int(time_bin) & 0xFFFF))
        return self._freq.count_value(key)

    def merge(self, other: "Z3Frequency") -> "Z3Frequency":
        if (other.period != self.period
                or other.precision != self.precision):
            raise ValueError(
                f"cannot merge Z3Frequency({other.period},"
                f"{other.precision}) into ({self.period},{self.precision})"
                " - different keyspaces")
        self._freq.merge(other._freq)
        return self

    @property
    def is_empty(self) -> bool:
        return self._freq.is_empty

    def to_json_object(self):
        return {"precision": self.precision, "total": self._freq.total}


# -- DSL parser ------------------------------------------------------------

_STAT_RE = re.compile(r"^\s*(\w+)\((.*)\)\s*$")


def _split_args(s: str) -> list[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return [a.strip().strip("'\"") for a in out]


def parse_stat(spec: str) -> Stat:
    """Parse a reference-style stat spec string, e.g.
    ``"MinMax(foo);Histogram(bar,20,0,100)"`` (StatParser analog)."""
    parts = [p for p in spec.split(";") if p.strip()]
    if len(parts) > 1:
        return SeqStat([parse_stat(p) for p in parts])
    m = _STAT_RE.match(parts[0])
    if not m:
        raise ValueError(f"cannot parse stat spec: {spec!r}")
    name, args = m.group(1), _split_args(m.group(2))
    if name == "Count":
        return CountStat()
    if name == "MinMax":
        return MinMax(args[0])
    if name == "Enumeration":
        return EnumerationStat(args[0])
    if name == "TopK":
        return TopK(args[0], int(args[1]) if len(args) > 1 else 10)
    if name == "Frequency":
        precision = int(args[-1]) if len(args) > 1 else 12
        return Frequency(args[0], precision)
    if name == "Histogram":
        lo, hi = args[2], args[3]
        for conv in (int, float):
            try:
                lo, hi = conv(args[2]), conv(args[3])
                break
            except ValueError:
                continue
        return Histogram(args[0], int(args[1]), lo, hi)
    if name == "DescriptiveStats":
        return DescriptiveStats(args[0])
    if name == "GroupBy":
        return GroupBy(args[0], ",".join(args[1:]))
    if name == "Z3Histogram":
        period = args[2] if len(args) > 2 else "week"
        length = int(args[3]) if len(args) > 3 else 1024
        return Z3Histogram(args[0], args[1], period, length)
    if name == "Z3Frequency":
        period = args[2] if len(args) > 2 else "week"
        precision = int(args[3]) if len(args) > 3 else 12
        return Z3Frequency(args[0], args[1], period, precision)
    raise ValueError(f"unknown stat: {name}")
