"""Columnar feature model: struct-of-arrays batches on the host.

One numpy array per attribute with a validity mask: point coordinates
as float64 x/y pairs, dates as epoch millis, strings dictionary-encoded,
numbers as int64 (Integer, Long) or float64 (Float, Double; a NaN reads
as null), booleans as bool. The in-memory store builds its device
columns (two-float coordinates, (day, ms) times, the residual's split
attribute columns) from these.

Extent-geometry columns arrive with the extent (XZ) slice of the port
(ROADMAP.md section 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from ..geometry import Point, parse_wkt
from .sft import SimpleFeatureType

__all__ = ["FeatureBatch", "Column", "NumericColumn", "BoolColumn",
           "DateColumn", "StringColumn", "PointColumn", "COLUMN_TYPES"]

# the attribute types this port stores (String and UUID share one column)
COLUMN_TYPES = frozenset({"Point", "String", "UUID", "Date", "Boolean",
                          "Integer", "Long", "Float", "Double"})


class Column:
    """Base column; length n with a validity mask."""

    name: str
    n: int
    valid: np.ndarray  # bool[n]

    def take(self, idx: np.ndarray) -> "Column":
        raise NotImplementedError

    def value(self, i: int):
        """Row i as a Python value; None for a null."""
        raise NotImplementedError


@dataclasses.dataclass
class NumericColumn(Column):
    """Numbers: int64 (Integer, Long) or float64 (Float, Double)."""
    name: str
    values: np.ndarray
    valid: np.ndarray

    @property
    def n(self) -> int:
        return len(self.values)

    def take(self, idx) -> "NumericColumn":
        return NumericColumn(self.name, self.values[idx], self.valid[idx])

    def value(self, i: int):
        if not self.valid[i]:
            return None
        v = self.values[i]
        return float(v) if self.values.dtype.kind == "f" else int(v)


@dataclasses.dataclass
class BoolColumn(Column):
    name: str
    values: np.ndarray          # bool
    valid: np.ndarray

    @property
    def n(self) -> int:
        return len(self.values)

    def take(self, idx) -> "BoolColumn":
        return BoolColumn(self.name, self.values[idx], self.valid[idx])

    def value(self, i: int):
        return bool(self.values[i]) if self.valid[i] else None


@dataclasses.dataclass
class DateColumn(Column):
    """Dates as epoch millis int64."""
    name: str
    millis: np.ndarray
    valid: np.ndarray

    @property
    def n(self) -> int:
        return len(self.millis)

    def take(self, idx) -> "DateColumn":
        return DateColumn(self.name, self.millis[idx], self.valid[idx])

    def value(self, i: int):
        return int(self.millis[i]) if self.valid[i] else None


@dataclasses.dataclass
class StringColumn(Column):
    """Dictionary-encoded strings: codes int32 into vocab; -1 = null."""
    name: str
    codes: np.ndarray           # int32, -1 for null
    vocab: np.ndarray           # object array of unique strings, sorted

    @property
    def n(self) -> int:
        return len(self.codes)

    @property
    def valid(self) -> np.ndarray:  # type: ignore[override]
        return self.codes >= 0

    def take(self, idx) -> "StringColumn":
        return StringColumn(self.name, self.codes[idx], self.vocab)

    def value(self, i: int):
        c = self.codes[i]
        return None if c < 0 else str(self.vocab[c])

    def code_of(self, s: str) -> int:
        """Vocab code for s, or -1 if absent."""
        i = np.searchsorted(self.vocab, s)
        if i < len(self.vocab) and self.vocab[i] == s:
            return int(i)
        return -1

    @classmethod
    def from_strings(cls, name: str, values: Iterable) -> "StringColumn":
        arr = np.asarray(list(values), dtype=object)
        mask = np.array([v is not None for v in arr], dtype=bool)
        filled = np.where(mask, arr, "")
        vocab, codes = np.unique(filled.astype(str), return_inverse=True)
        codes = codes.astype(np.int32)
        codes[~mask] = -1
        return cls(name, codes, vocab.astype(object))


@dataclasses.dataclass
class PointColumn(Column):
    """Point geometry: x/y float64 pairs (the hot layout)."""
    name: str
    x: np.ndarray
    y: np.ndarray
    valid: np.ndarray

    @property
    def n(self) -> int:
        return len(self.x)

    def take(self, idx) -> "PointColumn":
        return PointColumn(self.name, self.x[idx], self.y[idx], self.valid[idx])

    def value(self, i: int):
        return Point(self.x[i], self.y[i]) if self.valid[i] else None


def _column_for(spec_type: str, name: str, data) -> Column:
    n = len(data)
    if spec_type == "Point":
        if isinstance(data, tuple):
            x, y = data
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64)
            valid = ~(np.isnan(x) | np.isnan(y))
            return PointColumn(name, x, y, valid)
        xs = np.full(n, np.nan)
        ys = np.full(n, np.nan)
        for i, g in enumerate(data):
            if g is None:
                continue
            p = g if isinstance(g, Point) else parse_wkt(str(g))
            xs[i], ys[i] = p.x, p.y  # type: ignore[union-attr]
        return PointColumn(name, xs, ys, ~np.isnan(xs))
    if spec_type in ("String", "UUID"):
        return StringColumn.from_strings(name, data)
    if spec_type == "Date":
        arr = np.asarray(data)
        if arr.dtype.kind == "M":
            millis = arr.astype("datetime64[ms]").astype(np.int64)
            valid = ~np.isnat(arr)
        elif arr.dtype == object:
            valid = np.array([v is not None for v in arr], dtype=bool)
            millis = np.array(
                [int(np.datetime64(v, "ms").astype(np.int64)) if v is not None
                 else 0 for v in arr], dtype=np.int64)
        else:
            millis = arr.astype(np.int64)
            valid = np.ones(n, dtype=bool)
        return DateColumn(name, millis, valid)
    if spec_type == "Boolean":
        arr = np.asarray(data)
        if arr.dtype == object:
            valid = np.array([v is not None for v in arr], dtype=bool)
            vals = np.array([bool(v) for v in np.where(valid, arr, False)],
                            dtype=bool)
        else:
            vals = arr.astype(bool)
            valid = np.ones(n, dtype=bool)
        return BoolColumn(name, vals, valid)
    if spec_type in ("Integer", "Long", "Float", "Double"):
        dtype = np.float64 if spec_type in ("Double", "Float") else np.int64
        arr = np.asarray(data)
        if arr.dtype == object:
            valid = np.array([v is not None for v in arr], dtype=bool)
            vals = np.array([v if v is not None else 0 for v in arr],
                            dtype=dtype)
        else:
            vals = arr.astype(dtype)
            valid = (~np.isnan(arr) if arr.dtype.kind == "f"
                     else np.ones(n, dtype=bool))
        return NumericColumn(name, vals, valid)
    raise NotImplementedError(
        f"{spec_type} columns belong to a later slice of the PyTorch port "
        f"(ROADMAP.md section 6); it stores the types {sorted(COLUMN_TYPES)}")


class FeatureBatch:
    """A batch of features: ids + one column per schema attribute."""

    def __init__(self, sft: SimpleFeatureType, ids: np.ndarray,
                 columns: dict[str, Column]):
        self.sft = sft
        self.ids = np.asarray(ids, dtype=object)
        self.columns = columns
        ns = {c.n for c in columns.values()} | {len(self.ids)}
        if len(ns) > 1:
            raise ValueError(f"column length mismatch: {ns}")

    @property
    def n(self) -> int:
        return len(self.ids)

    def __len__(self) -> int:
        return self.n

    def col(self, name: str) -> Column:
        return self.columns[name]

    @classmethod
    def from_dict(cls, sft: SimpleFeatureType, ids,
                  data: dict[str, Any]) -> "FeatureBatch":
        """Build from {attribute: array-like}; Point columns accept a
        (x_array, y_array) tuple or an iterable of Point/WKT."""
        columns = {}
        for a in sft.attributes:
            if a.name not in data:
                raise KeyError(f"missing column: {a.name}")
            columns[a.name] = _column_for(a.type.name, a.name, data[a.name])
        return cls(sft, np.asarray(ids, dtype=object), columns)

    def take(self, idx) -> "FeatureBatch":
        idx = np.asarray(idx)
        return FeatureBatch(self.sft, self.ids[idx],
                            {k: c.take(idx) for k, c in self.columns.items()})

    def feature(self, i: int) -> dict[str, Any]:
        """Row view (for result iteration / debugging)."""
        out = {"id": self.ids[i]}
        for name, c in self.columns.items():
            out[name] = c.value(i)
        return out

    def concat(self, other: "FeatureBatch") -> "FeatureBatch":
        return FeatureBatch.concat_all([self, other])

    @classmethod
    def concat_all(cls, batches: list["FeatureBatch"]) -> "FeatureBatch":
        """Single-pass multi-way concatenation: each column is copied
        once and string vocabs merge with one np.unique."""
        if not batches:
            raise ValueError("nothing to concatenate")
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        for b in batches[1:]:
            if b.sft != first.sft:
                raise ValueError("schema mismatch")
        cols: dict[str, Column] = {}
        for name, c in first.columns.items():
            parts = [b.columns[name] for b in batches]
            if isinstance(c, StringColumn):
                # one vocab merge: re-unique all vocabs, remap each code
                # array through its inverse segment, keep -1 nulls
                sizes = [len(p.vocab) for p in parts]
                vocab, inverse = np.unique(
                    np.concatenate([p.vocab for p in parts]).astype(str),
                    return_inverse=True)
                offs = np.cumsum([0] + sizes)
                codes = [
                    np.where(p.codes >= 0,
                             inverse[offs[i]:offs[i + 1]][
                                 np.maximum(p.codes, 0)], -1)
                    for i, p in enumerate(parts)]
                cols[name] = StringColumn(
                    name, np.concatenate(codes).astype(np.int32),
                    vocab.astype(object))
            elif isinstance(c, PointColumn):
                cols[name] = PointColumn(
                    name, np.concatenate([p.x for p in parts]),
                    np.concatenate([p.y for p in parts]),
                    np.concatenate([p.valid for p in parts]))
            elif isinstance(c, DateColumn):
                cols[name] = DateColumn(
                    name, np.concatenate([p.millis for p in parts]),
                    np.concatenate([p.valid for p in parts]))
            else:
                cols[name] = type(c)(
                    name, np.concatenate([p.values for p in parts]),
                    np.concatenate([p.valid for p in parts]))
        return FeatureBatch(first.sft,
                            np.concatenate([b.ids for b in batches]), cols)
