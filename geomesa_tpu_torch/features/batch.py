"""Columnar feature model: struct-of-arrays batches on the host.

One numpy array per attribute with a validity mask: point coordinates
as float64 x/y pairs, dates as epoch millis, strings dictionary-encoded,
numbers as int64 (Integer, Long) or float64 (Float, Double; a NaN reads
as null), booleans as bool. The in-memory store builds its device
columns (two-float coordinates, (day, ms) times, the residual's split
attribute columns) from these.

Any other geometry (LineString, Polygon, the multi-part types, a
collection, or the generic Geometry) is a GeometryColumn: the geometry
objects beside their (n, 4) float64 bounding boxes, NaN for a null.

``to_arrow``/``from_arrow`` convert a batch to and from a pyarrow
RecordBatch (pyarrow imported when they are called).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Iterable

import numpy as np

from ..geometry import Geometry, Point, parse_wkt
from .sft import SimpleFeatureType

__all__ = ["FeatureBatch", "Column", "NumericColumn", "BoolColumn",
           "DateColumn", "StringColumn", "PointColumn", "GeometryColumn",
           "COLUMN_TYPES", "EXTENT_TYPES"]

# the geometry types stored as a GeometryColumn
EXTENT_TYPES = frozenset({"LineString", "Polygon", "MultiPoint",
                          "MultiLineString", "MultiPolygon",
                          "GeometryCollection", "Geometry"})
# the attribute types this port stores (String and UUID share one column)
COLUMN_TYPES = frozenset({"Point", "String", "UUID", "Date", "Boolean",
                          "Integer", "Long", "Float", "Double"}) | EXTENT_TYPES
# the attribute types whose Arrow columns without nulls decode as numpy
_NUMPY_TYPES = frozenset({"Integer", "Long", "Float", "Double", "Boolean"})


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

    @classmethod
    def from_arrow(cls, name: str, arr) -> "StringColumn":
        """From a pyarrow string array: dictionary-encode in C, then
        remap the codes to the sorted-vocab order that ``code_of``'s
        searchsorted needs (sorting the vocab, not the rows). The
        vocabulary and codes equal ``from_strings``' on the same values;
        an array with nulls or of another type goes through it."""
        import pyarrow as pa
        if pa.types.is_dictionary(arr.type):
            if (not arr.null_count and not arr.dictionary.null_count
                    and (pa.types.is_string(arr.type.value_type)
                         or pa.types.is_large_string(arr.type.value_type))):
                return cls._from_dictionary(name, arr)
            arr = arr.dictionary_decode()
        if arr.null_count or not (pa.types.is_string(arr.type)
                                  or pa.types.is_large_string(arr.type)):
            return cls.from_strings(
                name, np.asarray(arr.to_numpy(zero_copy_only=False),
                                 dtype=object))
        d = arr.dictionary_encode()
        codes = np.asarray(d.indices.to_numpy(zero_copy_only=False),
                           dtype=np.int32)
        vocab = np.asarray(d.dictionary.to_numpy(zero_copy_only=False),
                           dtype=object)
        order = np.argsort(vocab)
        inv = np.empty(len(order), dtype=np.int32)
        inv[order] = np.arange(len(order), dtype=np.int32)
        return cls(name, inv[codes], vocab[order])

    @classmethod
    def _from_dictionary(cls, name: str, arr) -> "StringColumn":
        """A dictionary array (``to_arrow``'s string layout) by its
        indices: the dictionary entries some row uses, sorted and
        deduplicated, become the vocabulary; the rows are not decoded."""
        idx = arr.indices.to_numpy(zero_copy_only=False)
        entries = np.asarray(arr.dictionary.to_numpy(zero_copy_only=False),
                             dtype=object)
        used = np.zeros(len(entries), dtype=bool)
        used[idx] = True
        kept = np.flatnonzero(used)
        vocab, of_kept = np.unique(entries[kept].astype(str),
                                   return_inverse=True)
        remap = np.zeros(len(entries), dtype=np.int32)
        remap[kept] = of_kept.ravel()
        return cls(name, remap[idx], vocab.astype(object))


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


@dataclasses.dataclass
class GeometryColumn(Column):
    """Any geometries: the host objects and their cached bounding boxes,
    (n, 4) float64 [xmin ymin xmax ymax], NaN for a null or empty one."""
    name: str
    geoms: list  # list[Geometry | None]
    bounds: np.ndarray

    @property
    def n(self) -> int:
        return len(self.geoms)

    @property
    def valid(self) -> np.ndarray:  # type: ignore[override]
        return ~np.isnan(self.bounds[:, 0])

    def take(self, idx) -> "GeometryColumn":
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return GeometryColumn(self.name, [self.geoms[i] for i in idx],
                              self.bounds[idx])

    def value(self, i: int):
        return self.geoms[i]

    @classmethod
    def from_geoms(cls, name: str, geoms: Iterable) -> "GeometryColumn":
        """From Geometry objects, WKT strings or None."""
        gl = [g if g is None or isinstance(g, Geometry) else parse_wkt(str(g))
              for g in geoms]
        bounds = np.full((len(gl), 4), np.nan)
        for i, g in enumerate(gl):
            if g is not None and not g.is_empty:
                e = g.envelope
                bounds[i] = (e.xmin, e.ymin, e.xmax, e.ymax)
        return cls(name, gl, bounds)


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
    if spec_type in EXTENT_TYPES:
        return GeometryColumn.from_geoms(name, data)
    if spec_type in ("String", "UUID"):
        # an Arrow array (the vectorized converter's, a Parquet or IPC
        # column) dictionary-encodes in C; pyarrow is loaded if one exists
        pa = sys.modules.get("pyarrow")
        if pa is not None and isinstance(data, (pa.Array, pa.ChunkedArray)):
            if isinstance(data, pa.ChunkedArray):
                data = data.combine_chunks()
            return StringColumn.from_arrow(name, data)
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
    # List, Map and Bytes: a schema may declare them, but no column
    # stores them (the JAX package's _column_for refuses them with the same
    # type); the SFB codec serializes their values one feature at a time
    raise ValueError(
        f"cannot build a {spec_type} column ({name!r}): the store keeps "
        f"the types {sorted(COLUMN_TYPES)}")


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
            elif isinstance(c, GeometryColumn):
                cols[name] = GeometryColumn(
                    name, [g for p in parts for g in p.geoms],
                    np.concatenate([p.bounds for p in parts]))
            else:
                cols[name] = type(c)(
                    name, np.concatenate([p.values for p in parts]),
                    np.concatenate([p.valid for p in parts]))
        return FeatureBatch(first.sft,
                            np.concatenate([b.ids for b in batches]), cols)

    # -- arrow interchange ------------------------------------------------

    def to_arrow(self):
        """The batch as a pyarrow RecordBatch: ``__fid__`` first, points
        as {x, y} structs, other geometries as WKT strings, strings
        dictionary-encoded, dates as timestamp[ms]. Needs pyarrow
        (imported here)."""
        import pyarrow as pa

        from ..geometry.wkt import to_wkt
        # ids and vocabularies from str objects: pyarrow converts a numpy
        # unicode array of more than about 2M rows into a ChunkedArray,
        # which a RecordBatch refuses
        arrays = [pa.array(list(map(str, self.ids)), type=pa.string())]
        names = ["__fid__"]
        for a in self.sft.attributes:
            c = self.columns[a.name]
            names.append(a.name)
            if isinstance(c, PointColumn):
                arrays.append(pa.StructArray.from_arrays(
                    [pa.array(c.x), pa.array(c.y)], ["x", "y"]))
            elif isinstance(c, GeometryColumn):
                arrays.append(pa.array(
                    [to_wkt(g) if g is not None else None for g in c.geoms],
                    type=pa.string()))
            elif isinstance(c, StringColumn):
                null = c.codes < 0
                arrays.append(pa.DictionaryArray.from_arrays(
                    np.where(null, 0, c.codes).astype(np.int32),
                    pa.array(list(map(str, c.vocab)), type=pa.string()),
                    mask=null))
            elif isinstance(c, DateColumn):
                arrays.append(pa.array(
                    np.where(c.valid, c.millis, 0), type=pa.timestamp("ms"),
                    mask=~c.valid))
            else:
                arrays.append(pa.array(c.values, mask=~c.valid))
        return pa.RecordBatch.from_arrays(arrays, names)

    @classmethod
    def from_arrow(cls, sft: SimpleFeatureType, rb) -> "FeatureBatch":
        """A batch from a pyarrow RecordBatch in ``to_arrow``'s layout.
        Columns equal the JAX package's ``from_arrow``: strings through
        ``StringColumn.from_arrow``, numbers and booleans without nulls
        as numpy arrays, the rest as Python values."""
        import pyarrow as pa
        # str objects straight from the column (to_pylist builds a
        # scalar a row first, about 17x slower)
        ids = np.asarray(rb.column("__fid__").to_numpy(zero_copy_only=False),
                         dtype=object)
        data: dict[str, Any] = {}
        for a in sft.attributes:
            col = rb.column(a.name)
            if a.type.name == "Point":
                flat = col.flatten()
                data[a.name] = (np.asarray(flat[0]), np.asarray(flat[1]))
            elif a.type.name == "Date":
                # datetime64 with NaT for a null
                data[a.name] = col.to_numpy(zero_copy_only=False)
            elif a.type.name in ("String", "UUID"):
                data[a.name] = col          # StringColumn.from_arrow
            elif (a.type.name in _NUMPY_TYPES and not col.null_count
                  and not pa.types.is_dictionary(col.type)):
                data[a.name] = col.to_numpy(zero_copy_only=False)
            else:
                data[a.name] = col.to_pylist()
        return cls.from_dict(sft, ids, data)
