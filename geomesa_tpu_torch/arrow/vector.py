"""Typed per-attribute Arrow vectors (SimpleFeatureVector analog).

The reference's core Arrow abstraction is a fixed-capacity vector of
features with one typed reader/writer per attribute
(geomesa-arrow/.../vector/SimpleFeatureVector.scala:35-93,
ArrowAttributeReader/Writer, ArrowDictionary.scala:133): points store
as fixed-size-list doubles with configurable precision, strings
dictionary-encode against explicit dictionaries that can grow in
deltas, and features read zero-copy through a facade over the vectors.

This is the same surface over pyarrow (other geometries than points
as WKB binary): ``SimpleFeatureVector`` owns a
set of ``ArrowAttributeWriter``s (or wraps a RecordBatch with
``ArrowAttributeReader``s), ``ArrowDictionary`` carries the explicit
value <-> code mapping with delta growth, and ``ArrowFeature``
(arrow/feature.py) stays the zero-copy row facade.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..features.sft import SimpleFeatureType
from ..geometry import Geometry, Point

__all__ = ["ArrowDictionary", "ArrowAttributeWriter",
           "ArrowAttributeReader", "SimpleFeatureVector",
           "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 8096  # SimpleFeatureVector.scala:98


class ArrowDictionary:
    """Explicit dictionary: value <-> code with delta growth
    (ArrowDictionary.scala:133 — dictionaries are immutable snapshots
    on the wire; deltas append new values without re-coding old ones).
    """

    def __init__(self, values=()):
        self._values: list = []
        self._codes: dict = {}
        self.add_all(values)

    def __len__(self) -> int:
        return len(self._values)

    @property
    def values(self) -> list:
        return list(self._values)

    def code(self, value) -> int:
        """Code for value, growing the dictionary when unseen."""
        c = self._codes.get(value)
        if c is None:
            c = len(self._values)
            self._values.append(value)
            self._codes[value] = c
        return c

    def lookup(self, value) -> int:
        """Code for value or -1 (no growth) — the read-side probe."""
        return self._codes.get(value, -1)

    def value(self, code: int):
        return self._values[code]

    def add_all(self, values) -> list:
        return [self.code(v) for v in values]

    def delta_since(self, n: int) -> list:
        """Values appended after the first ``n`` (the wire delta)."""
        return self._values[n:]


# -- typed writers ---------------------------------------------------------

class ArrowAttributeWriter:
    """One attribute's typed write surface into a fixed-capacity
    vector; ``apply(i, value)`` then ``to_arrow()``."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity

    def apply(self, i: int, value) -> None:
        raise NotImplementedError

    def to_arrow(self, n: int):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class _NumericWriter(ArrowAttributeWriter):
    np_dtype: Any = np.float64

    def __init__(self, name: str, capacity: int):
        super().__init__(name, capacity)
        self._vals = np.zeros(capacity, dtype=self.np_dtype)
        self._valid = np.zeros(capacity, dtype=bool)

    def apply(self, i: int, value) -> None:
        if value is None:
            self._valid[i] = False
        else:
            self._vals[i] = value
            self._valid[i] = True

    def to_arrow(self, n: int):
        import pyarrow as pa
        # COPY: pyarrow zero-copies numeric numpy buffers, and the
        # writer's buffers keep mutating after unload()
        return pa.array(self._vals[:n].copy(), mask=~self._valid[:n])

    def reset(self) -> None:
        self._valid[:] = False


class IntWriter(_NumericWriter):
    np_dtype = np.int32


class LongWriter(_NumericWriter):
    np_dtype = np.int64


class FloatWriter(_NumericWriter):
    np_dtype = np.float32


class DoubleWriter(_NumericWriter):
    np_dtype = np.float64


class BooleanWriter(_NumericWriter):
    np_dtype = np.bool_


class DateWriter(_NumericWriter):
    """Epoch millis as timestamp[ms]."""
    np_dtype = np.int64

    def to_arrow(self, n: int):
        import pyarrow as pa
        return pa.array(self._vals[:n].copy(), mask=~self._valid[:n],
                        type=pa.timestamp("ms"))


class StringWriter(ArrowAttributeWriter):
    """Dictionary-encoded strings against an EXPLICIT (shareable,
    delta-growable) ArrowDictionary."""

    def __init__(self, name: str, capacity: int,
                 dictionary: ArrowDictionary | None = None):
        super().__init__(name, capacity)
        self.dictionary = dictionary if dictionary is not None \
            else ArrowDictionary()
        self._codes = np.full(capacity, -1, dtype=np.int32)

    def apply(self, i: int, value) -> None:
        self._codes[i] = -1 if value is None \
            else self.dictionary.code(str(value))

    def to_arrow(self, n: int):
        import pyarrow as pa
        codes = self._codes[:n].copy()  # buffers mutate after unload
        return pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=codes < 0, type=pa.int32()),
            pa.array(self.dictionary.values, type=pa.string()))

    def reset(self) -> None:
        self._codes[:] = -1


class PointWriter(ArrowAttributeWriter):
    """Points as a fixed-size-list of 2 floats; ``precision`` selects
    f32 or f64 storage (the reference's precision-configurable point
    vectors)."""

    def __init__(self, name: str, capacity: int, precision: str = "f64"):
        super().__init__(name, capacity)
        if precision not in ("f32", "f64"):
            raise ValueError("precision must be 'f32' or 'f64'")
        self.precision = precision
        dt = np.float32 if precision == "f32" else np.float64
        self._xy = np.full((capacity, 2), np.nan, dtype=dt)

    def apply(self, i: int, value) -> None:
        if value is None:
            self._xy[i] = np.nan
        elif isinstance(value, Point):
            self._xy[i, 0] = value.x
            self._xy[i, 1] = value.y
        else:
            self._xy[i, 0], self._xy[i, 1] = value

    def to_arrow(self, n: int):
        import pyarrow as pa
        dt = pa.float32() if self.precision == "f32" else pa.float64()
        flat = pa.array(self._xy[:n].copy().ravel(), type=dt)
        return pa.FixedSizeListArray.from_arrays(flat, 2)

    def reset(self) -> None:
        self._xy[:] = np.nan


class GeometryWriter(ArrowAttributeWriter):
    """Any other geometry as WKB binary (``geometry/wkb.py``)."""

    def __init__(self, name: str, capacity: int):
        super().__init__(name, capacity)
        self._wkb: list = [None] * capacity

    def apply(self, i: int, value) -> None:
        from ..geometry.wkb import to_wkb
        self._wkb[i] = None if value is None else (
            to_wkb(value) if isinstance(value, Geometry) else bytes(value))

    def to_arrow(self, n: int):
        import pyarrow as pa
        return pa.array(list(self._wkb[:n]), type=pa.binary())

    def reset(self) -> None:
        self._wkb = [None] * self.capacity


_WRITERS = {
    "Integer": IntWriter,
    "Long": LongWriter,
    "Float": FloatWriter,
    "Double": DoubleWriter,
    "Boolean": BooleanWriter,
    "Date": DateWriter,
    "String": StringWriter,
    "Point": PointWriter,
}


def writer_for(attr, capacity: int, precision: str = "f64",
               dictionaries: dict | None = None) -> ArrowAttributeWriter:
    t = attr.type.name
    if t == "String":
        d = (dictionaries or {}).get(attr.name)
        return StringWriter(attr.name, capacity, d)
    if t == "Point":
        return PointWriter(attr.name, capacity, precision)
    cls = _WRITERS.get(t)
    if cls is not None:
        return cls(attr.name, capacity)
    if getattr(attr.type, "is_geometry", False):
        return GeometryWriter(attr.name, capacity)
    raise ValueError(f"no Arrow vector writer for attribute type "
                     f"{t!r} ({attr.name!r})")


# -- typed readers ---------------------------------------------------------

class ArrowAttributeReader:
    """One attribute's typed read surface over an arrow array — THE
    decode logic for every supported layout (ArrowFeature delegates
    here; there must never be a second copy to drift).

    Layouts: fixed-size-list [x, y] and struct {"x", "y"} points, WKB
    binary and WKT string geometries, timestamp[ms] dates, dictionary
    strings, plain scalars. ``attr`` (an SFT attribute) disambiguates
    WKT geometry strings from plain strings."""

    def __init__(self, name: str, arr, attr=None):
        self.name = name
        self.arr = arr
        self.attr = attr

    def apply(self, i: int):
        import pyarrow as pa
        v = self.arr[i]
        if not v.is_valid:
            return None
        t = self.arr.type
        if pa.types.is_fixed_size_list(t):
            xy = v.as_py()
            return None if xy is None or any(
                x is None or x != x for x in xy) else Point(*xy)
        if pa.types.is_struct(t):
            d = v.as_py()
            if d is None or d.get("x") is None:
                return None
            x, y = d["x"], d["y"]
            return None if x != x or y != y else Point(x, y)
        if pa.types.is_binary(t):
            from ..geometry.wkb import from_wkb
            return from_wkb(v.as_py())
        if pa.types.is_timestamp(t):
            return int(v.value)
        if (self.attr is not None
                and getattr(self.attr.type, "is_geometry", False)
                and (pa.types.is_string(t)
                     or (pa.types.is_dictionary(t)
                         and pa.types.is_string(t.value_type)))):
            from ..geometry.wkt import parse_wkt
            return parse_wkt(v.as_py())
        return v.as_py()

    def __len__(self):
        return len(self.arr)


class SimpleFeatureVector:
    """Fixed-capacity vector of features with typed per-attribute
    readers/writers (SimpleFeatureVector.scala:35-93).

    Write side::

        v = SimpleFeatureVector.create(sft, capacity=1024)
        v.set(0, "fid0", {"name": "x", "geom": Point(1, 2)})
        rb = v.unload()         # pyarrow RecordBatch (n = writes)

    Read side::

        v = SimpleFeatureVector.wrap(sft, rb)
        v.reader("name").apply(0)
        v.feature(0)            # zero-copy row facade
    """

    def __init__(self, sft: SimpleFeatureType, capacity: int,
                 writers=None, batch=None):
        self.sft = sft
        self.capacity = capacity
        self._writers = writers
        self._ids = ([None] * capacity) if writers is not None else None
        self._n = 0
        self._batch = batch
        self._readers: dict[str, ArrowAttributeReader] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, sft: SimpleFeatureType,
               capacity: int = DEFAULT_CAPACITY, precision: str = "f64",
               dictionaries: dict | None = None) -> "SimpleFeatureVector":
        writers = {a.name: writer_for(a, capacity, precision,
                                      dictionaries)
                   for a in sft.attributes}
        return cls(sft, capacity, writers=writers)

    @classmethod
    def wrap(cls, sft: SimpleFeatureType, batch) -> "SimpleFeatureVector":
        return cls(sft, batch.num_rows, batch=batch)

    # -- write side --------------------------------------------------------

    def writer(self, name: str) -> ArrowAttributeWriter:
        return self._writers[name]

    def set(self, i: int, fid: str, values: dict) -> None:
        if i >= self.capacity:
            raise IndexError("vector capacity exceeded")
        self._ids[i] = str(fid)
        for name, w in self._writers.items():
            w.apply(i, values.get(name))
        self._n = max(self._n, i + 1)

    def unload(self):
        """The written rows as a pyarrow RecordBatch (__fid__ first,
        like the file format)."""
        import pyarrow as pa
        n = self._n
        arrays = [pa.array(self._ids[:n], type=pa.string())]
        names = ["__fid__"]
        for name, w in self._writers.items():
            arrays.append(w.to_arrow(n))
            names.append(name)
        return pa.RecordBatch.from_arrays(arrays, names=names)

    def reset(self) -> None:
        """Clear for refill: sparse refills must never re-emit the
        previous batch's rows."""
        self._n = 0
        if self._ids is not None:
            self._ids = [None] * self.capacity
        for w in (self._writers or {}).values():
            w.reset()

    # -- read side ---------------------------------------------------------

    @property
    def n(self) -> int:
        return self._batch.num_rows if self._batch is not None else self._n

    def reader(self, name: str) -> ArrowAttributeReader:
        if name not in self._readers:
            if self._batch is None:
                raise ValueError("write-mode vector has no readers; "
                                 "unload() and wrap() first")
            self._readers[name] = ArrowAttributeReader(
                name, self._batch.column(name),
                attr=self.sft.attr(name))
        return self._readers[name]

    def ids(self) -> np.ndarray:
        return np.asarray(self._batch.column("__fid__").to_pylist(),
                          dtype=object)

    def feature(self, i: int):
        from .feature import ArrowFeature
        return ArrowFeature(self.sft, self._batch, i)
