"""Plain typed API without the query/filter machinery
(geomesa-native-api analog: api/GeoMesaIndex.java:23): query, insert and
delete of user values with a pluggable ValueSerializer, no GeoTools.

    idx = GeoMesaIndex.memory(PickleSerializer())   # a store on the card
    idx.insert("id1", my_obj, x=-75.0, y=38.0, dtg=millis)
    for v in idx.query(bbox=(-80, 35, -70, 40),
                       interval=(t0, t1)): ...

The values live serialized (hex) in a String attribute of a point
schema with a default date, so a query is the store's BBOX + time path:
``interval`` becomes ``dtg BETWEEN <ms> AND <ms>`` (unquoted epoch
milliseconds, inclusive at both ends).
"""

from __future__ import annotations

import json
import pickle
from typing import Any, Generic, Iterable, TypeVar

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import parse_spec
from ..index.api import Query
from ..store.memory import InMemoryDataStore

T = TypeVar("T")

__all__ = ["ValueSerializer", "PickleSerializer", "JsonSerializer",
           "GeoMesaIndex"]


class ValueSerializer(Generic[T]):
    """api/ValueSerializer: user value <-> bytes."""

    def to_bytes(self, value: T) -> bytes:
        raise NotImplementedError

    def from_bytes(self, data: bytes) -> T:
        raise NotImplementedError


class PickleSerializer(ValueSerializer[Any]):
    def to_bytes(self, value) -> bytes:
        return pickle.dumps(value)

    def from_bytes(self, data: bytes):
        return pickle.loads(data)


class JsonSerializer(ValueSerializer[Any]):
    def to_bytes(self, value) -> bytes:
        return json.dumps(value).encode()

    def from_bytes(self, data: bytes):
        return json.loads(data.decode())


_SPEC = ("payload:String,dtg:Date,*geom:Point:srid=4326;"
         "geomesa.index.dtg='dtg'")


class GeoMesaIndex(Generic[T]):
    """Spatio-temporal index of arbitrary values: the stable, GeoTools-free
    entry point (BaseBigTableIndex analog over the in-memory store).
    ``store=None`` builds an ``InMemoryDataStore`` on CUDA."""

    def __init__(self, serializer: ValueSerializer[T],
                 store=None, type_name: str = "values"):
        self.serializer = serializer
        self.type_name = type_name
        self.store = store if store is not None else InMemoryDataStore()
        if type_name not in self.store.get_type_names():
            self.store.create_schema(parse_spec(type_name, _SPEC))
        self._sft = self.store.get_schema(type_name)

    @classmethod
    def memory(cls, serializer: "ValueSerializer[T]",
               type_name: str = "values",
               device=None) -> "GeoMesaIndex[T]":
        """An index over a new ``InMemoryDataStore`` on ``device`` (None:
        CUDA, as the store's own default)."""
        return cls(serializer, InMemoryDataStore(device=device), type_name)

    # -- mutations ---------------------------------------------------------

    def insert(self, fid: str, value: T, x: float, y: float,
               dtg: int | None = None) -> str:
        self.insert_batch([fid], [value], [x], [y],
                          None if dtg is None else [dtg])
        return fid

    def insert_batch(self, fids: Iterable[str], values: Iterable[T],
                     x, y, dtg=None):
        vals = [self.serializer.to_bytes(v).hex() for v in values]
        n = len(vals)
        batch = FeatureBatch.from_dict(
            self._sft, list(fids),
            {"payload": vals,
             "dtg": np.zeros(n, dtype=np.int64) if dtg is None
             else np.asarray(list(dtg), dtype=np.int64),
             "geom": (np.asarray(x, dtype=np.float64),
                      np.asarray(y, dtype=np.float64))})
        self.store.write(self.type_name, batch)

    def delete(self, fid: str):
        self.store.delete(self.type_name, [fid])

    # -- queries -----------------------------------------------------------

    def query(self, bbox=None, interval=None, cql: str | None = None,
              with_ids: bool = False):
        """Values whose point is in bbox and time in interval."""
        clauses = []
        if bbox is not None:
            clauses.append(f"BBOX(geom, {bbox[0]}, {bbox[1]}, "
                           f"{bbox[2]}, {bbox[3]})")
        if interval is not None:
            clauses.append(f"dtg BETWEEN {int(interval[0])} "
                           f"AND {int(interval[1])}")
        if cql:
            clauses.append(cql)
        ecql = " AND ".join(clauses) if clauses else "INCLUDE"
        res = self.store.query(Query(self.type_name, ecql))
        out = []
        if res.batch is not None:
            col = res.batch.col("payload")
            for i in range(res.batch.n):
                v = self.serializer.from_bytes(bytes.fromhex(col.value(i)))
                out.append((str(res.batch.ids[i]), v) if with_ids else v)
        return out

    def get(self, fid: str) -> T | None:
        res = self.store.query(Query(self.type_name, f"IN ('{fid}')"))
        if res.batch is None or res.batch.n == 0:
            return None
        return self.serializer.from_bytes(
            bytes.fromhex(res.batch.col("payload").value(0)))

    def size(self) -> int:
        return self.store.count(self.type_name)
