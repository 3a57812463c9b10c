"""The DataStore contract of the port (the GeoTools DataStore SPI
analog): schema management, batch writes, and ``query`` (a ``Query`` in,
a ``QueryResult`` of ids and columns out)."""

from __future__ import annotations

import abc
from typing import Any, Iterator

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType
from ..index.api import Query

__all__ = ["DataStore"]


class DataStore(abc.ABC):
    """Pluggable datastore contract."""

    @abc.abstractmethod
    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        """Register a feature type (sft object, or name + spec string)."""

    @abc.abstractmethod
    def get_schema(self, type_name: str) -> SimpleFeatureType:
        """The schema for a type; KeyError if absent."""

    @abc.abstractmethod
    def get_type_names(self) -> list[str]:
        """All registered type names."""

    def remove_schema(self, type_name: str):
        """Drop a feature type and its data. Backends without a removal
        story say so explicitly rather than AttributeError."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support schema removal")

    @abc.abstractmethod
    def write(self, type_name: str, batch: FeatureBatch, **kwargs):
        """Append a feature batch."""

    def write_dict(self, type_name: str, ids, data: dict[str, Any],
                   **kwargs):
        """Convenience: build a batch from {attribute: array} and write."""
        self.write(type_name, FeatureBatch.from_dict(
            self.get_schema(type_name), ids, data), **kwargs)

    def write_many(self, type_name: str,
                   pairs: list[tuple[FeatureBatch, Any]]):
        """Group-commit: coalesce staged (batch, visibilities) pairs
        into ONE backend write. Returns the backend write's return
        value."""
        batches = [b for b, _ in pairs]
        if not batches:
            return None
        if len(batches) == 1:
            return self.write(type_name, batches[0],
                              visibilities=pairs[0][1])
        fused = FeatureBatch.concat_all(batches)
        if all(v is None for _, v in pairs):
            vis = None
        else:
            vis = np.concatenate([np.full(b.n, None, dtype=object)
                                  if v is None else np.asarray(v, dtype=object)
                                  for b, v in pairs])
        return self.write(type_name, fused, visibilities=vis)

    @abc.abstractmethod
    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None):
        """Run a query; returns a QueryResult. A string argument is ECQL
        and requires type_name."""

    @abc.abstractmethod
    def count(self, type_name: str) -> int:
        """Total stored features of a type."""

    def query_count(self, q: Query | str,
                    type_name: str | None = None) -> int:
        """Matching-feature count."""
        return self.query(q, type_name).n

    def features(self, type_name: str,
                 ecql: str = "INCLUDE") -> Iterator[dict]:
        """Iterate matching features as dicts (reader-style access)."""
        return self.query(ecql, type_name).features()
