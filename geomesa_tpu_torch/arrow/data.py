"""ArrowDataStore: queryable Arrow IPC files (arrow/data/ArrowDataStore.scala
analog). An Arrow file (written by FeatureArrowFileWriter or any producer
following the SFT-metadata convention) loads into an in-memory store on
``device`` (CUDA unless the caller passes another) and serves the full
query surface; writes append via re-encode.
"""

from __future__ import annotations

import os

from ..features.batch import FeatureBatch
from ..index.api import Query
from .io import FeatureArrowFileReader, FeatureArrowFileWriter

__all__ = ["ArrowDataStore"]


class ArrowDataStore:
    def __init__(self, path: str, device=None):
        self.path = path
        self.device = device
        self._mem = None
        self._sft = None

    # -- schema ------------------------------------------------------------

    def get_schema(self):
        self._ensure()
        return self._sft

    def create_schema(self, sft):
        """Initialize an empty arrow file for the type."""
        with open(self.path, "wb") as fh:
            FeatureArrowFileWriter(fh, sft).close()
        self._mem, self._sft = None, None

    # -- io ---------------------------------------------------------------

    def _ensure(self):
        if self._mem is not None:
            return
        from ..store.memory import InMemoryDataStore
        with open(self.path, "rb") as fh:
            r = FeatureArrowFileReader(fh)
            self._sft = r.sft
            mem = InMemoryDataStore(device=self.device)
            mem.create_schema(r.sft)
            for b in r.batches():
                mem.write(r.sft.type_name, b)
        self._mem = mem

    def write(self, batch: FeatureBatch):
        """Append features (rewrites the file — arrow files are immutable
        once sealed, matching the reference's append-by-rewrite)."""
        self._ensure()
        self._mem.write(self._sft.type_name, batch)
        res = self._mem.query(Query(self._sft.type_name, "INCLUDE"))
        with open(self.path, "wb") as fh:
            w = FeatureArrowFileWriter(fh, self._sft)
            if res.batch is not None and res.batch.n:
                w.write(res.batch)
            w.close()

    # -- queries -----------------------------------------------------------

    def query(self, ecql: str = "INCLUDE", **kw):
        self._ensure()
        return self._mem.query(Query(self._sft.type_name, ecql), **kw)

    def count(self) -> int:
        self._ensure()
        return self._mem.count(self._sft.type_name)

    @property
    def exists(self) -> bool:
        return os.path.exists(self.path)
