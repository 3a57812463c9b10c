"""Batch jobs: input splits + parallel map over a datastore
(geomesa-jobs analog — GeoMesaAccumuloInputFormat.scala:45,163 turns a
query plan into input splits; GeoMesaOutputFormat.scala:29 writes
features; jobs/accumulo/index/ has AttributeIndexJob / SchemaCopyJob;
tools ConverterIngestJob is the distributed ingest).

Here a "split" is a unit the host can process independently — a file
list, a partition, or an index-range slab — and workers are a thread
pool (the JVM's M/R cluster collapses to host threads feeding one card;
multi-host would fan splits over controller processes).

A pool thread runs with its caller's current CUDA device, and the jobs
below run their splits on the card of the store they write (torch keeps
the current device per thread, and a new thread starts on device 0).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from ..index.api import Query
from ..utils.device import cuda_index, device_scope

__all__ = ["InputSplit", "query_splits", "fs_partition_splits", "run_job",
           "ConverterIngestJob", "SchemaCopyJob", "AttributeIndexJob"]


@dataclasses.dataclass
class InputSplit:
    """One independently-processable unit (mapreduce InputSplit)."""
    index: int
    payload: Any          # files, partition name, (lo, hi) row slice, ...
    kind: str = "generic"


def query_splits(store, type_name: str, ecql: str = "INCLUDE",
                 n_splits: int = 8) -> list[InputSplit]:
    """Row-range splits of a query result (the QueryPlan->ranges->splits
    path of GeoMesaAccumuloInputFormat, collapsed to row slabs)."""
    res = store.query(Query(type_name, ecql))
    n = 0 if res.batch is None else res.batch.n
    if n == 0:
        return []
    bounds = np.linspace(0, n, min(n_splits, n) + 1).astype(int)
    return [InputSplit(i, (res.batch, int(bounds[i]), int(bounds[i + 1])),
                       "rows")
            for i in range(len(bounds) - 1) if bounds[i + 1] > bounds[i]]


def fs_partition_splits(fs_store, type_name: str) -> list[InputSplit]:
    """One split per fs-store partition (ParquetConverterJob shape)."""
    return [InputSplit(i, p, "partition")
            for i, p in enumerate(fs_store.partitions(type_name))]


def run_job(map_fn: Callable[[InputSplit], Any],
            splits: Sequence[InputSplit], n_workers: int = 4,
            reduce_fn: Callable[[list], Any] | None = None):
    """Map splits in parallel, optionally reduce. Errors propagate. Each
    split runs with the caller's current CUDA device as its thread's."""
    if not splits:
        return reduce_fn([]) if reduce_fn else []
    index = (torch.cuda.current_device() if torch.cuda.is_initialized()
             else None)

    def _run(split):
        with device_scope(index):
            return map_fn(split)

    with ThreadPoolExecutor(max_workers=min(n_workers, len(splits))) as ex:
        results = list(ex.map(_run, splits))
    return reduce_fn(results) if reduce_fn else results


class ConverterIngestJob:
    """Parallel file ingest through a converter into a store
    (tools/ingest ConverterIngestJob analog; local threads instead of
    mappers). Thread-safe: each worker converts independently, writes
    serialize on a lock (the store's write path is host-side append)."""

    def __init__(self, store, sft, converter_config: dict,
                 n_workers: int = 4):
        from ..convert.converter import converter_for
        self.store = store
        self.sft = sft
        self.config = converter_config
        self.n_workers = n_workers
        self._lock = threading.Lock()
        self._converter_for = converter_for

    def run(self, files: Iterable[str]) -> dict:
        if self.sft.type_name not in self.store.get_type_names():
            self.store.create_schema(self.sft)
        counts = {"success": 0, "failure": 0, "files": 0}
        index = cuda_index(self.store)

        def _map(split: InputSplit):
            conv = self._converter_for(self.sft, self.config)
            with open(split.payload) as fh:
                batch, ctx = conv.process(fh)
            with self._lock, device_scope(index):
                if batch.n:
                    self.store.write(self.sft.type_name, batch)
                counts["success"] += ctx.success
                counts["failure"] += ctx.failure
                counts["files"] += 1
            return ctx

        run_job(_map, [InputSplit(i, f, "file")
                       for i, f in enumerate(files)], self.n_workers)
        return counts


class SchemaCopyJob:
    """Copy a type between stores, optionally filtered
    (jobs/accumulo/index/SchemaCopyJob analog)."""

    def __init__(self, source, dest, n_workers: int = 4):
        self.source = source
        self.dest = dest
        self.n_workers = n_workers
        self._lock = threading.Lock()

    def run(self, type_name: str, ecql: str = "INCLUDE") -> int:
        sft = self.source.get_schema(type_name)
        if type_name not in self.dest.get_type_names():
            self.dest.create_schema(sft)
        copied = [0]
        index = cuda_index(self.dest)

        def _map(split: InputSplit):
            batch, lo, hi = split.payload
            sub = batch.take(np.arange(lo, hi))
            with self._lock, device_scope(index):
                self.dest.write(type_name, sub)
                copied[0] += sub.n

        run_job(_map, query_splits(self.source, type_name, ecql),
                self.n_workers)
        return copied[0]


class AttributeIndexJob:
    """Backfill an attribute index over existing data
    (jobs/accumulo/index/AttributeIndexJob analog): recompute the
    store's index structures including the named attribute."""

    def __init__(self, store):
        self.store = store

    def run(self, type_name: str, attribute: str) -> int:
        st = self.store._state(type_name)
        attr = st.sft.attr(attribute)  # raises KeyError if absent
        attr.options["index"] = "true"
        st.dirty = True  # force index rebuild on next query
        return st.n
