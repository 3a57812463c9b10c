"""ArrowScan: Arrow-encoded query results + distributed dictionary-delta
merge.

The reference runs ArrowScan inside the database servers -- each
tablet/region emits dictionary-encoded record batches whose dictionaries
are *local deltas*, merged client-side (index-api ArrowScan:34 +
arrow/io/DeltaWriter.scala:47,203). Here each partial result is an IPC
payload with its own dictionaries; ``merge_deltas`` unifies the
dictionaries and re-encodes codes -- host-side numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType
from .io import sort_batches, write_ipc

__all__ = ["ArrowScan", "merge_deltas"]


class ArrowScan:
    """Produce Arrow IPC bytes from a query over a datastore.

    Usage mirrors the ARROW_ENCODE query-hint path
    (AccumuloIndexAdapter.scanConfig arrow branch):

        payload = ArrowScan(store).execute(type_name, ecql,
                                           sort_by="dtg")
    """

    def __init__(self, store):
        self.store = store

    def execute(self, type_name: str, ecql: str = "INCLUDE",
                sort_by: str | None = None, reverse: bool = False,
                batch_size: int | None = None) -> bytes:
        from ..index.api import Query
        res = self.store.query(Query(type_name, ecql))
        sft = self.store.get_schema(type_name)
        batch = res.batch
        if batch is None:
            batch = FeatureBatch.from_dict(
                sft, np.empty(0, dtype=object),
                {a.name: ((np.empty(0), np.empty(0))
                          if a.type.name == "Point" else [])
                 for a in sft.attributes})
        if sort_by:
            batch = sort_batches(batch, sort_by, reverse)
        kw = {} if batch_size is None else {"batch_size": batch_size}
        return write_ipc(sft, batch, **kw)


def merge_deltas(payloads: Sequence[bytes],
                 sft: SimpleFeatureType | None = None,
                 sort_by: str | None = None,
                 presorted: bool = False) -> bytes:
    """Merge shard-local IPC payloads into one payload with unified
    dictionaries (DeltaWriter.reduce analog) — as a *stream*: payloads
    decode batch-at-a-time and feed an incremental writer, never
    concatenating the full result set (the old eager reduce held every
    shard's rows at once).

    ``presorted`` declares each payload already sorted on ``sort_by``
    (the mesh shards emit sorted payloads): the reduce is then a k-way
    streaming merge holding one in-flight batch per payload. Without
    it, each payload is sorted individually as it is first pulled —
    still never the union.
    """
    from .delta import (empty_batch, iter_ipc, merge_sorted_streams,
                        slice_batches)
    sources = []
    out_sft = sft
    for p in payloads:
        s, it = iter_ipc(p, sft)
        out_sft = out_sft or s
        sources.append(it)
    if out_sft is None:
        raise ValueError("no payloads")
    if sort_by and not presorted:
        def _sorted(it):
            parts = [b for b in it if b.n]
            if parts:
                whole = (parts[0] if len(parts) == 1
                         else FeatureBatch.concat_all(parts))
                yield from slice_batches(sort_batches(whole, sort_by))
        sources = [_sorted(it) for it in sources]
    merged = merge_sorted_streams(sources, sort_by or None)
    import io as _io
    sink = _io.BytesIO()
    from .io import FeatureArrowFileWriter
    wrote = False
    with FeatureArrowFileWriter(sink, out_sft) as w:
        for b in merged:
            w.write(b)
            wrote = True
    if not wrote:
        return write_ipc(out_sft, empty_batch(out_sft))
    return sink.getvalue()
