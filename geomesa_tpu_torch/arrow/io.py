"""Arrow IPC file IO for feature batches.

Analog of the reference's SimpleFeatureArrowFileWriter/Reader and
SimpleFeatureArrowIO sort/merge (geomesa-arrow/.../io/): feature batches
stream to the Arrow IPC file format in fixed-capacity vectors
(SimpleFeatureVector.scala:98 defaults to 8,096 features per batch),
and sorted batch streams merge k-way on a sort attribute.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType

DEFAULT_BATCH_SIZE = 8096  # SimpleFeatureVector.scala:98

__all__ = ["DEFAULT_BATCH_SIZE", "FeatureArrowFileWriter",
           "FeatureArrowFileReader", "write_ipc", "read_ipc_batches",
           "sort_batches", "merge_sorted_ipc"]


def _schema_meta(sft: SimpleFeatureType) -> dict:
    return {b"geomesa.sft.name": sft.type_name.encode(),
            b"geomesa.sft.spec": sft.to_spec().encode()}


class FeatureArrowFileWriter:
    """Stream FeatureBatches to an Arrow IPC file, re-chunked to a fixed
    vector capacity; SFT name/spec ride in the schema metadata so the
    file is self-describing.

    The IPC *file* format allows exactly one dictionary per field
    (no deltas/replacement), but incremental feeds — the streaming
    scatter merges — hand this writer chunks whose vocabularies differ.
    String columns therefore encode against a per-attribute global
    ``ArrowDictionary`` that only appends; encoded batches buffer until
    ``close``, when every batch is emitted against the one final
    dictionary (valid for all of them, since each batch's codes index a
    prefix). A single-vocabulary feed produces byte-identical output to
    the old direct-write path.

    Memory: when the SFT has String attributes, the whole encoded
    result is held until ``close`` (the file format's one-dictionary
    rule forces it) — so file-format sinks fed by a streaming reduce
    are *not* constant-memory; only the IPC stream format
    (``arrow/delta.DeltaWriter``) is. Schemas with no String columns
    need no dictionary and write through batch by batch."""

    def __init__(self, sink, sft: SimpleFeatureType,
                 batch_size: int = DEFAULT_BATCH_SIZE):
        import pyarrow as pa
        self.sft = sft
        self.batch_size = batch_size
        self._pending: FeatureBatch | None = None
        probe = FeatureBatch.from_dict(
            sft, np.empty(0, dtype=object),
            {a.name: _empty_col(a) for a in sft.attributes})
        schema = probe.to_arrow().schema.with_metadata(_schema_meta(sft))
        self._writer = pa.ipc.new_file(sink, schema)
        self._schema = schema
        from .vector import ArrowDictionary
        self._dicts = {a.name: ArrowDictionary()
                       for a in sft.attributes if a.type.name == "String"}
        # (record batch, {string col -> (global codes, null mask)})
        self._buffered: list = []

    def write(self, batch: FeatureBatch):
        self._pending = _rechunk(self._pending, batch, self.batch_size,
                                 self._flush)

    def _flush(self, batch: FeatureBatch):
        import pyarrow as pa
        rb = batch.to_arrow()
        # unify non-dictionary column types with the declared schema
        table = pa.Table.from_batches([rb]).cast(pa.schema(
            [self._schema.field(i) for i in range(len(self._schema.names))]))
        if not self._dicts:
            # no string columns → no dictionary to finalize: write
            # through directly instead of buffering until close
            for rb2 in table.to_batches():
                self._writer.write_batch(rb2)
            return
        recodes = {}
        for name, d in self._dicts.items():
            col = batch.columns[name]
            vocab = [str(v) for v in col.vocab]
            remap = (np.asarray(d.add_all(vocab), dtype=np.int32)
                     if vocab else np.empty(0, dtype=np.int32))
            null = col.codes < 0
            gcodes = np.zeros(len(col.codes), dtype=np.int32)
            if len(remap):
                gcodes = remap[np.maximum(col.codes, 0)]
            recodes[name] = (gcodes, null)
        for rb2 in table.to_batches():
            self._buffered.append((rb2, recodes))

    def close(self):
        import pyarrow as pa
        if self._pending is not None and self._pending.n:
            self._flush(self._pending)
            self._pending = None
        finals = {name: pa.array(d.delta_since(0), type=pa.string())
                  for name, d in self._dicts.items()}
        names = [self._schema.field(i).name
                 for i in range(len(self._schema.names))]
        for rb, recodes in self._buffered:
            if recodes:
                arrays = list(rb.columns)
                for name, (gcodes, null) in recodes.items():
                    arrays[names.index(name)] = \
                        pa.DictionaryArray.from_arrays(
                            pa.array(gcodes, type=pa.int32(), mask=null),
                            finals[name])
                rb = pa.RecordBatch.from_arrays(arrays, names)
            self._writer.write_batch(rb)
        self._buffered.clear()
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rechunk(pending: FeatureBatch | None, batch: FeatureBatch,
             size: int, emit) -> FeatureBatch | None:
    """Append ``batch`` to ``pending``, ``emit`` every whole ``size``-row
    window in order, and return the remainder: each row is copied once
    (re-slicing the remainder per window would copy it per window)."""
    pending = batch if pending is None else pending.concat(batch)
    n = pending.n
    full = n - n % size
    for lo in range(0, full, size):
        emit(pending.take(np.arange(lo, lo + size)))
    return pending.take(np.arange(full, n)) if full else pending


def _concat(parts: list[FeatureBatch]) -> FeatureBatch | None:
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else FeatureBatch.concat_all(parts)


def _empty_col(a):
    if a.type.name == "Point":
        return (np.empty(0), np.empty(0))
    return []


class FeatureArrowFileReader:
    """Read an IPC feature file; recovers the SFT from metadata."""

    def __init__(self, source, sft: SimpleFeatureType | None = None):
        import pyarrow as pa
        self._reader = pa.ipc.open_file(source)
        meta = self._reader.schema.metadata or {}
        if sft is None:
            from ..features.sft import parse_spec
            name = meta.get(b"geomesa.sft.name", b"features").decode()
            spec = meta.get(b"geomesa.sft.spec")
            if spec is None:
                raise ValueError("no SFT metadata in arrow file; pass sft=")
            sft = parse_spec(name, spec.decode())
        self.sft = sft

    @property
    def num_batches(self) -> int:
        return self._reader.num_record_batches

    def batches(self) -> Iterator[FeatureBatch]:
        for i in range(self._reader.num_record_batches):
            yield FeatureBatch.from_arrow(self.sft,
                                          self._reader.get_batch(i))

    def read_all(self) -> FeatureBatch:
        out = _concat(list(self.batches()))
        if out is None:
            raise ValueError("empty arrow file")
        return out


def write_ipc(sft: SimpleFeatureType, batch: FeatureBatch,
              batch_size: int = DEFAULT_BATCH_SIZE) -> bytes:
    """Encode one batch as Arrow IPC file bytes."""
    import io as _io
    sink = _io.BytesIO()
    with FeatureArrowFileWriter(sink, sft, batch_size) as w:
        if batch.n:
            w.write(batch)
    return sink.getvalue()


def read_ipc_batches(data: bytes,
                     sft: SimpleFeatureType | None = None):
    """Decode IPC file bytes -> (sft, FeatureBatch or None)."""
    import io as _io
    r = FeatureArrowFileReader(_io.BytesIO(data), sft)
    return r.sft, _concat(list(r.batches()))


def sort_batches(batch: FeatureBatch, sort_by: str,
                 reverse: bool = False) -> FeatureBatch:
    """Sort a batch by an attribute (SimpleFeatureArrowIO sort)."""
    col = batch.columns[sort_by]
    if hasattr(col, "millis"):
        keys = col.millis
    elif hasattr(col, "codes"):
        keys = col.codes
    else:
        keys = col.values  # type: ignore[union-attr]
    order = np.argsort(keys, kind="stable")
    if reverse:
        order = order[::-1]
    return batch.take(order)


def merge_sorted_ipc(payloads: Iterable[bytes], sort_by: str,
                     reverse: bool = False,
                     sft: SimpleFeatureType | None = None) -> bytes:
    """K-way merge of sorted shard payloads into one sorted IPC file
    (the reduce step of ArrowScan / SimpleFeatureArrowIO.sort).

    Payloads must each be pre-sorted on ``sort_by``; the merge streams
    batch-at-a-time (arrow/delta.merge_sorted_streams) rather than
    concatenating the union. ``reverse`` requires descending payloads.
    """
    from .delta import iter_ipc, merge_sorted_streams
    import io as _io
    sources = []
    out_sft = sft
    for p in payloads:
        s, it = iter_ipc(p, sft)
        out_sft = out_sft or s
        sources.append(it)
    if out_sft is None:
        raise ValueError("no payloads to merge")
    sink = _io.BytesIO()
    wrote = False
    with FeatureArrowFileWriter(sink, out_sft) as w:
        for b in merge_sorted_streams(sources, sort_by, reverse=reverse):
            w.write(b)
            wrote = True
    if not wrote:
        return write_ipc(out_sft,
                         FeatureBatch.from_dict(
                             out_sft, np.empty(0, dtype=object),
                             {a.name: _empty_col(a)
                              for a in out_sft.attributes}))
    return sink.getvalue()
