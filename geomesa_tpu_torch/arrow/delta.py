"""Streaming result plane: incremental Arrow delta batches.

The reference never ships a query result as one monolithic buffer: the
batch scanner pulls fixed-size record batches off the tablet servers
(AccumuloQueryPlan.scala:123-137) and ``DeltaWriter`` encodes each one
against *growing* dictionaries, shipping only the per-batch dictionary
delta (DeltaWriter.scala:47,203). This module is that shape over
pyarrow's IPC **stream** format:

- ``DeltaWriter`` — feed it FeatureBatches, it re-chunks to a fixed
  row count and writes IPC stream messages where string dictionaries
  grow append-only, so pyarrow emits per-batch dictionary *deltas*
  (``emit_dictionary_deltas``) instead of re-shipping the vocabulary
  with every batch.
- ``stream_ipc`` / ``stream_bin`` — generators that encode a
  materialized result one fixed-size slice at a time: the schema (and
  first batch) leave the process before the last slice is encoded, so
  time-to-first-batch is independent of total hits.
- ``iter_ipc`` — the consuming half: decode an IPC stream (or file)
  payload, bytes or file-like, one record batch at a time in bounded
  memory.
- ``merge_sorted_streams`` — k-way merge of pre-sorted batch streams
  on a sort attribute that never materializes more than one in-flight
  batch per source (the streaming replacement for the eager
  ``merge_deltas`` concat-everything path).

Knob: ``geomesa.stream.batch.rows`` (rows per wire batch, default
8192, a power of two unlike the reference's 8096 vector capacity).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType
from ..utils.properties import SystemProperty
from .io import _empty_col, _rechunk, _schema_meta
from .vector import ArrowDictionary

__all__ = ["DeltaWriter", "STREAM_BATCH_ROWS", "ARROW_STREAM_MIME",
           "stream_ipc", "stream_bin", "iter_ipc", "slice_batches",
           "merge_sorted_streams", "reassemble_ipc", "empty_batch"]

# rows per streamed record batch (the fixed vector capacity of the
# wire); 8192 not the reference's 8096 so pow2 shape classes fit
STREAM_BATCH_ROWS = SystemProperty("geomesa.stream.batch.rows", "8192")

# the content type of a chunked ``format=arrow-stream`` reply
ARROW_STREAM_MIME = "application/vnd.apache.arrow.stream"

def _rows(batch_rows: int | None) -> int:
    if batch_rows is not None:
        return max(int(batch_rows), 1)
    return max(STREAM_BATCH_ROWS.as_int() or 8192, 1)


def empty_batch(sft: SimpleFeatureType) -> FeatureBatch:
    return FeatureBatch.from_dict(
        sft, np.empty(0, dtype=object),
        {a.name: _empty_col(a) for a in sft.attributes})


class DeltaWriter:
    """Incremental Arrow IPC *stream* encoder with per-batch dictionary
    deltas (DeltaWriter.scala:47,203 analog).

    String columns encode against per-attribute ``ArrowDictionary``
    instances that only ever append: every emitted record batch's
    dictionary is a prefix extension of the previous one, so the IPC
    writer ships just the delta values. ``write`` re-chunks input to
    ``batch_rows``; ``flush`` force-emits a partial batch (a stream
    boundary); ``close`` flushes and writes the end-of-stream marker.
    """

    def __init__(self, sink, sft: SimpleFeatureType,
                 batch_rows: int | None = None):
        import pyarrow as pa
        self.sft = sft
        self.batch_rows = _rows(batch_rows)
        self._dicts = {a.name: ArrowDictionary()
                       for a in sft.attributes if a.type.name == "String"}
        probe = empty_batch(sft)
        schema = probe.to_arrow().schema.with_metadata(_schema_meta(sft))
        self._schema = pa.schema(
            [schema.field(i) for i in range(len(schema.names))],
            metadata=schema.metadata)
        self._writer = pa.ipc.new_stream(
            sink, self._schema,
            options=pa.ipc.IpcWriteOptions(emit_dictionary_deltas=True))
        self._pending: FeatureBatch | None = None
        self.batches_written = 0

    def write(self, batch: FeatureBatch | None):
        if batch is None or not batch.n:
            return
        self._pending = _rechunk(self._pending, batch, self.batch_rows,
                                 self._emit)

    def flush(self):
        """Emit any buffered partial batch now (stream boundary)."""
        if self._pending is not None and self._pending.n:
            head, self._pending = self._pending, None
            self._emit(head)

    def _emit(self, batch: FeatureBatch):
        import pyarrow as pa
        rb = batch.to_arrow()
        if self._dicts:
            arrays = list(rb.columns)
            names = rb.schema.names
            for name, d in self._dicts.items():
                col = batch.columns[name]
                # grow the global dictionary append-only and remap the
                # batch-local codes through it: the IPC writer sees a
                # prefix-extended dictionary and emits only the delta
                vocab = [str(v) for v in col.vocab]
                remap = (np.asarray(d.add_all(vocab), dtype=np.int32)
                         if vocab else np.empty(0, dtype=np.int32))
                null = col.codes < 0
                gcodes = np.zeros(len(col.codes), dtype=np.int32)
                if len(remap):
                    gcodes = remap[np.maximum(col.codes, 0)]
                arrays[names.index(name)] = pa.DictionaryArray.from_arrays(
                    pa.array(gcodes, type=pa.int32(), mask=null),
                    pa.array(d.delta_since(0), type=pa.string()))
            rb = pa.RecordBatch.from_arrays(arrays, names)
        # unify non-dictionary column types with the declared schema
        table = pa.Table.from_batches([rb], schema=None).cast(pa.schema(
            [self._schema.field(i) for i in range(len(self._schema.names))]))
        for rb2 in table.to_batches():
            self._writer.write_batch(rb2)
            self.batches_written += 1

    def close(self):
        self.flush()
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ChunkSink:
    """File-like that buffers writes until drained — lets a generator
    interleave DeltaWriter output with yields."""

    closed = False

    def __init__(self):
        self._parts: list[bytes] = []

    def write(self, data) -> int:
        self._parts.append(bytes(data))
        return len(data)

    def flush(self):
        pass

    def close(self):
        self.closed = True

    def drain(self) -> bytes:
        out = b"".join(self._parts)
        self._parts.clear()
        return out


def slice_batches(batch: FeatureBatch | None,
                  batch_rows: int | None = None) -> Iterator[FeatureBatch]:
    """Slice one materialized batch into fixed-size row windows."""
    rows = _rows(batch_rows)
    n = batch.n if batch is not None else 0
    for start in range(0, n, rows):
        yield batch.take(np.arange(start, min(start + rows, n)))


def stream_ipc(sft: SimpleFeatureType, batch: FeatureBatch | None,
               batch_rows: int | None = None) -> Iterator[bytes]:
    """Encode one result as an IPC stream, yielded chunk-by-chunk: the
    schema preamble first, then one chunk per fixed-size record batch
    (dictionary deltas ride inside). Peak memory is one slice."""
    sink = _ChunkSink()
    w = DeltaWriter(sink, sft, batch_rows)
    head = sink.drain()  # schema message: first bytes on the wire
    if head:
        yield head
    for piece in slice_batches(batch, w.batch_rows):
        w.write(piece)
        w.flush()
        chunk = sink.drain()
        if chunk:
            yield chunk
    w.close()
    tail = sink.drain()  # end-of-stream marker
    if tail:
        yield tail


def stream_bin(sft: SimpleFeatureType, batch: FeatureBatch | None,
               ids=None, track: str | None = None,
               label: str | None = None,
               batch_rows: int | None = None) -> Iterator[bytes]:
    """Encode one result as BIN records (scan/aggregations.py wire
    format), one fixed-size slice of records per chunk."""
    from ..scan.aggregations import encode_bin_batch
    if batch is None or not batch.n:
        return
    all_ids = np.asarray(ids if ids is not None else batch.ids)
    rows = _rows(batch_rows)
    for start in range(0, batch.n, rows):
        idx = np.arange(start, min(start + rows, batch.n))
        yield encode_bin_batch(sft, all_ids[idx], batch.take(idx),
                               track=track, label=label)


def _sft_from_schema(schema, sft: SimpleFeatureType | None):
    if sft is not None:
        return sft
    meta = schema.metadata or {}
    spec = meta.get(b"geomesa.sft.spec")
    if spec is None:
        raise ValueError("no SFT metadata in arrow stream; pass sft=")
    from ..features.sft import parse_spec
    name = meta.get(b"geomesa.sft.name", b"features").decode()
    return parse_spec(name, spec.decode())


def iter_ipc(source, sft: SimpleFeatureType | None = None):
    """Incrementally decode an Arrow IPC payload into FeatureBatches.

    ``source`` is bytes (stream OR file format — shard payloads are
    files, the wire is a stream) or a file-like with ``read`` (an HTTP
    response body, decoded batch-at-a-time in bounded memory). Returns
    ``(sft, iterator)``; the iterator skips empty batches.
    """
    import pyarrow as pa
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
        if data[:6] == b"ARROW1":
            rd = pa.ipc.open_file(pa.BufferReader(data))
            out_sft = _sft_from_schema(rd.schema, sft)

            def gen_file():
                for i in range(rd.num_record_batches):
                    rb = rd.get_batch(i)
                    if rb.num_rows:
                        yield FeatureBatch.from_arrow(out_sft, rb)
            return out_sft, gen_file()
        source = pa.BufferReader(data)
    rd = pa.ipc.open_stream(source)
    out_sft = _sft_from_schema(rd.schema, sft)

    def gen_stream():
        for rb in rd:
            if rb.num_rows:
                yield FeatureBatch.from_arrow(out_sft, rb)
    return out_sft, gen_stream()


def reassemble_ipc(sft: SimpleFeatureType,
                   batches: Iterable[FeatureBatch]) -> bytes:
    """Rebuild the materialized IPC *file* payload from streamed
    batches — byte-identical to ``write_ipc`` of the same rows at the
    same version."""
    from .io import write_ipc
    parts = [b for b in batches if b is not None and b.n]
    if not parts:
        return write_ipc(sft, empty_batch(sft))
    merged = parts[0] if len(parts) == 1 else FeatureBatch.concat_all(parts)
    return write_ipc(sft, merged)


# -- streaming k-way sort-merge ---------------------------------------------


def _merge_keys(batch: FeatureBatch, sort_by: str) -> np.ndarray:
    """Cross-source-comparable sort keys for one batch: millis for
    dates, values for numerics, decoded strings for dictionary columns
    (codes are only ordered within one vocab)."""
    col = batch.columns[sort_by]
    millis = getattr(col, "millis", None)
    if millis is not None:
        return np.asarray(millis)
    codes = getattr(col, "codes", None)
    if codes is not None:
        vocab = col.vocab.astype(str)
        vals = (vocab[np.maximum(codes, 0)] if len(vocab)
                else np.full(len(codes), "", dtype=str))
        # nulls sort last (store/common.sort_order convention)
        return np.where(codes >= 0, vals, "\U0010ffff")
    vals = np.asarray(col.values)
    if vals.dtype.kind == "f":
        # Null Double/Float is stored as NaN. sort_order argsorts
        # ascending (NaN last) and reverses for descending, so NaN
        # behaves like +inf in both directions — but a raw NaN key
        # poisons the merge bound (every comparison is False and no
        # cursor can advance). Substitute +inf to keep bounds total.
        vals = np.where(np.isnan(vals), np.inf, vals)
    return vals


def _stable_order(keys: np.ndarray, reverse: bool) -> np.ndarray:
    if not reverse:
        return np.argsort(keys, kind="stable")
    # stable descending: stable-sort the reversed array, map back
    rev = np.argsort(keys[::-1], kind="stable")
    return (len(keys) - 1 - rev)[::-1]


class _Cursor:
    """One merge source: the current batch, its keys, and a read
    position. At most one batch is resident per source."""

    __slots__ = ("it", "batch", "keys", "pos")

    def __init__(self, it):
        self.it = it
        self.batch: FeatureBatch | None = None
        self.keys: np.ndarray | None = None
        self.pos = 0

    def pull(self, sort_by: str | None) -> bool:
        for batch in self.it:
            if batch is None or not batch.n:
                continue
            self.batch = batch
            self.keys = (_merge_keys(batch, sort_by)
                         if sort_by is not None else None)
            self.pos = 0
            return True
        self.batch = None
        return False


def merge_sorted_streams(sources, sort_by: str | None,
                         reverse: bool = False,
                         batch_rows: int | None = None
                         ) -> Iterator[FeatureBatch]:
    """K-way merge of pre-sorted FeatureBatch streams on ``sort_by``
    without materializing any source (the streaming replacement for
    the eager concat-then-sort ``merge_deltas`` reduce).

    Each round emits every row whose key is provably final: rows up to
    the minimum (maximum, for ``reverse``) of the sources' current
    last keys — any future row from any source sorts at or after that
    bound, because each source stream is itself sorted. ``sort_by``
    None concatenates the streams in source order (no merge keys)."""
    rows = _rows(batch_rows)
    cursors = [c for c in (_Cursor(iter(s)) for s in sources)
               if c.pull(sort_by)]
    pending: FeatureBatch | None = None

    def chunks(batch, final=False):
        nonlocal pending
        if batch is not None and batch.n:
            pending = batch if pending is None else pending.concat(batch)
        while pending is not None and pending.n >= rows:
            head = pending.take(np.arange(rows))
            pending = pending.take(np.arange(rows, pending.n))
            yield head
        if final and pending is not None and pending.n:
            head, pending = pending, None
            yield head

    if sort_by is None:
        for c in cursors:
            more = True
            while more:
                tail = (c.batch if c.pos == 0
                        else c.batch.take(np.arange(c.pos, c.batch.n)))
                yield from chunks(tail)
                more = c.pull(None)
        yield from chunks(None, final=True)
        return

    while cursors:
        if len(cursors) == 1:
            # single live source: pass its batches straight through
            c = cursors[0]
            more = True
            while more:
                tail = (c.batch if c.pos == 0
                        else c.batch.take(np.arange(c.pos, c.batch.n)))
                yield from chunks(tail)
                more = c.pull(sort_by)
            break
        bound = (min if not reverse else max)(
            c.keys[-1] for c in cursors)
        parts: list[FeatureBatch] = []
        keys: list[np.ndarray] = []
        for c in list(cursors):
            k = c.keys[c.pos:]
            take_n = int(np.count_nonzero(
                k <= bound if not reverse else k >= bound))
            if take_n:
                idx = np.arange(c.pos, c.pos + take_n)
                parts.append(c.batch.take(idx))
                keys.append(k[:take_n])
                c.pos += take_n
            if c.pos >= c.batch.n and not c.pull(sort_by):
                cursors.remove(c)
        if not parts:
            continue
        window = (parts[0] if len(parts) == 1
                  else FeatureBatch.concat_all(parts))
        order = _stable_order(np.concatenate(keys), reverse)
        yield from chunks(window.take(order))
    yield from chunks(None, final=True)
