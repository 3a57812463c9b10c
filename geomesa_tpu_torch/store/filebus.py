"""The file bus's wire format and its durable file writes.

The reference's live tier streams GeoMessages through Kafka topics
(kafka/data/KafkaDataStore.scala:44). Its file-backed analog keeps one
message a file; the port has the pieces the write-ahead log shares with
it so far:

- ``_encode``/``_decode``: a GeoMessage as a 4-byte big-endian header
  length, a JSON header (kind, type name, ids, timestamp, the schema's
  spec and the visibilities) and an Arrow IPC stream of
  ``FeatureBatch.to_arrow()`` for a create. Self-describing: a reader
  needs no out-of-band schema, and the JAX package's payloads decode
  here and the port's there;
- ``write_bytes_atomic``/``write_json_atomic``: tmp + fsync + rename +
  directory fsync, through the fault disk (``integrity/faultfs.py``);
- ``segment_name`` and ``fsync_dir``.

The ``FileBus`` class (topics, consumer offsets, polling) comes with the
streaming tiers (ROADMAP.md section 6, queue 1 item 5). pyarrow is
imported when a batch is encoded or decoded.
"""

from __future__ import annotations

import json
import os
import threading

from ..features.batch import FeatureBatch
from ..features.sft import encode_spec, parse_spec
from ..integrity import faultfs
from .live import GeoMessage

__all__ = ["segment_name", "fsync_dir", "write_bytes_atomic",
           "write_json_atomic"]

_SEQ_DIGITS = 12


def segment_name(seq: int) -> str:
    """Canonical log-segment file name of the file bus."""
    return f"{seq:0{_SEQ_DIGITS}d}.msg"


def fsync_dir(path: str):
    """fsync a DIRECTORY so the rename/unlink entries inside it are
    durable — os.replace alone only orders the data, not the dirent; a
    crash can still lose the new name. Best-effort: some filesystems
    refuse directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes_atomic(path: str, raw: bytes):
    """Durable atomic write: tmp + fsync + rename + directory fsync
    (readers never see a partial file, and the rename itself survives a
    crash — the WAL checkpoint manifest relies on this). Tmp names are
    pid+thread-unique.

    Both the data write and the fsync route through the fault shim
    keyed by the LOGICAL destination path, so chaos tests can tear or
    bit-flip a checkpoint file without knowing the tmp name."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        faultfs.write(f, raw, path)
        f.flush()
        faultfs.fsync(f.fileno(), path)
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def write_json_atomic(path: str, obj):
    write_bytes_atomic(path, json.dumps(obj).encode())


def _encode(msg: GeoMessage) -> bytes:
    header: dict = {"kind": msg.kind, "type_name": msg.type_name,
                    "ids": list(msg.ids), "timestamp_ms": msg.timestamp_ms}
    if msg.visibilities is not None:
        header["vis"] = list(msg.visibilities)
    payload = b""
    if msg.batch is not None:
        import pyarrow as pa
        header["spec"] = encode_spec(msg.batch.sft)
        rb = msg.batch.to_arrow()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, rb.schema) as w:
            w.write_batch(rb)
        payload = sink.getvalue().to_pybytes()
    h = json.dumps(header).encode()
    return len(h).to_bytes(4, "big") + h + payload


def _decode(raw: bytes) -> GeoMessage:
    hlen = int.from_bytes(raw[:4], "big")
    header = json.loads(raw[4:4 + hlen].decode())
    batch = None
    payload = raw[4 + hlen:]
    if payload:
        import pyarrow as pa
        sft = parse_spec(header["type_name"], header["spec"])
        with pa.ipc.open_stream(pa.BufferReader(payload)) as r:
            rb = r.read_next_batch()
        batch = FeatureBatch.from_arrow(sft, rb)
    vis = header.get("vis")
    return GeoMessage(header["kind"], header["type_name"], batch,
                      tuple(header.get("ids") or ()),
                      header.get("timestamp_ms", 0),
                      None if vis is None else tuple(vis))
