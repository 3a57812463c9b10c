"""File-backed message bus: cross-process transport for the live tier.

The reference's live tier is network pub/sub: feature mutations flow
through Kafka topics as GeoMessages and consumer offsets checkpoint in
Zookeeper (kafka/data/KafkaDataStore.scala:44,
lambda/stream/ZookeeperOffsetManager.scala:27). Kafka's essence is a
durable, ordered, append-only log per topic with independent consumer
offsets; ``FileBus`` is that design on a shared filesystem, so two
processes see each other's mutations:

- topic = directory; message = one segment file named by sequence
  number, claimed atomically with O_CREAT|O_EXCL (multi-producer safe)
  after its payload is written and fsynced under a tmp name;
- payload (``_encode``/``_decode``) = a 4-byte big-endian header
  length, a JSON header (kind, type name, ids, timestamp, the schema's
  spec and the visibilities) and an Arrow IPC stream of
  ``FeatureBatch.to_arrow()`` for a create. Self-describing: a reader
  needs no out-of-band schema, and the JAX package's payloads decode
  here and the port's there;
- consumers poll for sequence numbers past their offset; offsets
  checkpoint to ``offsets/<group>.json`` after every poll, so a
  restarted consumer resumes where it left off.

The layout is the JAX package's (``geomesa_tpu/store/filebus.py``): a
root written by either package is read by the other. The durable file
writes (``write_bytes_atomic``/``write_json_atomic``: tmp + fsync +
rename + directory fsync, through the fault disk
``integrity/faultfs.py``) are shared with the write-ahead log and the
socket broker. pyarrow is imported when a batch is encoded or decoded.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

from ..features.batch import FeatureBatch
from ..features.sft import encode_spec, parse_spec
from ..integrity import faultfs
from .live import GeoMessage

__all__ = ["FileBus", "segment_name", "fsync_dir", "write_bytes_atomic",
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


class FileBus:
    """Durable multi-process topic log. Same subscribe surface as the
    in-process MessageBus, but delivery is poll-driven: ``publish``
    appends to the shared log; ``poll()`` drains messages past this
    consumer group's offsets into the subscribers."""

    # an empty claimed-but-never-written message file older than this is
    # an aborted publish: consumers skip it instead of wedging the topic
    STALE_CLAIM_S = 5.0

    def __init__(self, root: str, group: str = "default"):
        self.root = root
        self.group = group
        self._subs: dict[str, list[Callable[[GeoMessage], None]]] = {}
        self._offsets: dict[str, int] = {}
        self._next_seq: dict[str, int] = {}  # producer-side cache
        os.makedirs(os.path.join(root, "offsets"), exist_ok=True)
        self._load_offsets()

    # -- offsets (ZookeeperOffsetManager analog) ---------------------------

    def _offsets_path(self) -> str:
        return os.path.join(self.root, "offsets", f"{self.group}.json")

    def _load_offsets(self):
        try:
            with open(self._offsets_path()) as f:
                self._offsets = {k: int(v) for k, v in json.load(f).items()}
        except (FileNotFoundError, json.JSONDecodeError):
            self._offsets = {}

    def _save_offsets(self):
        write_json_atomic(self._offsets_path(), self._offsets)

    def offset(self, topic: str) -> int:
        return self._offsets.get(topic, 0)

    def set_offset(self, topic: str, offset: int):
        """Manual seek (offset = last consumed sequence number)."""
        self._offsets[topic] = int(offset)
        self._save_offsets()

    # -- producer ----------------------------------------------------------

    def _topic_dir(self, topic: str) -> str:
        d = os.path.join(self.root, "topics", topic)
        os.makedirs(d, exist_ok=True)
        return d

    def _seqs(self, d: str) -> list[int]:
        return [int(f[:_SEQ_DIGITS]) for f in os.listdir(d)
                if f.endswith(".msg")]

    def publish(self, topic: str, msg: GeoMessage) -> int:
        d = self._topic_dir(topic)
        raw = _encode(msg)
        # the payload is fully written (and fsynced) BEFORE any sequence
        # number is claimed, so the empty-claim window is just a rename
        tmp = os.path.join(d, f".payload.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        # cached next sequence avoids an O(topic-size) listdir per
        # publish; contention falls through to the O_EXCL retry loop
        seq = self._next_seq.get(topic)
        if seq is None:
            seq = max(self._seqs(d), default=0) + 1
        while True:
            name = segment_name(seq)
            try:
                # claim the sequence number atomically across processes
                fd = os.open(os.path.join(d, name),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                seq += 1
                continue
            try:
                os.replace(tmp, os.path.join(d, name))
            finally:
                os.close(fd)
            self._next_seq[topic] = seq + 1
            return seq

    # -- consumer ----------------------------------------------------------

    def subscribe(self, topic: str, fn: Callable[[GeoMessage], None]):
        self._subs.setdefault(topic, []).append(fn)

    def poll(self, max_messages: int | None = None) -> int:
        """Drain new messages on all subscribed topics to their
        subscribers, in sequence order; checkpoints offsets. Returns the
        number of messages delivered."""
        delivered = 0
        advanced = False
        # snapshot: a subscriber may register new topics mid-delivery
        # (consumer-side schema auto-create)
        for topic, fns in list(self._subs.items()):
            d = self._topic_dir(topic)
            start = self._offsets.get(topic, 0)
            for seq in sorted(s for s in self._seqs(d) if s > start):
                path = os.path.join(d, segment_name(seq))
                try:
                    with open(path, "rb") as f:
                        raw = f.read()
                    msg = _decode(raw) if raw else None
                except FileNotFoundError:
                    break  # racing a writer: retry next poll
                except (json.JSONDecodeError, ValueError, KeyError):
                    msg = None  # corrupt payload: treat like a claim
                if msg is None:
                    if (time.time() - os.path.getmtime(path)
                            > self.STALE_CLAIM_S):
                        # aborted publish or corrupt persisted message:
                        # messages appear atomically via rename, so it
                        # cannot self-heal — skip past it rather than
                        # wedging every later message on the topic
                        self._offsets[topic] = seq
                        advanced = True
                        continue
                    # fresh: may still be mid-swap; retry next poll
                    break
                for fn in fns:
                    fn(msg)
                self._offsets[topic] = seq
                advanced = True
                delivered += 1
                if max_messages is not None and delivered >= max_messages:
                    break
            if max_messages is not None and delivered >= max_messages:
                break
        if advanced:
            self._save_offsets()
        return delivered

    def wait_for(self, predicate, timeout_s: float = 10.0,
                 interval_s: float = 0.05) -> bool:
        """Poll until predicate() is true or the timeout lapses."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll()
            if predicate():
                return True
            time.sleep(interval_s)
        return False
