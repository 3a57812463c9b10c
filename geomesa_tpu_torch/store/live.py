"""Live streaming tier: the Kafka datastore analog.

The reference's KafkaDataStore (kafka/data/KafkaDataStore.scala:44)
streams feature mutations as GeoMessages (Create/Delete/Clear,
kafka/utils/GeoMessage.scala:14) through topics; consumers materialize
an in-memory queryable cache with live listeners. Here:

- ``MessageBus`` is the in-process topic fabric (multiple stores attach
  to the same bus: producers publish, consumer stores apply);
- ``LiveDataStore`` keeps the latest version of each feature in an
  ``InMemoryDataStore`` on the card (the cache the KafkaCacheLoader
  builds, kafka/data/KafkaDataStore.scala:68-84), so its queries run the
  store's scan kernels;
- listeners receive feature events (KafkaFeatureEvent analog), after the
  cache has applied the message; an error a listener raises reaches the
  caller of ``write`` on the in-process bus;
- optional age-off expiry drops features older than a ttl at
  maintenance time (AgeOffIterator analog).

``GeoMessage`` is also the write-ahead log's record body (``wal/log.py``)
and travels in the wire format of ``filebus.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType, parse_spec
from ..index.api import Query
from .api import DataStore
from .memory import InMemoryDataStore, QueryResult

__all__ = ["GeoMessage", "MessageBus", "LiveDataStore"]


@dataclasses.dataclass
class GeoMessage:
    """A feature mutation (GeoMessage.scala:14)."""
    kind: str                       # "create" | "delete" | "clear"
    type_name: str
    batch: FeatureBatch | None = None   # for create
    ids: tuple = ()                 # for delete
    timestamp_ms: int = 0
    visibilities: tuple | None = None   # per-feature labels (create)


class MessageBus:
    """In-process pub/sub topics: the Kafka stand-in. Subscribers are
    called synchronously on publish (tests and single-process pipelines;
    a networked bus slots in behind the same interface)."""

    def __init__(self):
        self._subs: dict[str, list[Callable[[GeoMessage], None]]] = {}

    def subscribe(self, topic: str, fn: Callable[[GeoMessage], None]):
        self._subs.setdefault(topic, []).append(fn)

    def publish(self, topic: str, msg: GeoMessage):
        for fn in self._subs.get(topic, []):
            fn(msg)


def _now_ms() -> int:
    return int(time.time() * 1000)


class LiveDataStore(DataStore):
    """Streaming store over a MessageBus: publish mutations, query the
    live cache.

    ``device=None`` means ``"cuda"`` and raises without a card, as the
    in-memory store does. ``durable_dir`` journals every applied
    mutation (bus-delivered ones included) and replays checkpoint + log
    on open; ``wal_fsync`` is the log's fsync policy."""

    def __init__(self, bus: MessageBus | None = None,
                 ttl_millis: int | None = None,
                 durable_dir: str | None = None,
                 wal_fsync: str | None = None, device=None):
        self.bus = bus or MessageBus()
        self.ttl_millis = ttl_millis
        self._mem = InMemoryDataStore(device=device, durable_dir=durable_dir,
                                      wal_fsync=wal_fsync)
        self.device = self._mem.device
        self._listeners: dict[str, list[Callable[[GeoMessage], None]]] = {}
        self._arrival_ms: dict[str, np.ndarray] = {}
        self._subscribed: set[str] = set()
        # recovered types need the live-tier bookkeeping the replay
        # bypassed: re-subscribe, and stamp rows with the reopen time
        # (real arrival times aren't journaled — "now" gives them a
        # full ttl lease instead of instant age-off)
        now = _now_ms()
        for tn in self._mem.get_type_names():
            self._arrival_ms[tn] = np.full(self._mem.count(tn), now,
                                           dtype=np.int64)
            self._subscribed.add(tn)
            self.bus.subscribe(tn, self._on_message)

    @property
    def journal(self):
        """The cache's WAL journal, or None when not durable."""
        return self._mem.journal

    def checkpoint(self, keep: int = 2) -> dict:
        return self._mem.checkpoint(keep=keep)

    def close(self):
        self._mem.close()

    # -- schema ------------------------------------------------------------

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        self._mem.create_schema(sft)
        self._arrival_ms[sft.type_name] = np.empty(0, dtype=np.int64)
        if sft.type_name not in self._subscribed:
            self._subscribed.add(sft.type_name)
            self.bus.subscribe(sft.type_name, self._on_message)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._mem.get_schema(type_name)

    def get_type_names(self) -> list[str]:
        return self._mem.get_type_names()

    def remove_schema(self, type_name: str):
        self._mem.remove_schema(type_name)
        self._arrival_ms.pop(type_name, None)
        self._listeners.pop(type_name, None)

    # -- producer side -----------------------------------------------------

    def write(self, type_name: str, batch: FeatureBatch,
              timestamp_ms: int | None = None, visibilities=None):
        ts = timestamp_ms if timestamp_ms is not None else _now_ms()
        vis = (None if visibilities is None
               else tuple(None if v is None else str(v)
                          for v in visibilities))
        self.bus.publish(type_name, GeoMessage("create", type_name, batch,
                                               timestamp_ms=ts,
                                               visibilities=vis))

    def delete(self, type_name: str, ids):
        self.bus.publish(type_name, GeoMessage(
            "delete", type_name, ids=tuple(map(str, ids)),
            timestamp_ms=_now_ms()))

    def clear(self, type_name: str):
        self.bus.publish(type_name, GeoMessage(
            "clear", type_name, timestamp_ms=_now_ms()))

    # -- consumer side -----------------------------------------------------

    def poll(self) -> int:
        """Drain a poll-driven bus (FileBus, SocketBus) into this store's
        cache; no-op for the synchronous in-process bus. Returns messages
        applied."""
        poll = getattr(self.bus, "poll", None)
        return poll() if poll is not None else 0

    def _on_message(self, msg: GeoMessage):
        t = msg.type_name
        if t not in self._mem.get_type_names():
            if msg.batch is None:
                # delete/clear for a type this cache never saw: a no-op
                # (nothing to remove), not an error that wedges polling
                return
            # consumer side of a cross-process bus: the schema travels
            # with the message (self-describing wire format). The topic
            # is already subscribed — this message arrived through it —
            # so mark it before create_schema to avoid double delivery.
            self._subscribed.add(t)
            self.create_schema(msg.batch.sft)
        if msg.kind == "create":
            # upsert semantics: replace existing ids (the cache keeps the
            # latest version of each feature, as the reference's does).
            # The cached ids' conversion is O(cache) a message
            # (ROADMAP.md's owed list: an id-to-row map).
            existing = self._mem._state(t)
            incoming = set(msg.batch.ids.astype(str))
            if existing.batch is not None and existing.n:
                dup = np.isin(existing.batch.ids.astype(str), list(incoming))
                if dup.any():
                    self._mem.delete(t, existing.batch.ids[dup])
                    self._arrival_ms[t] = self._arrival_ms[t][~dup]
            self._mem.write(t, msg.batch, visibilities=msg.visibilities)
            self._arrival_ms[t] = np.concatenate([
                self._arrival_ms[t],
                np.full(msg.batch.n, msg.timestamp_ms, dtype=np.int64)])
        elif msg.kind == "delete":
            st = self._mem._state(t)
            if st.batch is not None and st.n:
                keep = ~np.isin(st.batch.ids.astype(str), list(msg.ids))
                self._arrival_ms[t] = self._arrival_ms[t][keep]
            self._mem.delete(t, msg.ids)
        elif msg.kind == "clear":
            sft = self._mem.get_schema(t)
            self._mem.remove_schema(t)
            self._mem.create_schema(sft)
            self._arrival_ms[t] = np.empty(0, dtype=np.int64)
        for fn in self._listeners.get(t, []):
            fn(msg)

    def add_listener(self, type_name: str, fn: Callable[[GeoMessage], None]):
        self._listeners.setdefault(type_name, []).append(fn)

    def remove_listener(self, type_name: str,
                        fn: Callable[[GeoMessage], None]):
        fns = self._listeners.get(type_name, [])
        if fn in fns:
            fns.remove(fn)

    # -- maintenance -------------------------------------------------------

    def expire(self, type_name: str, now_ms: int | None = None) -> int:
        """Drop features older than the ttl; returns the dropped count."""
        if self.ttl_millis is None:
            return 0
        now = now_ms if now_ms is not None else _now_ms()
        st = self._mem._state(type_name)
        if st.batch is None or st.n == 0:
            return 0
        old = self._arrival_ms[type_name] < now - self.ttl_millis
        if not old.any():
            return 0
        ids = st.batch.ids[old]
        self._arrival_ms[type_name] = self._arrival_ms[type_name][~old]
        self._mem.delete(type_name, ids)
        return int(old.sum())

    def features_older_than(self, type_name: str, cutoff_ms: int):
        """(ids, batch) of features that arrived before the cutoff — the
        Lambda tier's persistence feed."""
        st = self._mem._state(type_name)
        if st.batch is None or st.n == 0:
            return np.empty(0, object), None
        old = self._arrival_ms[type_name] < cutoff_ms
        idx = np.flatnonzero(old)
        if not len(idx):
            return np.empty(0, object), None
        return st.batch.ids[idx], st.batch.take(idx)

    # -- queries -----------------------------------------------------------

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        return self._mem.query(q, type_name, explain_out=explain_out)

    def query_batched(self, queries: list[Query],
                      explain_out=None) -> list[QueryResult]:
        """Coalesced multi-query execution over the live view (one
        batched device scan; see InMemoryDataStore.query_batched)."""
        return self._mem.query_batched(queries, explain_out=explain_out)

    def count(self, type_name: str) -> int:
        return self._mem.count(type_name)

    def query_count(self, q: Query | str,
                    type_name: str | None = None) -> int:
        return self._mem.query_count(q, type_name)

    def bin_query(self, type_name: str, ecql="INCLUDE",
                  track: str | None = None, label: str | None = None,
                  sort: bool = False) -> bytes:
        """BIN aggregation over the live view (the in-memory store's)."""
        return self._mem.bin_query(type_name, ecql, track=track,
                                   label=label, sort=sort)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        return self._mem.arrow_ipc(type_name, ecql, sort_by=sort_by)
