"""Continuous queries: standing ECQL filters pushed as deltas.

The streaming inverse of a scan: instead of a client polling
``query()`` for new matches, a ``ContinuousQueryPublisher`` attaches to
a live store's mutation feed (LiveDataStore / StreamDataStore
listeners), matches each registered filter against every create batch,
and publishes ONLY the matching rows to a per-query topic
(``cq.<name>``). Subscribers receive incremental feature deltas in the
bus wire format (JSON header + Arrow IPC — filebus._encode), or
BIN-encoded chunks via ``on_bin`` — never a full rescan.

Resumability is the broker's offset contract (socketbus.py): over a
``SocketBroker`` the ``cq.*`` topics get server-committed
consumer-group offsets, so a subscriber that dies and reattaches — or
a broker that restarts with ``root=`` persistence — resumes gapless
and duplicate-free from the last committed offset (the
ZookeeperOffsetManager analog). The in-process ``MessageBus`` works
too for single-process pipelines (push delivery, no offsets).

Matching runs on the card: every registered filter is compiled into a
per-type ``StandingFilterSet`` (scan/standing.py) on the store's
device, so one ingest batch against 100k standing geofences is one
kernel launch a chunk of rows plus per-filter host patches. Two
departures from the JAX module (ROADMAP.md section 3): there is no
``geomesa.cq.device`` switch back to a host loop, and an error of the
device dispatch is counted (``cq.device.errors``) and raised to the
writer instead of falling back to the host loop for that message. The
host ``evaluate`` loop serves only types whose schema the publisher
could not read at registration (host-only by meaning).

``geomesa.cq.publish.batch.rows`` caps rows per published delta
message — a bulk write matching 1M rows streams to subscribers as
fixed-size messages, not one giant frame.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ..filters import evaluate, parse_ecql
from ..metrics import metrics
from ..utils.properties import SystemProperty
from .live import GeoMessage

__all__ = ["ContinuousQuery", "ContinuousQueryPublisher",
           "ContinuousQuerySubscriber", "CQ_PUBLISH_BATCH_ROWS", "cq_topic"]

# rows per published continuous-query delta message: bounds subscriber
# (and broker frame) memory when a bulk write matches many rows
CQ_PUBLISH_BATCH_ROWS = SystemProperty("geomesa.cq.publish.batch.rows",
                                       "8192")


def cq_topic(name: str) -> str:
    return f"cq.{name}"


class ContinuousQuery:
    """One registered standing query: the parsed filter plus counters."""

    __slots__ = ("name", "type_name", "ecql", "filter", "topic",
                 "matched", "published")

    def __init__(self, name: str, type_name: str, ecql: str):
        self.name = name
        self.type_name = type_name
        self.ecql = ecql
        self.filter = parse_ecql(ecql)
        self.topic = cq_topic(name)
        self.matched = 0     # rows that passed the filter
        self.published = 0   # delta messages published


class ContinuousQueryPublisher:
    """Evaluates standing queries against a live store's mutation feed
    and publishes matching deltas to per-query bus topics.

    ``store`` is a LiveDataStore or StreamDataStore (anything with an
    ``add_listener`` feeding GeoMessages); ``bus`` is where ``cq.*``
    deltas go — a SocketBus for cross-process subscribers with
    resumable offsets, or the store's own in-process bus by default.
    """

    def __init__(self, store, bus=None, registry=metrics):
        self.store = store
        self.bus = bus if bus is not None else self._store_bus(store)
        if self.bus is None:
            raise ValueError("no bus: pass bus= or use a store with one")
        self._registry = registry
        self._queries: dict[str, ContinuousQuery] = {}
        self._attached: set[str] = set()
        self._lock = threading.Lock()
        # one StandingFilterSet per type; types whose schema the
        # publisher cannot read stay host-only FOREVER (a set created
        # late would miss earlier registrations)
        self._sets: dict = {}
        self._host_only: set[str] = set()

    @staticmethod
    def _store_bus(store):
        bus = getattr(store, "bus", None)
        if bus is None:
            live = getattr(store, "_live", None)
            bus = getattr(live, "bus", None)
        return bus

    def register(self, name: str, type_name: str,
                 ecql: str = "INCLUDE") -> ContinuousQuery:
        """Add a standing query; raises on a duplicate name or an
        unparseable filter (fail at registration, not per-message)."""
        cq = ContinuousQuery(name, type_name, ecql)
        with self._lock:
            if name in self._queries:
                raise ValueError(f"continuous query {name!r} exists")
            fset = self._set_for(type_name)
            if fset is not None:
                fset.register(name, cq.filter)
            self._queries[name] = cq
            attach = type_name not in self._attached
            if attach:
                self._attached.add(type_name)
            n = len(self._queries)
        if attach:
            self._attach(type_name)
        self._registry.gauge("cq.registered", n)
        return cq

    def unregister(self, name: str):
        """Drop a standing query; detaches the store listener when the
        last query for its type goes (a publisher must not keep
        evaluating types nobody watches)."""
        with self._lock:
            cq = self._queries.pop(name, None)
            detach = None
            if cq is not None:
                fset = self._sets.get(cq.type_name)
                if fset is not None:
                    fset.unregister(name)
                if cq.type_name in self._attached and not any(
                        q.type_name == cq.type_name
                        for q in self._queries.values()):
                    self._attached.discard(cq.type_name)
                    detach = cq.type_name
            n = len(self._queries)
        if detach is not None:
            self._detach(detach)
        self._registry.gauge("cq.registered", n)

    def close(self):
        """Detach every store listener and drop all queries; the
        publisher stops evaluating entirely."""
        with self._lock:
            attached = list(self._attached)
            self._attached.clear()
            self._queries.clear()
            self._sets.clear()
            self._host_only.clear()
        for type_name in attached:
            self._detach(type_name)
        self._registry.gauge("cq.registered", 0)

    def queries(self) -> list[ContinuousQuery]:
        with self._lock:
            return list(self._queries.values())

    def device_stats(self) -> list[dict]:
        """Per-type StandingFilterSet stats (empty when every type is
        on the host path)."""
        with self._lock:
            return [s.stats() for s in self._sets.values()]

    def _set_for(self, type_name: str):
        """The type's StandingFilterSet, created on first registration;
        None (host-only, sticky) when the schema is unreadable —
        e.g. a bus-fed store that has not seen the type yet."""
        if type_name in self._host_only:
            return None
        fset = self._sets.get(type_name)
        if fset is None:
            from ..scan.standing import StandingFilterSet
            try:
                sft = self.store.get_schema(type_name)
            except Exception:
                self._host_only.add(type_name)
                return None
            fset = StandingFilterSet(sft, registry=self._registry,
                                     device=self._store_device())
            self._sets[type_name] = fset
        return fset

    def _store_device(self):
        """The device of the store's cache: the standing set's tables
        live beside the columns the store scans."""
        dev = getattr(self.store, "device", None)
        if dev is None:
            raise ValueError(f"a {type(self.store).__name__} names no "
                             f"device for its standing filters")
        return dev

    @staticmethod
    def _takes_type(fn) -> bool:
        # LiveDataStore.add_listener(type_name, fn);
        # StreamDataStore.add_listener(fn) — bound to its one type
        import inspect
        return len(inspect.signature(fn).parameters) >= 2

    def _attach(self, type_name: str):
        add = self.store.add_listener
        if self._takes_type(add):
            add(type_name, self._on_message)
        else:
            add(self._on_message)

    def _detach(self, type_name: str):
        remove = getattr(self.store, "remove_listener", None)
        if remove is None:
            return
        if self._takes_type(remove):
            remove(type_name, self._on_message)
        else:
            remove(self._on_message)

    # -- the push path -------------------------------------------------------

    def _on_message(self, msg: GeoMessage):
        with self._lock:
            cqs = [cq for cq in self._queries.values()
                   if cq.type_name == msg.type_name]
            fset = self._sets.get(msg.type_name)
        if not cqs:
            return
        if msg.kind == "create" and msg.batch is not None and msg.batch.n:
            rows = max(CQ_PUBLISH_BATCH_ROWS.as_int() or 8192, 1)
            # one rows x filters device dispatch for the whole standing
            # population; an error is counted and reaches the writer
            # (no host fallback). A host-only type runs the host loop.
            device_hits = None
            if fset is not None and len(fset):
                try:
                    device_hits = fset.dispatch(msg.batch)
                except Exception:
                    self._registry.counter("cq.device.errors")
                    raise
            for cq in cqs:
                if device_hits is not None:
                    hits = device_hits.get(
                        cq.name, np.empty(0, dtype=np.int64))
                else:
                    mask = evaluate(cq.filter, msg.batch)
                    hits = np.flatnonzero(mask)
                if not len(hits):
                    continue
                cq.matched += len(hits)
                self._registry.counter("cq.rows.matched", len(hits))
                sub = (msg.batch if len(hits) == msg.batch.n
                       else msg.batch.take(hits))
                vis = None
                if msg.visibilities is not None:
                    vis = tuple(np.asarray(msg.visibilities,
                                           dtype=object)[hits])
                for start in range(0, sub.n, rows):
                    piece = (sub if sub.n <= rows else sub.take(
                        np.arange(start, min(start + rows, sub.n))))
                    pvis = (None if vis is None
                            else vis[start:start + rows])
                    self.bus.publish(cq.topic, GeoMessage(
                        "create", msg.type_name, piece,
                        timestamp_ms=msg.timestamp_ms,
                        visibilities=pvis))
                    cq.published += 1
                    self._registry.counter("cq.messages.published")
        elif msg.kind in ("delete", "clear"):
            # retractions forward verbatim: the filter cannot run on
            # ids alone, and deleting absent ids downstream is a no-op
            for cq in cqs:
                self.bus.publish(cq.topic, msg)
                cq.published += 1
                self._registry.counter("cq.messages.published")


class ContinuousQuerySubscriber:
    """The consuming half of one continuous query.

    Connects its own consumer group (``cq.<name>.<group>``) so each
    subscriber's offsets commit independently; ``poll`` drains new
    deltas (long-polling the broker with ``wait_s``), handlers run
    before the offset advances, and the SocketBus channel reconnects
    through broker restarts — with a persistent broker (``root=``)
    resume is gapless and duplicate-free from the last commit.
    """

    def __init__(self, name: str, host: str | None = None,
                 port: int | None = None, group: str = "default",
                 bus=None, timeout_s: float = 30.0):
        self.name = name
        self.topic = cq_topic(name)
        if bus is None:
            if host is None or port is None:
                raise ValueError("pass host/port or bus=")
            from .socketbus import SocketBus
            bus = SocketBus(host, port, group=f"cq.{name}.{group}",
                            timeout_s=timeout_s)
            self._owns_bus = True
        else:
            self._owns_bus = False
        self.bus = bus
        self._handlers: list[Callable[[GeoMessage], None]] = []
        bus.subscribe(self.topic, self._deliver)

    def _deliver(self, msg: GeoMessage):
        for fn in self._handlers:
            fn(msg)

    def on_message(self, fn: Callable[[GeoMessage], None]):
        """Raw delivery: fn(GeoMessage) for every delta (create /
        delete / clear)."""
        self._handlers.append(fn)
        return fn

    def on_batch(self, fn):
        """fn(FeatureBatch) for each create delta's matching rows."""
        def wrap(msg: GeoMessage):
            if msg.kind == "create" and msg.batch is not None:
                fn(msg.batch)
        self._handlers.append(wrap)
        return fn

    def on_bin(self, fn, track: str | None = None,
               label: str | None = None):
        """fn(bytes) — each create delta BIN-encoded over the wire
        format of scan/aggregations.py (bin-over-the-wire push)."""
        from ..scan.aggregations import encode_bin_batch
        def wrap(msg: GeoMessage):
            if msg.kind == "create" and msg.batch is not None \
                    and msg.batch.n:
                fn(encode_bin_batch(msg.batch.sft, msg.batch.ids,
                                    msg.batch, track=track, label=label))
        self._handlers.append(wrap)
        return fn

    def poll(self, wait_s: float = 0.0,
             max_messages: int | None = None) -> int:
        """Drain new deltas; no-op for a push bus (in-process
        MessageBus delivers synchronously on publish)."""
        poll = getattr(self.bus, "poll", None)
        if poll is None:
            return 0
        return poll(max_messages=max_messages, wait_s=wait_s)

    def offset(self) -> int:
        """Last consumed sequence on this query's topic (committed
        server-side for SocketBus groups)."""
        off = getattr(self.bus, "offset", None)
        return off(self.topic) if callable(off) else 0

    def close(self):
        if self._owns_bus:
            close = getattr(self.bus, "close", None)
            if callable(close):
                close()
