"""Process-wide batcher registry: one fused dispatch stream per store.

The batcher only pays off when callers actually share it: two tiers
that each build a private ``QueryBatcher`` over the same store dispatch
separately — half the coalescing, and two plan shape-class tables
warming independently. The registry is the process-wide rendezvous:
every caller that asks for a batcher for the "same store" gets the SAME
instance, so web-tier and embedded queries coalesce into one fused
dispatch and share one warmed plan table.

"Same store" is decided by a durable identity, not object identity:

- a store with a durable journal -> ``("durable", journal.root)``, so
  the batcher SURVIVES a store reopen (close + reopen of the same
  directory rebinds the existing batcher to the new store object; the
  plan table stays valid because its keys carry index_version and the
  padded data cap);
- a ``RemoteDataStore`` -> ``("remote", host, port)``, so every client
  of one server endpoint coalesces;
- anything else -> ``("object", id(store))`` — a pure in-memory store
  has no identity beyond the object, and two of them must never share
  a batcher.

Knob: ``geomesa.batcher.registry.enabled`` (default true) —
``shared_batcher`` returns a private, unregistered batcher when off,
restoring the old per-caller behavior.

Metrics: ``batcher.registry.size`` gauge plus the per-type
``batcher.queue_depth.<type>`` gauges the underlying batchers emit;
``queue_depths()`` aggregates every registered batcher's pending
queues for the ``/rest/health`` detail.
"""

from __future__ import annotations

import threading

from ..metrics import metrics
from ..utils.properties import SystemProperty
from .batcher import QueryBatcher

__all__ = ["BatcherRegistry", "batcher_registry", "shared_batcher",
           "store_identity", "BATCHER_REGISTRY_ENABLED"]

BATCHER_REGISTRY_ENABLED = SystemProperty(
    "geomesa.batcher.registry.enabled", "true")


def store_identity(store) -> tuple:
    """The durable identity deciding which callers share a batcher."""
    journal = getattr(store, "journal", None)
    root = getattr(journal, "root", None)
    if root:
        return ("durable", str(root))
    host = getattr(store, "host", None)
    port = getattr(store, "port", None)
    if host is not None and port is not None:
        return ("remote", str(host), int(port))
    return ("object", id(store))


class BatcherRegistry:
    """Identity-keyed ``QueryBatcher`` singletons.

    ``get(store)`` returns the one batcher for the store's identity,
    creating it on first use and REBINDING it to the new store object
    when the same durable identity is reopened — in-flight leaders
    drain against the old object; new admissions dispatch against the
    new one. Thread-safe; strong references (a handful of stores per
    process, each batcher is a few dicts)."""

    def __init__(self, registry=metrics):
        self._registry = registry
        self._lock = threading.Lock()
        self._batchers: dict[tuple, QueryBatcher] = {}

    def get(self, store, **batcher_kwargs) -> QueryBatcher:
        key = store_identity(store)
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                b = self._batchers[key] = QueryBatcher(
                    store, registry=self._registry, **batcher_kwargs)
            elif b.store is not store:
                # same durable identity, reopened store object: keep
                # the warmed plan cache and cost EWMAs, serve from the
                # live store
                b.store = store
            self._registry.gauge("batcher.registry.size",
                                 len(self._batchers))
            return b

    def queue_depths(self) -> dict[str, int]:
        """Pending-queue depth per type across every registered
        batcher (summed when two stores share a type name)."""
        with self._lock:
            batchers = list(self._batchers.values())
        depths: dict[str, int] = {}
        for b in batchers:
            for k, v in b.queue_depths().items():
                depths[k] = depths.get(k, 0) + v
        return depths

    def stats(self) -> dict:
        with self._lock:
            batchers = list(self._batchers.items())
        return {"size": len(batchers),
                "stores": [list(map(str, k)) for k, _ in batchers]}

    def clear(self):
        """Drop every registered batcher (tests; also the only way to
        release a store an embedded caller is done with)."""
        with self._lock:
            self._batchers.clear()


batcher_registry = BatcherRegistry()


def shared_batcher(store, **batcher_kwargs) -> QueryBatcher:
    """The process-wide batcher for ``store`` — or a private one when
    ``geomesa.batcher.registry.enabled`` is off."""
    enabled = str(BATCHER_REGISTRY_ENABLED.get()).lower() in (
        "true", "1", "yes")
    if not enabled:
        return QueryBatcher(store, **batcher_kwargs)
    return batcher_registry.get(store, **batcher_kwargs)
