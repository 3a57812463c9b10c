"""The materialized result cache: version-stamped entries, LRU byte
budget, single-flight coalescing.

An entry is ``(type_name, plan key) -> (version, payload)`` where
``version`` is the store's pushdown version for the type — the WAL LSN
on durable stores, a store-local mutation counter otherwise. The
version is read BEFORE compute: a write landing mid-compute stamps the
result with the older version, leaving it unreachable at the new one (a
wasted recompute, never a stale serve).

Single-flight: concurrent misses on one ``(type, key, version)`` elect
a leader that computes once; followers park on an event and decode the
leader's payload. They never touch the store's op lock, so a thundering
herd of identical cold tiles costs exactly one kernel launch and no lock
convoy.

Payloads are stored in an immutable-safe form (the caller's ``encode``)
and every hit decodes a private copy, so a consumer mutating its result
(an in-place ``Stat.merge``, a caller scribbling on a grid) can never
corrupt the cached original.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..metrics import metrics
from ..utils.properties import SystemProperty

__all__ = ["ResultCache", "CACHE_ENABLED", "CACHE_MAX_BYTES"]

# the operator's switch for the materialized pushdown cache (off: every
# request recomputes; both settings run the same compute)
CACHE_ENABLED = SystemProperty("geomesa.cache.enabled", "true")
# LRU byte budget across one store's cached payloads
CACHE_MAX_BYTES = SystemProperty("geomesa.cache.max.bytes",
                                 str(256 * 1024 * 1024))

# a wedged leader must not park followers forever; past this they
# recompute for themselves
_FLIGHT_WAIT_S = 600.0


def _nbytes(stored) -> int:
    if stored is None:
        return 0
    if isinstance(stored, (bytes, bytearray)):
        return len(stored)
    nb = getattr(stored, "nbytes", None)
    if nb is not None:
        return int(nb)
    import sys
    return sys.getsizeof(stored)


class _Entry:
    __slots__ = ("version", "stored", "nbytes", "hits", "compute",
                 "encode", "tenant")

    def __init__(self, version, stored, nbytes, compute, encode,
                 tenant=None):
        self.version = version
        self.stored = stored
        self.nbytes = nbytes
        self.hits = 0
        self.compute = compute
        self.encode = encode
        # installing tenant (None with QoS off): per-tenant byte
        # budgets evict the owning tenant's LRU entries only
        self.tenant = tenant


class _Flight:
    __slots__ = ("event", "stored", "error")

    def __init__(self):
        self.event = threading.Event()
        self.stored = None
        self.error = None


class ResultCache:
    """Per-store cache; ``version_fn(type_name)`` is the store's
    pushdown-version accessor (the LSN face of invalidation)."""

    def __init__(self, version_fn, registry=metrics):
        self._version_fn = version_fn
        self._registry = registry
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._inflight: dict[tuple, _Flight] = {}
        self._bytes = 0
        self._tenant_bytes: dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.singleflight_waits = 0
        self.refreshes = 0
        self.invalidations = 0

    @staticmethod
    def enabled() -> bool:
        return bool(CACHE_ENABLED.as_bool())

    @staticmethod
    def max_bytes() -> int:
        return int(CACHE_MAX_BYTES.as_int() or 0)

    # -- the serving path --------------------------------------------------

    def get_or_compute(self, type_name: str, key: str, compute,
                       encode=None, decode=None):
        """Serve ``(type_name, key)`` at the type's current version:
        a memoized payload when the version is unchanged, one
        single-flighted ``compute()`` otherwise."""
        if not self.enabled():
            return compute()
        # tenant scoping (tenants plane): the plan key is suffixed with
        # the tenant's VISIBILITY scope, so tenants with different
        # visibilities never share an entry while same-visibility
        # tenants still deduplicate. QoS off -> tenant is None and the
        # key is byte-identical to the pre-QoS cache.
        from ..tenants import active_tenant, tenant_registry
        tenant = active_tenant()
        if tenant is not None:
            key = f"{key}|qosvis={tenant_registry.policy(tenant).visibility}"
        version = self._version_fn(type_name)
        k = (type_name, key)
        fk = (type_name, key, version)
        with self._lock:
            e = self._entries.get(k)
            if e is not None and e.version == version:
                e.hits += 1
                self.hits += 1
                self._entries.move_to_end(k)
                stored = e.stored
                leader = None
            else:
                fl = self._inflight.get(fk)
                if fl is None:
                    fl = self._inflight[fk] = _Flight()
                    leader = True
                else:
                    leader = False
                    self.singleflight_waits += 1
        from ..obs import annotate, set_flag
        if leader is None:
            self._registry.counter("cache.hits")
            annotate("cache.hit", type=type_name)
            set_flag("cache_hit")
            return decode(stored) if decode is not None else stored
        if leader is False:
            # follower: park on the leader's flight, decode a private
            # copy of its payload: no store lock, no kernel launch
            self._registry.counter("cache.singleflight.waits")
            annotate("cache.singleflight.follower", type=type_name)
            fl.event.wait(_FLIGHT_WAIT_S)
            if fl.error is not None or not fl.event.is_set() \
                    or fl.stored is None:
                return compute()
            return decode(fl.stored) if decode is not None else fl.stored
        # leader: compute (the store's own synchronization applies),
        # publish to followers, install the entry
        self._registry.counter("cache.misses")
        annotate("cache.miss", type=type_name)
        with self._lock:
            self.misses += 1
        try:
            value = compute()
        except BaseException as ex:
            fl.error = ex
            fl.event.set()
            with self._lock:
                self._inflight.pop(fk, None)
            raise
        stored = None
        try:
            stored = encode(value) if encode is not None else value
        except Exception:
            # unencodable payload: serve it, just don't memoize
            self._registry.counter("cache.encode_errors")
        if stored is not None:
            self._install(k, version, stored, compute, encode,
                          tenant=tenant)
        fl.stored = stored
        fl.event.set()
        with self._lock:
            self._inflight.pop(fk, None)
        return value

    def _install(self, k, version, stored, compute, encode, tenant=None):
        nbytes = _nbytes(stored)
        budget = self.max_bytes()
        tenant_budget = None
        if tenant is not None:
            from ..tenants import tenant_registry
            tenant_budget = tenant_registry.policy(tenant).cache_max_bytes
        with self._lock:
            old = self._entries.pop(k, None)
            if old is not None:
                self._drop_bytes_locked(old)
            if (budget and nbytes > budget) or \
                    (tenant_budget and nbytes > tenant_budget):
                # a single payload larger than the whole budget would
                # evict everything and still not fit
                self._gauges_locked()
                return
            e = _Entry(version, stored, nbytes, compute, encode,
                       tenant=tenant)
            if old is not None:
                e.hits = old.hits  # heat survives version bumps
            self._entries[k] = e
            self._add_bytes_locked(e)
            while budget and self._bytes > budget and self._entries:
                _, ev = self._entries.popitem(last=False)
                self._drop_bytes_locked(ev)
                self.evictions += 1
                self._registry.counter("cache.evictions")
            # per-tenant byte budget: evict THIS tenant's LRU entries
            # until it fits — other tenants' entries are untouchable
            while tenant_budget and \
                    self._tenant_bytes.get(tenant, 0) > tenant_budget:
                victim = next((vk for vk, ve in self._entries.items()
                               if ve.tenant == tenant and vk != k), None)
                if victim is None:
                    break
                self._drop_bytes_locked(self._entries.pop(victim))
                self.evictions += 1
                self._registry.counter("cache.evictions")
                from ..tenants import tenant_label
                self._registry.counter(
                    "qos.cache.evictions",
                    labels={"tenant": tenant_label(tenant)})
            self._gauges_locked()

    def _add_bytes_locked(self, e: _Entry):
        self._bytes += e.nbytes
        if e.tenant is not None:
            self._tenant_bytes[e.tenant] = \
                self._tenant_bytes.get(e.tenant, 0) + e.nbytes

    def _drop_bytes_locked(self, e: _Entry):
        self._bytes -= e.nbytes
        if e.tenant is not None:
            left = self._tenant_bytes.get(e.tenant, 0) - e.nbytes
            if left > 0:
                self._tenant_bytes[e.tenant] = left
            else:
                self._tenant_bytes.pop(e.tenant, None)

    def _gauges_locked(self):
        self._registry.gauge("cache.bytes", self._bytes)
        self._registry.gauge("cache.entries", len(self._entries))

    # -- maintenance -------------------------------------------------------

    def invalidate(self, type_name: str | None = None) -> int:
        """Drop entries (one type or all); returns the dropped count.
        Version bumps already make stale entries unreachable — this is
        the explicit memory-reclaim / operator face."""
        with self._lock:
            if type_name is None:
                n = len(self._entries)
                self._entries.clear()
                self._bytes = 0
                self._tenant_bytes.clear()
            else:
                keys = [k for k in self._entries if k[0] == type_name]
                n = len(keys)
                for k in keys:
                    self._drop_bytes_locked(self._entries.pop(k))
            self.invalidations += n
            self._gauges_locked()
        if n:
            self._registry.counter("cache.invalidated_entries", n)
        return n

    def refresh_hot(self, top_k: int = 8) -> int:
        """Re-materialize the hottest stale entries at their type's
        current version (the background refresher's unit). Returns the
        number refreshed."""
        if not self.enabled():
            return 0
        with self._lock:
            hottest = sorted(self._entries.items(),
                             key=lambda kv: kv[1].hits,
                             reverse=True)[:max(int(top_k), 0)]
        n = 0
        for (tn, key), e in hottest:
            version = self._version_fn(tn)
            if e.version == version:
                continue
            try:
                value = e.compute()
                stored = (e.encode(value) if e.encode is not None
                          else value)
            except KeyError:
                # schema dropped under us: reclaim its entries
                self.invalidate(tn)
                continue
            except Exception:
                self._registry.counter("cache.refresh.errors")
                continue
            self._install((tn, key), version, stored, e.compute, e.encode,
                          tenant=e.tenant)
            with self._lock:
                self.refreshes += 1
            self._registry.counter("cache.refreshes")
            n += 1
        return n

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            per_type: dict[str, int] = {}
            for (tn, _), _e in self._entries.items():
                per_type[tn] = per_type.get(tn, 0) + 1
            tenant_bytes = dict(self._tenant_bytes)
            return {"enabled": self.enabled(),
                    "entries": len(self._entries),
                    "bytes": self._bytes,
                    "tenant_bytes": tenant_bytes,
                    "max_bytes": self.max_bytes(),
                    "hits": self.hits,
                    "misses": self.misses,
                    "evictions": self.evictions,
                    "singleflight_waits": self.singleflight_waits,
                    "refreshes": self.refreshes,
                    "invalidations": self.invalidations,
                    "types": per_type}
