"""ReplicatedDataStore: one store façade over a primary + N replicas.

Routing rules:

- WRITES go to the primary, then block until ``geomesa.repl.ack.
  replicas`` replicas have applied the write's LSN (bounded by
  ``geomesa.repl.ack.timeout.s``). A write that returns is
  *acknowledged*: its LSN is inside at least that many replica
  prefixes, so promotion of the most-caught-up replica can never
  lose it.
- READS fan across replicas round-robin under per-query staleness
  bounds — a replica is eligible when its LSN lag against the best
  known primary position is <= ``max_lag_lsn`` AND it was fully caught
  up within the last ``max_lag_s`` seconds AND its breaker admits the
  call. No eligible replica -> the primary serves the read (the
  bounded-staleness contract: results are never older than the bound,
  they just cost primary capacity).
- FAILOVER: a health probe against the primary (run every
  ``geomesa.repl.probe.ms``) that fails ``geomesa.repl.probe.failures``
  times in a row triggers promotion (when ``geomesa.repl.promote.auto``)
  of the attached replica with the highest applied LSN. Remaining
  replicas are detached — they were following a dead primary and
  cannot converge with the new one; re-attach requires a shipper on
  the new primary.

Per-replica read failures feed a ``BreakerBoard`` (and its latency
EWMA), so a wedged replica fast-fails out of the rotation the same way
a dead REST endpoint does.
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics
from ..resilience.breaker import BreakerBoard, CircuitOpenError
from ..store.api import DataStore
from ..utils.properties import SystemProperty
from .replica import Replica

__all__ = ["ReplicatedDataStore", "ReplicationAckTimeout",
           "ReplicationAckLost",
           "REPL_MAX_LAG_LSN", "REPL_MAX_LAG_S", "REPL_ACK_REPLICAS",
           "REPL_ACK_TIMEOUT_S", "REPL_PROMOTE_AUTO", "REPL_PROBE_MS",
           "REPL_PROBE_FAILURES"]

# default per-query staleness bounds (overridable per call)
REPL_MAX_LAG_LSN = SystemProperty("geomesa.repl.max.lag.lsn", "1000")
REPL_MAX_LAG_S = SystemProperty("geomesa.repl.max.lag.s", "10")
# how many replicas must hold a write before it is acknowledged
REPL_ACK_REPLICAS = SystemProperty("geomesa.repl.ack.replicas", "1")
REPL_ACK_TIMEOUT_S = SystemProperty("geomesa.repl.ack.timeout.s", "10")
# failure detector + promotion
REPL_PROMOTE_AUTO = SystemProperty("geomesa.repl.promote.auto", "true")
REPL_PROBE_MS = SystemProperty("geomesa.repl.probe.ms", "250")
REPL_PROBE_FAILURES = SystemProperty("geomesa.repl.probe.failures", "3")


class ReplicationAckTimeout(TimeoutError):
    """The primary accepted a write but too few replicas applied it in
    time. The write IS on the primary (and its WAL) — it is just not
    yet replication-acknowledged, so it may be lost if the primary
    fails before a replica catches up. Not retryable as-is: a blind
    retry would duplicate the write."""

    retryable = False


class ReplicationAckLost(ConnectionError):
    """A failover completed while this write awaited replication, and
    the promoted replica's applied prefix does NOT cover it: the write
    exists only on the deposed primary. Acking it would violate the
    zero-acked-loss contract — a zombie primary (listener gone, an
    established connection still accepting writes: the asymmetric
    partition a chaos kill produces) would otherwise keep collecting
    acks that the new primary never saw. Not retryable blindly: the
    old primary may still hold the write, so a retry after it rejoins
    could duplicate."""

    retryable = False


class ReplicatedDataStore(DataStore):
    """Primary + replicas behind one DataStore surface.

    ``primary`` is any DataStore (typically durable, with a
    ``WalShipper`` next to it — possibly reached via RemoteDataStore);
    ``replicas`` are ``Replica`` instances attached to that shipper.
    ``probe`` is a zero-arg callable returning truthy when the primary
    is healthy; defaults to ``primary.probe_health`` when present
    (RemoteDataStore has one), else no probing.
    """

    def __init__(self, primary: DataStore, replicas=(),
                 probe=None, ack_replicas: int | None = None,
                 max_lag_lsn: int | None = None,
                 max_lag_s: float | None = None,
                 auto_promote: bool | None = None,
                 probe_ms: float | None = None,
                 probe_failures: int | None = None,
                 registry=metrics, audit=None):
        self.audit = audit  # AuditLogger or None (global fallback)
        self.primary = primary
        self._replicas: list[Replica] = list(replicas)
        self._registry = registry
        self._breakers = BreakerBoard(registry=registry)
        self.ack_replicas = (REPL_ACK_REPLICAS.as_int() or 0
                             if ack_replicas is None else int(ack_replicas))
        self.ack_timeout_s = REPL_ACK_TIMEOUT_S.as_float() or 10.0
        self.max_lag_lsn = (REPL_MAX_LAG_LSN.as_int()
                            if max_lag_lsn is None else int(max_lag_lsn))
        self.max_lag_s = (REPL_MAX_LAG_S.as_float()
                          if max_lag_s is None else float(max_lag_s))
        self._auto_promote = (REPL_PROMOTE_AUTO.as_bool()
                              if auto_promote is None else bool(auto_promote))
        self._probe_s = ((REPL_PROBE_MS.as_float() or 250.0)
                         if probe_ms is None else float(probe_ms)) / 1e3
        self._probe_failures = (REPL_PROBE_FAILURES.as_int() or 3
                                if probe_failures is None
                                else int(probe_failures))
        self._lock = threading.RLock()
        self._ack_cond = threading.Condition()
        self._last_write_lsn = 0
        self._rr = 0                     # round-robin cursor
        self._promoted_to: str | None = None
        # applied prefix of the promoted replica, frozen at the moment
        # its stream was cut: the durability watermark acks compare
        # against once a failover has happened (None = no failover yet,
        # or promotion in flight and the cut point is not known yet)
        self._promote_cutoff: int | None = None
        self._failover_s: float | None = None
        self._primary_healthy = True
        self._probe = probe if probe is not None else getattr(
            primary, "probe_health", None)
        for r in self._replicas:
            r.on_apply = self._on_replica_apply
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        if self._probe is not None:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="repl-probe", daemon=True)
            self._probe_thread.start()

    @property
    def device(self):
        """The primary's device (None for a remote primary)."""
        return getattr(self.primary, "device", None)

    # -- replica bookkeeping -------------------------------------------------

    def _on_replica_apply(self, _replica):
        with self._ack_cond:
            self._ack_cond.notify_all()

    def _attached(self) -> list[Replica]:
        with self._lock:
            return [r for r in self._replicas if r.attached]

    def _primary_lsn_estimate(self) -> int:
        """Best known primary log position: the local journal when the
        primary is in-process, else the max of our own acked writes and
        what replicas heard in stream heartbeats."""
        best = self._last_write_lsn
        journal = getattr(self.primary, "journal", None)
        if journal is not None:
            best = max(best, journal.wal.last_lsn)
        with self._lock:
            for r in self._replicas:
                best = max(best, r.primary_last_lsn)
        return best

    # -- write path ----------------------------------------------------------

    def _write_lsn(self, returned) -> int | None:
        """The WAL position of the write just issued: the server-stamped
        LSN for remote primaries, the local journal tail otherwise."""
        if isinstance(returned, int):
            return returned
        journal = getattr(self.primary, "journal", None)
        if journal is not None:
            return journal.wal.last_lsn
        return None

    def _ack_state(self, lsn: int):
        """One consistent snapshot deciding an ack wait. Returns
        ``True`` (acked), ``False`` (keep waiting), or raises.
        Promotion is checked FIRST and under the same lock that
        ``promote()`` mutates: once a failover has begun, replica
        counts no longer mean anything (``_replicas`` is cleared), and
        a write is durable iff the promoted replica's frozen applied
        prefix covers its lsn — never because ``need`` degraded to 0."""
        with self._lock:
            promoted = self._promoted_to is not None
            cutoff = self._promote_cutoff
            attached = [r for r in self._replicas if r.attached]
        if promoted:
            if cutoff is None:
                return False  # promotion in flight; cut point pending
            if lsn <= cutoff:
                return True
            self._registry.counter("replication.ack.lost")
            raise ReplicationAckLost(
                f"write lsn {lsn} was on the deposed primary only: "
                f"failover promoted at applied lsn {cutoff}")
        need = min(self.ack_replicas, len(attached))
        if need <= 0:
            return True
        return sum(1 for r in attached if r.applied_lsn >= lsn) >= need

    def _await_ack(self, lsn: int | None):
        if not lsn:
            return
        with self._lock:
            self._last_write_lsn = max(self._last_write_lsn, lsn)
        if self._ack_state(lsn):
            return
        self._registry.counter("replication.ack.waits")
        deadline = time.monotonic() + self.ack_timeout_s
        with self._ack_cond:
            while True:
                if self._ack_state(lsn):
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    self._registry.counter("replication.ack.timeouts")
                    raise ReplicationAckTimeout(
                        f"write lsn {lsn}: not enough replicas applied "
                        f"within {self.ack_timeout_s}s")
                self._ack_cond.wait(left)

    def create_schema(self, sft, spec=None):
        out = self.primary.create_schema(sft, spec)
        self._await_ack(self._write_lsn(out))
        return out

    def remove_schema(self, type_name: str):
        out = self.primary.remove_schema(type_name)
        self._await_ack(self._write_lsn(out))
        return out

    def write(self, type_name: str, batch, **kwargs):
        out = self.primary.write(type_name, batch, **kwargs)
        self._await_ack(self._write_lsn(out))
        return out

    def delete(self, type_name: str, ids):
        out = self.primary.delete(type_name, ids)
        self._await_ack(self._write_lsn(out))
        return out

    # -- read path -----------------------------------------------------------

    def _eligible(self, max_lag_lsn, max_lag_s) -> list[Replica]:
        p_lsn = self._primary_lsn_estimate()
        out = []
        with self._lock:
            replicas = list(self._replicas)
            start = self._rr
            self._rr += 1
        for i in range(len(replicas)):
            r = replicas[(start + i) % len(replicas)]
            if not r.attached:
                continue
            if max_lag_lsn is not None and r.lag_lsn(p_lsn) > max_lag_lsn:
                continue
            if max_lag_s is not None and r.lag_s() > max_lag_s:
                continue
            out.append(r)
        return out

    def _read(self, op, *args, max_lag_lsn=None, max_lag_s=None, **kwargs):
        bound_lsn = self.max_lag_lsn if max_lag_lsn is None else max_lag_lsn
        bound_s = self.max_lag_s if max_lag_s is None else max_lag_s
        candidates = self._eligible(bound_lsn, bound_s)
        for r in candidates:
            breaker = self._breakers.get(r.name)
            try:
                breaker.acquire()
            except CircuitOpenError:
                continue
            t0 = time.perf_counter()
            try:
                out = getattr(r, op)(*args, **kwargs)
            except Exception:
                breaker.failure()
                continue
            breaker.success()
            self._breakers.observe(r.name, time.perf_counter() - t0)
            self._registry.counter("replication.reads.replica")
            return out
        # staleness bound violated everywhere (or every replica failed):
        # the primary is the freshness backstop
        self._registry.counter(
            "replication.reads.primary" if not self._replicas
            else "replication.reads.fallback")
        return getattr(self.primary, op)(*args, **kwargs)

    def query(self, q, type_name=None, explain_out=None,
              max_lag_lsn=None, max_lag_s=None):
        from ..audit import audit_query, delegated_scope
        t0 = time.perf_counter()
        with delegated_scope():
            out = self._read("query", q, type_name,
                             explain_out=explain_out,
                             max_lag_lsn=max_lag_lsn,
                             max_lag_s=max_lag_s)
        audit_query(self.audit, "replicated",
                    getattr(q, "type_name", None) or type_name or "",
                    str(getattr(q, "filter", q)),
                    getattr(q, "hints", {}) or {}, 0.0,
                    (time.perf_counter() - t0) * 1000,
                    int(getattr(out, "n", 0)), index="replicated")
        return out

    def query_stream(self, q, type_name=None, batch_rows=None,
                     max_lag_lsn=None, max_lag_s=None):
        """Streamed read through the same bounded-staleness routing:
        the chosen member's batch generator is returned as-is. Errors
        *opening* the stream fail over to the next eligible member;
        mid-stream errors surface typed to the consumer (failing over
        mid-stream could re-deliver rows)."""
        return self._read("query_stream", q, type_name,
                          batch_rows=batch_rows,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)

    def query_count(self, q, type_name=None,
                    max_lag_lsn=None, max_lag_s=None) -> int:
        from ..audit import audit_query, delegated_scope
        t0 = time.perf_counter()
        with delegated_scope():
            n = self._read("query_count", q, type_name,
                           max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)
        audit_query(self.audit, "replicated",
                    getattr(q, "type_name", None) or type_name or "",
                    str(getattr(q, "filter", q)),
                    getattr(q, "hints", {}) or {}, 0.0,
                    (time.perf_counter() - t0) * 1000, int(n),
                    index="replicated")
        return n

    def count(self, type_name: str,
              max_lag_lsn=None, max_lag_s=None) -> int:
        return self._read("count", type_name,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)

    # aggregate scans ride the same bounded-staleness fan-out: the
    # cluster tier scatters these per shard group, and a replica that
    # satisfies the lag bound serves them exactly (sketches/grids/bin
    # chunks over its applied prefix)
    def stats_query(self, type_name: str, stat_spec: str, ecql=None,
                    max_lag_lsn=None, max_lag_s=None):
        return self._read("stats_query", type_name, stat_spec, ecql,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)

    def density(self, type_name: str, ecql, bbox, width: int, height: int,
                weight_attr: str | None = None,
                max_lag_lsn=None, max_lag_s=None):
        kwargs = {} if weight_attr is None else {"weight_attr": weight_attr}
        return self._read("density", type_name, ecql, bbox, width, height,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s,
                          **kwargs)

    def bin_query(self, type_name: str, ecql, track: str | None = None,
                  label: str | None = None, sort: bool = False,
                  max_lag_lsn=None, max_lag_s=None) -> bytes:
        return self._read("bin_query", type_name, ecql, track=track,
                          label=label, sort=sort,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None,
                  max_lag_lsn=None, max_lag_s=None) -> bytes:
        return self._read("arrow_ipc", type_name, ecql, sort_by=sort_by,
                          max_lag_lsn=max_lag_lsn, max_lag_s=max_lag_s)

    # -- materialized-cache faces (aggregate view over the group) ------------
    # No ``pushdown_version`` here on purpose: reads fan out to whichever
    # member satisfies the lag bound, so there is no single exact version
    # to stamp an ETag with — that face stays on the members.

    def cache_status(self) -> dict:
        members: dict[str, dict] = {}
        cs = getattr(self.primary, "cache_status", None)
        if callable(cs):
            try:
                members["primary"] = cs()
            except Exception as ex:  # remote primary may be down
                members["primary"] = {"error": str(ex)}
        for r in self._replicas:
            try:
                members[r.name] = r.cache_status()
            except Exception as ex:
                members[r.name] = {"error": str(ex)}
        return {"role": "replicated", "max_lag_lsn": self.max_lag_lsn,
                "members": members}

    def invalidate_cache(self, type_name: str | None = None) -> int:
        n = 0
        inv = getattr(self.primary, "invalidate_cache", None)
        if callable(inv):
            try:
                n += int(inv(type_name))
            except Exception:
                pass
        for r in self._replicas:
            try:
                n += int(r.invalidate_cache(type_name))
            except Exception:
                pass
        return n

    def get_schema(self, type_name: str):
        try:
            return self.primary.get_schema(type_name)
        except (ConnectionError, TimeoutError, OSError):
            return self._read("get_schema", type_name,
                              max_lag_lsn=None, max_lag_s=None)

    def get_type_names(self) -> list[str]:
        try:
            return self.primary.get_type_names()
        except (ConnectionError, TimeoutError, OSError):
            return self._read("get_type_names",
                              max_lag_lsn=None, max_lag_s=None)

    # -- failover ------------------------------------------------------------

    def _probe_loop(self):
        fails = 0
        first_fail_at = 0.0
        while not self._probe_stop.is_set():
            if self._probe_stop.wait(self._probe_s):
                return
            try:
                ok = bool(self._probe())
            except Exception:
                ok = False
            self._primary_healthy = ok
            if ok:
                fails = 0
                continue
            if fails == 0:
                first_fail_at = time.monotonic()
            fails += 1
            if fails >= self._probe_failures and self._auto_promote:
                try:
                    self.promote()
                finally:
                    with self._lock:
                        self._failover_s = time.monotonic() - first_fail_at
                    self._registry.gauge("replication.failover.seconds",
                                         self._failover_s)
                return  # the probed primary is gone; detector's job done

    def promote(self, name: str | None = None) -> dict:
        """Promote the most-caught-up attached replica (or the one
        called ``name``) to primary. Detaches the rest. Idempotent per
        failover: a second call with no attached replicas raises."""
        with self._lock:
            candidates = [r for r in self._replicas if r.attached]
            if name is not None:
                candidates = [r for r in candidates if r.name == name]
            if not candidates:
                raise ValueError("no attached replica to promote")
            best = max(candidates, key=lambda r: r.applied_lsn)
            others = [r for r in self._replicas if r is not best]
            self._replicas = []
            self._promoted_to = best.name
            self._primary_healthy = True
        self._probe_stop.set()
        best.promote()
        # the stream is cut: best's applied prefix is now final. Freeze
        # it as the ack watermark and wake waiters BEFORE the slow
        # detach joins — pending acks must resolve against the cutoff,
        # not hang behind replica thread teardown.
        with self._lock:
            self._promote_cutoff = best.applied_lsn
        self.primary = best
        with self._ack_cond:
            self._ack_cond.notify_all()
        for r in others:
            r.stop()
        with self._ack_cond:
            self._ack_cond.notify_all()  # release waiters to re-check
        self._registry.counter("replication.failovers")
        return {"promoted": best.name, "applied_lsn": best.applied_lsn,
                "detached": [r.name for r in others]}

    # -- admin ---------------------------------------------------------------

    def replication_status(self) -> dict:
        p_lsn = self._primary_lsn_estimate()
        with self._lock:
            replicas = list(self._replicas)
            promoted = self._promoted_to
            failover_s = self._failover_s
        entries = []
        for r in replicas:
            st = r.status()
            st["lag_lsn"] = r.lag_lsn(p_lsn)
            st["breaker"] = self._breakers.get(r.name).state
            st["eligible"] = (r.attached
                              and (self.max_lag_lsn is None
                                   or st["lag_lsn"] <= self.max_lag_lsn)
                              and (self.max_lag_s is None
                                   or r.lag_s() <= self.max_lag_s))
            self._registry.gauge(f"replication.lag.lsn.{r.name}",
                                 st["lag_lsn"])
            entries.append(st)
        self._registry.gauge("replication.replicas", len(replicas))
        out = {"role": "router",
               "primary": {"type": type(self.primary).__name__,
                           "healthy": self._primary_healthy,
                           "lsn": p_lsn},
               "ack_replicas": self.ack_replicas,
               "max_lag_lsn": self.max_lag_lsn,
               "max_lag_s": self.max_lag_s,
               "replicas": entries,
               "read_latency": self._breakers.latencies()}
        if promoted:
            out["promoted_to"] = promoted
            if failover_s is not None:
                out["failover_seconds"] = round(failover_s, 3)
        return out

    def close(self):
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2.0)
        with self._lock:
            replicas = list(self._replicas)
        for r in replicas:
            r.stop()
        close = getattr(self.primary, "close", None)
        if callable(close):
            close()
