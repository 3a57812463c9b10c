"""Read replica: a DataStore continuously fed by a WalShipper.

A ``Replica`` owns an in-memory store and a background thread that
keeps it converged with the primary:

    connect -> hello -> (bootstrap from checkpoint if behind the
    oldest retained segment, or fresh with a checkpoint available)
    -> stream records from applied_lsn + 1 -> apply each through the
    idempotent redo path (``replay_into``).

Connection loss reconnects with capped exponential backoff (the
resilience layer's posture); an LSN gap or a ``compacted`` error
forces a re-bootstrap — the replica never applies out of order, so
``applied_lsn`` is an exact prefix marker: every record with
``lsn <= applied_lsn`` is in the store, none above it are.

Reads delegate to the inner store. Mutations raise
``ReadOnlyReplicaError`` until ``promote()`` — which stops streaming
and unlocks writes; the router calls it on primary failure, and the
prefix property is what makes promotion safe: an acknowledged write
(durable LSN <= some replica's applied LSN) is inside the promoted
prefix by construction.
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics
from ..store.api import DataStore
from ..store.memory import InMemoryDataStore
from ..utils.device import cuda_index, device_scope
from ..wal.recovery import RecoveryReport, _HeldIds, replay_into
from .sync import BootstrapError, ReplClient, bootstrap_from_checkpoint

__all__ = ["Replica", "ReadOnlyReplicaError"]

_BACKOFF_MIN_S, _BACKOFF_MAX_S = 0.05, 1.0


class ReadOnlyReplicaError(RuntimeError):
    """Write attempted against a non-promoted replica. Not retryable —
    the caller is holding the wrong end of the topology; writes go to
    the primary (the router does this routing)."""

    retryable = False


class Replica(DataStore):
    """A read-only store applying a primary's shipped WAL records.

    Without a ``store`` it builds an ``InMemoryDataStore`` on ``device``
    (None: the CUDA card, which must be there). The apply loop runs
    with the store's card as its thread's current device."""

    def __init__(self, host: str, port: int, name: str = "replica",
                 store: DataStore | None = None, timeout_s: float = 10.0,
                 registry=metrics, start: bool = True, device=None):
        self.name = name
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self._store = (store if store is not None
                       else InMemoryDataStore(device=device))
        self._cuda = cuda_index(self._store)
        # the ids each type holds, kept across records: the apply loop
        # is the store's only writer until promotion (None: read anew)
        self._held: _HeldIds | None = None
        self._registry = registry
        self._report = RecoveryReport()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._writable = False
        self._connected = False
        self._needs_bootstrap = False
        self.applied_lsn = 0
        self.primary_last_lsn = 0
        self.primary_durable_lsn = 0
        self.bootstraps = 0
        self._client: ReplClient | None = None
        self.last_error: str | None = None
        # monotonic instant the replica last knew itself fully caught
        # up (applied == primary last); staleness-in-seconds anchor
        self._caught_up_at: float | None = None
        # router hook: called (outside locks) after every applied
        # record so ack waiters re-check their LSN condition
        self.on_apply = None
        if start:
            self.start()

    # -- apply loop ----------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"replica:{self.name}", daemon=True)
        self._thread.start()

    def _run(self):
        with device_scope(self._cuda):
            self._loop()

    def _loop(self):
        backoff = _BACKOFF_MIN_S
        while not self._stop.is_set():
            try:
                client = ReplClient(self.host, self.port,
                                    timeout_s=self.timeout_s)
                self._client = client
                try:
                    self._session(client)
                    backoff = _BACKOFF_MIN_S
                finally:
                    self._client = None
                    client.close()
            except (ConnectionError, TimeoutError, OSError,
                    BootstrapError) as e:
                with self._lock:
                    self.last_error = repr(e)
            self._connected = False
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, _BACKOFF_MAX_S)

    def _session(self, client: ReplClient):
        hello = client.hello()
        self._observe_primary(hello)
        with self._lock:
            behind_log = self.applied_lsn + 1 < int(hello["oldest_lsn"])
            fresh = (self.applied_lsn == 0
                     and int(hello["checkpoint_lsn"]) > 0)
            need_boot = self._needs_bootstrap or behind_log or fresh
        if need_boot:
            self._bootstrap(client)
        with self._lock:
            from_lsn = self.applied_lsn + 1
        self._connected = True
        for header, payload in client.stream(from_lsn):
            if self._stop.is_set():
                return
            if header.get("error"):
                # compacted under us between hello and stream
                with self._lock:
                    self._needs_bootstrap = True
                return
            self._observe_primary(header)
            if header.get("heartbeat"):
                continue
            lsn = int(header["lsn"])
            with self._lock:
                applied = self.applied_lsn
            if lsn <= applied:
                continue  # duplicate after a reconnect race
            if lsn != applied + 1:
                # gap: applying it would break the prefix property
                with self._lock:
                    self._needs_bootstrap = True
                self._registry.counter("replication.stream.gaps")
                return
            failed_before = self._report.records_failed
            if self._held is None:
                self._held = _HeldIds(self._store)
            replay_into(self._store, [(lsn, int(header["kind"]), payload)],
                        self._report, held=self._held)
            if self._report.records_failed > failed_before:
                self._held = None   # a failed record may have half-applied
                # the record did NOT land: advancing applied_lsn past it
                # would turn the exact-prefix marker into a lie (an ack
                # could then point at a row this replica silently lacks).
                # Re-bootstrap from the primary's checkpoint instead.
                with self._lock:
                    self._needs_bootstrap = True
                self._registry.counter("replication.apply.failed")
                return
            with self._lock:
                self.applied_lsn = lsn
                if self.applied_lsn >= self.primary_last_lsn:
                    self._caught_up_at = time.monotonic()
            self._registry.counter("replication.applied.records")
            cb = self.on_apply
            if cb is not None:
                cb(self)

    def _observe_primary(self, header: dict):
        with self._lock:
            self.primary_last_lsn = max(self.primary_last_lsn,
                                        int(header.get("last_lsn", 0)))
            self.primary_durable_lsn = max(self.primary_durable_lsn,
                                           int(header.get("durable_lsn", 0)))
            if self.applied_lsn >= self.primary_last_lsn:
                self._caught_up_at = time.monotonic()

    def _bootstrap(self, client: ReplClient):
        # full-state load: clear any stale partial state first so rows
        # deleted on the primary don't survive in the replica
        with self._lock:
            had_state = self.applied_lsn > 0
        self._held = None
        if had_state:
            for tn in list(self._store.get_type_names()):
                self._store.remove_schema(tn)
        lsn = bootstrap_from_checkpoint(client, self._store,
                                        registry=self._registry)
        with self._lock:
            self.applied_lsn = max(lsn, 0)
            self._needs_bootstrap = False
            self.bootstraps += 1

    # -- health / status -----------------------------------------------------

    @property
    def connected(self) -> bool:
        return self._connected

    @property
    def promoted(self) -> bool:
        return self._writable

    @property
    def attached(self) -> bool:
        """Still following a primary: the apply loop is live (possibly
        mid-reconnect) and the replica has not been promoted."""
        return not self._stop.is_set() and not self._writable

    def lag_lsn(self, primary_lsn: int | None = None) -> int:
        with self._lock:
            ref = self.primary_last_lsn if primary_lsn is None \
                else max(primary_lsn, 0)
            return max(ref - self.applied_lsn, 0)

    def lag_s(self) -> float:
        """Seconds since the replica last knew itself fully caught up
        (inf before first catch-up)."""
        with self._lock:
            if self.applied_lsn >= self.primary_last_lsn \
                    and self.primary_last_lsn > 0:
                return 0.0
            if self._caught_up_at is None:
                return float("inf")
            return time.monotonic() - self._caught_up_at

    def status(self) -> dict:
        with self._lock:
            return {"name": self.name, "connected": self._connected,
                    "promoted": self._writable,
                    "applied_lsn": self.applied_lsn,
                    "primary_last_lsn": self.primary_last_lsn,
                    "lag_lsn": max(self.primary_last_lsn - self.applied_lsn,
                                   0),
                    "bootstraps": self.bootstraps,
                    "records_applied": self._report.records_replayed,
                    "records_failed": self._report.records_failed,
                    "last_error": self.last_error}

    def request_rebootstrap(self):
        """Anti-entropy escalation: the replica's state diverged from
        the primary (scrubber digest mismatch). Mark the next session
        as bootstrap-first and sever the current connection so the
        apply loop reconnects immediately — the bootstrap clears local
        state and reloads the primary's checkpoint, then streaming
        resumes from its LSN."""
        with self._lock:
            self._needs_bootstrap = True
        client = self._client
        if client is not None:
            client.close()  # unblocks the streaming recv
        self._registry.counter("replication.rebootstraps.requested")

    # -- lifecycle -----------------------------------------------------------

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._connected = False

    def promote(self) -> "Replica":
        """Stop streaming and unlock writes; the replica becomes a
        standalone primary holding exactly its applied prefix."""
        self.stop()
        self._writable = True
        self._registry.counter("replication.promotions")
        return self

    @property
    def store(self) -> DataStore:
        return self._store

    @property
    def device(self):
        return getattr(self._store, "device", None)

    # -- DataStore surface ---------------------------------------------------

    def _writes_allowed(self, op: str):
        if not self._writable:
            raise ReadOnlyReplicaError(
                f"replica {self.name!r} is read-only ({op}); route writes "
                f"to the primary or promote() first")

    def create_schema(self, sft, spec=None):
        self._writes_allowed("create_schema")
        return self._store.create_schema(sft, spec)

    def remove_schema(self, type_name: str):
        self._writes_allowed("remove_schema")
        return self._store.remove_schema(type_name)

    def write(self, type_name: str, batch, **kwargs):
        self._writes_allowed("write")
        return self._store.write(type_name, batch, **kwargs)

    def delete(self, type_name: str, ids):
        self._writes_allowed("delete")
        return self._store.delete(type_name, ids)

    def get_schema(self, type_name: str):
        return self._store.get_schema(type_name)

    def get_type_names(self) -> list[str]:
        return self._store.get_type_names()

    def query(self, q, type_name=None, explain_out=None):
        return self._store.query(q, type_name, explain_out=explain_out)

    def query_count(self, q, type_name=None) -> int:
        return self._store.query_count(q, type_name)

    def count(self, type_name: str) -> int:
        return self._store.count(type_name)

    # aggregate scans delegate too: the cluster tier scatters stats /
    # density / bin / arrow legs to replicas under the same staleness
    # bounds as plain queries
    def stats_query(self, type_name: str, stat_spec: str, ecql=None):
        return self._store.stats_query(type_name, stat_spec, ecql)

    def density(self, type_name: str, ecql, bbox, width: int, height: int,
                weight_attr: str | None = None):
        return self._store.density(type_name, ecql, bbox, width, height,
                                   weight_attr=weight_attr)

    def bin_query(self, type_name: str, ecql, track: str | None = None,
                  label: str | None = None, sort: bool = False) -> bytes:
        return self._store.bin_query(type_name, ecql, track=track,
                                     label=label, sort=sort)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        return self._store.arrow_ipc(type_name, ecql, sort_by=sort_by)

    # the materialized pushdown cache lives in the inner store; replicas
    # expose its version/status faces so cached tiles served here carry
    # the replica's own apply progress (bounded-staleness contract:
    # entries can never be older than the replica's applied state)
    @property
    def result_cache(self):
        return self._store.result_cache

    def pushdown_version(self, type_name: str) -> int:
        return self._store.pushdown_version(type_name)

    def cache_status(self) -> dict:
        out = self._store.cache_status()
        out["applied_lsn"] = self.applied_lsn
        return out

    def invalidate_cache(self, type_name: str | None = None) -> int:
        return self._store.invalidate_cache(type_name)
