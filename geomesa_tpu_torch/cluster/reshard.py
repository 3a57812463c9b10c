"""Online Z-shard split/migration: move a prefix range between groups
with zero acked-write loss while the cluster keeps serving.

The reference's elastic-scale story is tablet splitting on the
key-value store — ranges split and migrate between region servers as
key density shifts, without a restart. This module is that operation
for the cluster tier: reassign a z-prefix range ``[lo, hi)`` from a
source shard group to a destination group *online*, against live
reads and writes.

Protocol (the snapshot + WAL-tail + atomic-flip shape the replication
tier built the pieces for):

1. **Install** (brief exclusive gate): a ``_Migration`` is attached to
   the coordinator. For a non-durable source the coordinator starts
   double-routing — every write/delete that lands in the moving range
   is also applied to the migration's private *staging* store. A
   durable source needs no double-routing: its WAL already carries
   every acked mutation, and the tail IS the stream.
2. **Snapshot**: the moving range's rows are captured through the
   checkpoint path (force a checkpoint, load and verify it, filter to
   the moving range) and staged. Staging is always delete-then-write
   under one lock — the recovery.py idempotent-redo idiom — so a row
   present in both the snapshot and the tail lands exactly once.
3. **Catch-up**: the WAL tail past the snapshot LSN replays into the
   staging store in bounded rounds until the remaining tail is small.
4. **Flip** (exclusive gate, ``geomesa.reshard.flip.timeout.s``): the
   final tail replays up to the barrier LSN (``wal.last_lsn`` with all
   writers drained), the migration is CUT — any straggler staged apply
   now fails typed ``StaleTopologyError``, the `_promote_cutoff`
   zombie-fencing pattern pointed at topology instead of promotion —
   then the staged rows bulk-write to the destination
   (delete-then-write: idempotent on resume), the source deletes them,
   and the coordinator swaps in the successor topology (epoch + 1) and
   clears the prune cache. The LSN vector bumps for both groups, so
   read-your-writes holds across the flip.
5. **Crash mid-flip**: the migration is left ``broken`` and every
   cluster op fails typed until ``resume()`` (re-runs the idempotent
   flip steps) or ``abort()`` (restores the staged rows to the source,
   removes them from the destination, keeps the old topology) —
   exact-or-typed, never silently duplicated or lost.

``geomesa.reshard.enabled=false`` refuses every reshard verb, leaving
the uniform epoch-0 topology — routing bit-identical to the
pre-reshard cluster.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from ..metrics import metrics
from ..utils.properties import SystemProperty
from .partition import _N_PREFIXES, ZPrefixPartitioner

__all__ = ["Resharder", "ReshardError", "StaleTopologyError",
           "RESHARD_ENABLED", "RESHARD_COOLDOWN_S",
           "RESHARD_MAX_CONCURRENT", "RESHARD_FLIP_TIMEOUT_S"]

# kill switch: "false" refuses split/migrate/auto entirely — the
# topology stays uniform epoch-0, bit-identical to the pre-reshard
# cluster (reload-only scaling)
RESHARD_ENABLED = SystemProperty("geomesa.reshard.enabled", "true")
# minimum seconds between AUTO-triggered reshards (rate guard on the
# control loop; manual operator verbs are not throttled)
RESHARD_COOLDOWN_S = SystemProperty("geomesa.reshard.cooldown.s", "300")
# concurrent migrations allowed (the flip serializes on the op gate
# regardless; >1 is for future multi-range moves)
RESHARD_MAX_CONCURRENT = SystemProperty("geomesa.reshard.max.concurrent",
                                        "1")
# how long the flip may wait to drain in-flight ops before failing
# typed (the migration stays resumable)
RESHARD_FLIP_TIMEOUT_S = SystemProperty("geomesa.reshard.flip.timeout.s",
                                        "30")


class ReshardError(RuntimeError):
    """A reshard verb could not run (disabled, already in flight,
    cooldown, bad range) or a migration is in a state that needs
    ``resume()``/``abort()``. NOT retryable blindly — the message says
    which."""

    retryable = False


class StaleTopologyError(ReshardError):
    """A write carried a topology epoch the cluster has already moved
    past (or a staged apply raced the flip's cut) — the zombie-write
    fence. The client must refresh its topology and re-route."""

    def __init__(self, detail: str, epoch=None, current=None):
        self.epoch = epoch
        self.current = current
        super().__init__(detail)


class _OpGate:
    """Shared/exclusive gate over cluster ops: every read/write takes
    the shared side (concurrent among themselves), the flip takes the
    exclusive side — draining in-flight ops and blocking new ones for
    the flip's brief critical section."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_shared(self):
        # writer-preferring: new shared entrants queue behind a waiting
        # flip, or a steady stream of scatter reads would starve the
        # exclusive drain past its timeout
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_shared(self):
        with self._cond:
            self._readers -= 1
            if self._readers <= 0:
                self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        self.acquire_shared()
        try:
            yield
        finally:
            self.release_shared()

    @contextlib.contextmanager
    def exclusive(self, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._readers or self._writer:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ReshardError(
                            f"could not drain in-flight cluster ops "
                            f"inside {timeout_s:g}s "
                            f"(geomesa.reshard.flip.timeout.s)")
                    self._cond.wait(remaining)
                self._writer = True
            finally:
                self._writers_waiting -= 1
                if not self._writers_waiting:
                    self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class _Migration:
    """One in-flight range move: the moving range, the successor
    topology it will flip to, and the private staging store the moving
    rows accumulate in. Staged rows are invisible to reads until the
    flip — scatter legs keep merging disjoint partitions, so queries
    during migration stay exact."""

    def __init__(self, coord, src_idx: int, dst_idx: int,
                 prefix_lo: int, prefix_hi: int,
                 probe: ZPrefixPartitioner, reason: str,
                 forward: bool, registry=metrics):
        from ..store.memory import InMemoryDataStore
        self.src_idx, self.dst_idx = int(src_idx), int(dst_idx)
        self.src_name = coord._names[src_idx]
        self.dst_name = coord._names[dst_idx]
        self.prefix_lo, self.prefix_hi = int(prefix_lo), int(prefix_hi)
        self.base = coord._part                # topology being left
        self.probe = probe                     # topology being entered
        self.reason = reason
        self.forward = forward                 # double-route (no WAL)
        self.phase = "install"
        self.lock = threading.RLock()
        # staged on the source group's device (None: the card)
        self.pending = InMemoryDataStore(
            device=getattr(coord._groups[src_idx], "device", None))
        self.cursor = 0                        # last WAL lsn staged
        self.barrier_lsn = None
        self.rows_staged = 0
        self.rows_moved = 0
        self.moved_ids: dict[str, list] = {}
        self.started_ms = int(time.time() * 1000)
        self.error = None
        self._registry = registry

    @property
    def blocking(self) -> bool:
        """True once the flip has begun mutating group state — cluster
        ops must fail typed until resume/abort restores a consistent
        topology."""
        return self.phase in ("cut", "broken")

    def describe(self) -> dict:
        return {"src": self.src_name, "dst": self.dst_name,
                "prefix_lo": self.prefix_lo, "prefix_hi": self.prefix_hi,
                "phase": self.phase, "reason": self.reason,
                "rows_staged": self.rows_staged,
                "cursor_lsn": self.cursor,
                "barrier_lsn": self.barrier_lsn,
                "started_ms": self.started_ms,
                "error": self.error}

    # -- staging -----------------------------------------------------------

    def moving_rows(self, sft, batch) -> np.ndarray:
        """Row indices whose ownership this migration changes: routed
        to src under the old topology AND to dst under the successor.
        Id-hash-routed rows never qualify (same owner in both)."""
        o0 = self.base.owners_for_batch(sft, batch)
        o1 = self.probe.owners_for_batch(sft, batch)
        return np.flatnonzero((o0 == self.src_idx) & (o1 == self.dst_idx))

    def _ensure_schema(self, sft):
        if sft.type_name not in self.pending.get_type_names():
            self.pending.create_schema(sft)

    def stage_write(self, sft, batch, visibilities=None) -> int:
        """Stage the moving slice of a batch: delete-then-write under
        the staging lock (exactly one copy per id, idempotent on
        re-apply — the recovery.py redo idiom)."""
        rows = self.moving_rows(sft, batch)
        if not len(rows):
            return 0
        sub = batch if len(rows) == batch.n else batch.take(rows)
        vis = None
        if visibilities is not None:
            vis = list(np.asarray(visibilities, dtype=object)[rows])
        with self.lock:
            if self.blocking or self.phase in ("done", "aborted"):
                self._registry.counter("cluster.reshard.zombie.rejects")
                raise StaleTopologyError(
                    f"staged write raced the topology flip "
                    f"(migration {self.phase})")
            self._ensure_schema(sft)
            self.pending.delete(sft.type_name, list(sub.ids))
            self.pending.write(sft.type_name, sub, visibilities=vis)
            self.rows_staged = sum(self.pending.count(t)
                                   for t in self.pending.get_type_names())
        return int(len(rows))

    def stage_delete(self, type_name: str, ids) -> None:
        with self.lock:
            if self.blocking or self.phase in ("done", "aborted"):
                self._registry.counter("cluster.reshard.zombie.rejects")
                raise StaleTopologyError(
                    f"staged delete raced the topology flip "
                    f"(migration {self.phase})")
            if type_name in self.pending.get_type_names():
                self.pending.delete(type_name, ids)


def _journal_of(group):
    """The source group's journal, reaching through the replication
    router (``.primary``) and the DurableStore wrapper. None for a
    non-durable group — the live-snapshot + double-route path."""
    j = getattr(group, "journal", None)
    if j is not None:
        return j
    primary = getattr(group, "primary", None)
    if primary is not None:
        return getattr(primary, "journal", None)
    return None


class Resharder:
    """Executes split/migrate verbs against one ``ClusterDataStore``
    and records the topology epoch history. ``fault_hook(tag)`` is the
    kill-point seam the crash-safety tests arm (the CrashHarness
    shape): raising from it simulates a crash at that point in the
    protocol."""

    #: kill-point tags fault_hook can fire at, in protocol order
    PHASES = ("snapshot.start", "snapshot.done", "catchup.done",
              "flip.enter", "flip.barrier", "flip.copy", "flip.copied",
              "flip.delete_src", "flip.swap")

    def __init__(self, coord, registry=metrics):
        self._coord = coord
        self._registry = registry
        self._lock = threading.Lock()
        self._active: _Migration | None = None
        self._last_done: float | None = None   # monotonic, cooldown
        self.history: list[dict] = []
        self.fault_hook = None

    # -- plumbing ----------------------------------------------------------

    def _fault(self, tag: str):
        if self.fault_hook is not None:
            self.fault_hook(tag)

    def _check_enabled(self):
        if not RESHARD_ENABLED.as_bool():
            raise ReshardError(
                "resharding disabled (geomesa.reshard.enabled=false); "
                "topology is fixed at the uniform epoch-0 split")

    def _gidx(self, group) -> int:
        names = self._coord._names
        if isinstance(group, (int, np.integer)):
            if not 0 <= int(group) < len(names):
                raise ReshardError(f"group index {group} out of range")
            return int(group)
        if group in names:
            return names.index(group)
        raise ReshardError(f"no such group {group!r}; have: "
                           + ", ".join(names))

    def _flip_timeout(self) -> float:
        return RESHARD_FLIP_TIMEOUT_S.as_float() or 30.0

    def cooldown_remaining(self) -> float:
        """Seconds until the next AUTO reshard may fire (0 when clear)."""
        if self._last_done is None:
            return 0.0
        cd = RESHARD_COOLDOWN_S.as_float() or 0.0
        return max(0.0, cd - (time.monotonic() - self._last_done))

    def status(self) -> dict:
        mig = self._active
        return {"enabled": bool(RESHARD_ENABLED.as_bool()),
                "epoch": self._coord._part.epoch,
                "active": mig.describe() if mig is not None else None,
                "cooldown_remaining_s": round(self.cooldown_remaining(), 3),
                "history": list(self.history)}

    # -- verbs -------------------------------------------------------------

    def split(self, src, dst=None, at=None, reason: str = "manual"
              ) -> dict:
        """Split the source group's (widest) owned range at a
        key-density-chosen point and migrate the upper side to ``dst``
        (default: the least-loaded other group)."""
        self._check_enabled()
        src_idx = self._gidx(src)
        ranges = self._coord._part.owned_prefix_ranges(src_idx)
        if not ranges:
            raise ReshardError(
                f"group {self._coord._names[src_idx]!r} owns no range")
        lo, hi = max(ranges, key=lambda r: r[1] - r[0])
        if hi - lo < 2:
            raise ReshardError("owned range too narrow to split")
        if at is None:
            at = self._pick_split_point(src_idx, lo, hi)
        at = int(at)
        if not lo < at < hi:
            raise ReshardError(
                f"split point {at} outside the splittable range "
                f"({lo}, {hi})")
        dst_idx = self._pick_dst(src_idx) if dst is None else self._gidx(dst)
        return self.migrate(at, hi, src_idx, dst_idx, reason=reason)

    def migrate(self, prefix_lo: int, prefix_hi: int, src, dst,
                reason: str = "manual") -> dict:
        """Move prefixes ``[prefix_lo, prefix_hi)`` from ``src`` to
        ``dst`` online. Returns the completed epoch-history entry."""
        self._check_enabled()
        coord = self._coord
        src_idx, dst_idx = self._gidx(src), self._gidx(dst)
        if src_idx == dst_idx:
            raise ReshardError("src and dst are the same group")
        if not 0 <= prefix_lo < prefix_hi <= _N_PREFIXES:
            raise ReshardError(
                f"bad prefix range [{prefix_lo}, {prefix_hi})")
        with self._lock:
            limit = max(RESHARD_MAX_CONCURRENT.as_int() or 1, 1)
            if self._active is not None and limit <= 1:
                raise ReshardError(
                    f"migration already in flight "
                    f"({self._active.src_name}->{self._active.dst_name} "
                    f"{self._active.phase}); resume or abort it first")
            if reason == "auto" and self.cooldown_remaining() > 0:
                raise ReshardError(
                    f"auto reshard in cooldown: "
                    f"{self.cooldown_remaining():.0f}s remaining "
                    f"(geomesa.reshard.cooldown.s)")
            part = coord._part
            for seg in part.segments():
                if (seg["prefix_lo"] < prefix_hi
                        and seg["prefix_hi"] > prefix_lo
                        and seg["group"] != src_idx):
                    raise ReshardError(
                        f"prefixes [{prefix_lo}, {prefix_hi}) are not "
                        f"all owned by {coord._names[src_idx]!r} "
                        f"(segment {seg} intersects)")
            probe = part.with_move(prefix_lo, prefix_hi, dst_idx)
            src_group = coord._groups[src_idx]
            journal = _journal_of(src_group)
            mig = _Migration(coord, src_idx, dst_idx, prefix_lo,
                             prefix_hi, probe, reason,
                             forward=journal is None,
                             registry=self._registry)
            # mirror the schemas so staged applies always land
            for tn in coord.get_type_names():
                mig.pending.create_schema(coord.get_schema(tn))
            self._active = mig
        # install under a brief exclusive section: drains in-flight
        # writes, so every later mutation is either WAL-tailed
        # (durable) or double-routed (non-durable)
        try:
            with coord._gate.exclusive(self._flip_timeout()):
                coord._migration = mig
                mig.phase = "snapshot"
        except BaseException:
            with self._lock:
                self._active = None
            raise
        return self._drive(mig, src_group, journal)

    def resume(self) -> dict:
        """Re-drive an interrupted migration to completion. Safe after
        a crash at any kill point: staging and the flip are both
        delete-then-write idempotent."""
        self._check_enabled()
        mig = self._active
        if mig is None:
            raise ReshardError("no migration to resume")
        coord = self._coord
        src_group = coord._groups[mig.src_idx]
        journal = _journal_of(src_group)
        if mig.phase in ("cut", "broken"):
            # the flip already cut: redo only the flip body
            t0 = time.perf_counter()
            with coord._gate.exclusive(self._flip_timeout()):
                with mig.lock:
                    mig.phase = "cut"
                self._finish_flip(mig)
            return self._record(mig, (time.perf_counter() - t0) * 1e3)
        mig.error = None
        mig.phase = "snapshot"
        return self._drive(mig, src_group, journal)

    def abort(self) -> dict:
        """Cancel the active migration and restore the pre-migration
        state: staged rows return to the source (delete-then-write),
        any copies already flipped into the destination are removed,
        and the old topology stays."""
        mig = self._active
        if mig is None:
            raise ReshardError("no migration to abort")
        coord = self._coord
        src = coord._groups[mig.src_idx]
        dst = coord._groups[mig.dst_idx]
        from ..wal.snapshot import iter_store_states
        with coord._gate.exclusive(self._flip_timeout()):
            if mig.blocking:
                # the flip may have part-copied into dst and
                # part-deleted from src: the staging store holds the
                # authoritative barrier-time state of the moving range
                for sft, batch, vis in list(iter_store_states(mig.pending)):
                    if batch is None or not batch.n:
                        continue
                    ids = list(batch.ids)
                    dst.delete(sft.type_name, ids)
                    src.delete(sft.type_name, ids)
                    src.write(sft.type_name, batch,
                              visibilities=None if vis is None
                              else list(vis))
            with mig.lock:
                mig.phase = "aborted"
            coord._migration = None
        with self._lock:
            self._active = None
        self._registry.counter("cluster.reshard.aborts")
        entry = {"epoch": coord._part.epoch, "op": "abort",
                 "src": mig.src_name, "dst": mig.dst_name,
                 "prefix_lo": mig.prefix_lo, "prefix_hi": mig.prefix_hi,
                 "reason": mig.reason, "ts_ms": int(time.time() * 1000)}
        self.history.append(entry)
        return entry

    # -- protocol ----------------------------------------------------------

    def _drive(self, mig: _Migration, src_group, journal) -> dict:
        t0 = time.perf_counter()
        try:
            self._fault("snapshot.start")
            if journal is not None:
                self._snapshot_durable(mig, src_group, journal)
            else:
                self._snapshot_live(mig, src_group)
            self._fault("snapshot.done")
            mig.phase = "catchup"
            if journal is not None:
                self._catchup(mig, journal)
            self._fault("catchup.done")
            flip_ms = self._flip(mig, journal)
        except ReshardError:
            raise
        except BaseException as e:
            mig.error = f"{type(e).__name__}: {e}"
            with mig.lock:
                if mig.phase == "cut":
                    mig.phase = "broken"
            self._registry.counter("cluster.reshard.failures")
            raise
        return self._record(mig, flip_ms)

    def _snapshot_durable(self, mig, group, journal):
        """Snapshot via the checkpoint path: force a checkpoint (the
        write is atomic + digest-verified by snapshot.py), load it
        back, stage the moving slice. The WAL tail past the checkpoint
        LSN is replayed by catch-up."""
        from ..wal.snapshot import load_checkpoint
        ckpt = getattr(group, "checkpoint", None)
        if not callable(ckpt):
            primary = getattr(group, "primary", None)
            ckpt = getattr(primary, "checkpoint", None)
        if callable(ckpt):
            ckpt()
        loaded = load_checkpoint(journal.root)
        if loaded is None:
            # no loadable snapshot (all corrupt): fall back to a live
            # read; the WAL tail still converges the staging store
            self._snapshot_live(mig, group)
            return
        lsn, states = loaded
        mig.cursor = int(lsn)
        for sft, batch, vis in states:
            if batch is None or not batch.n:
                continue
            mig.stage_write(sft, batch, visibilities=vis)

    def _snapshot_live(self, mig, group):
        """Non-durable source: read the group's state directly, under
        the exclusive gate so the point-in-time read cannot interleave
        with double-routed applies (which would re-order a delete
        against its row)."""
        from ..wal.snapshot import iter_store_states
        with self._coord._gate.exclusive(self._flip_timeout()):
            try:
                states = list(iter_store_states(group))
            except TypeError:
                # remote or otherwise opaque group: full query per type
                from ..index.api import Query
                states = []
                for tn in self._coord.get_type_names():
                    sft = self._coord.get_schema(tn)
                    res = group.query(Query(tn, "INCLUDE"))
                    states.append((sft, res.batch, None))
            for sft, batch, vis in states:
                if batch is None or not batch.n:
                    continue
                mig.stage_write(sft, batch, visibilities=vis)

    def _replay_tail(self, mig, journal, upto=None) -> int:
        """Stage the WAL records past the cursor (WRITE filtered to the
        moving range, DELETE verbatim — LSN order is authoritative, so
        this converges regardless of interleaving)."""
        from ..wal.log import DELETE, WRITE, decode_delete, decode_write
        n = 0
        for lsn, kind, payload in journal.wal.records(mig.cursor + 1):
            if upto is not None and lsn > upto:
                break
            if kind == WRITE:
                tn, batch, vis = decode_write(payload)
                if batch is not None and batch.n:
                    mig.stage_write(batch.sft, batch, visibilities=vis)
            elif kind == DELETE:
                tn, ids = decode_delete(payload)
                mig.stage_delete(tn, ids)
            mig.cursor = int(lsn)
            n += 1
        return n

    def _catchup(self, mig, journal, rounds: int = 8, settle: int = 64):
        """Bounded catch-up rounds: replay the tail while writers keep
        appending; once a round stages few enough records the final
        (exclusive-gated) barrier replay is short."""
        for _ in range(rounds):
            if self._replay_tail(mig, journal) <= settle:
                return

    def _flip(self, mig, journal) -> float:
        coord = self._coord
        t0 = time.perf_counter()
        with coord._gate.exclusive(self._flip_timeout()):
            self._fault("flip.enter")
            if journal is not None:
                mig.barrier_lsn = int(journal.wal.last_lsn)
                self._replay_tail(mig, journal, upto=mig.barrier_lsn)
            self._fault("flip.barrier")
            with mig.lock:
                mig.phase = "cut"      # zombie fence: staged applies
            self._finish_flip(mig)     # past this point fail typed
        return (time.perf_counter() - t0) * 1e3

    def _finish_flip(self, mig):
        """The flip body — idempotent end to end (delete-then-write
        into dst, delete-by-id from src, reference-swap the topology)
        so ``resume()`` can re-run it after a crash at any point."""
        coord = self._coord
        src = coord._groups[mig.src_idx]
        dst = coord._groups[mig.dst_idx]
        from ..wal.snapshot import iter_store_states
        moved: dict[str, list] = {}
        rows = 0
        self._fault("flip.copy")
        for sft, batch, vis in list(iter_store_states(mig.pending)):
            if batch is None or not batch.n:
                continue
            ids = list(batch.ids)
            dst.delete(sft.type_name, ids)
            ret = dst.write(sft.type_name, batch,
                            visibilities=None if vis is None
                            else list(vis))
            coord._bump_lsn(mig.dst_name, dst, ret)
            moved[sft.type_name] = ids
            rows += int(batch.n)
            self._fault("flip.copied")
        mig.moved_ids = moved
        self._fault("flip.delete_src")
        for tn, ids in moved.items():
            ret = src.delete(tn, ids)
            coord._bump_lsn(mig.src_name, src, ret)
        self._fault("flip.swap")
        coord._part = mig.probe
        coord._prune_cache.clear()
        coord._migration = None
        with mig.lock:
            mig.phase = "done"
        mig.rows_moved = rows
        with self._lock:
            self._active = None
            self._last_done = time.monotonic()

    def _record(self, mig, flip_ms: float) -> dict:
        coord = self._coord
        entry = {"epoch": coord._part.epoch,
                 "op": "migrate", "reason": mig.reason,
                 "src": mig.src_name, "dst": mig.dst_name,
                 "prefix_lo": mig.prefix_lo, "prefix_hi": mig.prefix_hi,
                 "rows_moved": mig.rows_moved,
                 "barrier_lsn": mig.barrier_lsn,
                 "flip_ms": round(flip_ms, 3),
                 "ts_ms": int(time.time() * 1000)}
        self.history.append(entry)
        self._registry.counter("cluster.reshard.migrations")
        self._registry.counter("cluster.reshard.rows.moved",
                               mig.rows_moved)
        self._registry.gauge("cluster.reshard.flip.ms", flip_ms)
        self._registry.gauge("cluster.topology.epoch", coord._part.epoch)
        return entry

    # -- placement helpers -------------------------------------------------

    def _pick_split_point(self, src_idx: int, lo: int, hi: int) -> int:
        """Key-density split point: histogram the source group's rows
        over its owned prefixes and take the weighted median — half
        the keys (not half the keyspace) on each side. Midpoint when
        the group is empty or unreadable."""
        from ..index.splitter import pick_split_prefix, prefix_histogram
        coord = self._coord
        group = coord._groups[src_idx]
        total = None
        for tn in coord.get_type_names():
            try:
                h = prefix_histogram(group, tn, lo, hi)
            except Exception:  # noqa: BLE001 — placement is advisory
                continue
            total = h if total is None else total + h
        return pick_split_prefix(total, lo, hi)

    def _pick_dst(self, src_idx: int) -> int:
        """Least-loaded destination: lowest observed leg p99 (a group
        with no samples is idle — best of all)."""
        coord = self._coord
        best, best_p99 = None, None
        for i, name in enumerate(coord._names):
            if i == src_idx:
                continue
            p99 = coord._breakers.latency_p99_s(name) or 0.0
            if best is None or p99 < best_p99:
                best, best_p99 = i, p99
        if best is None:
            raise ReshardError("no destination group available")
        return best
