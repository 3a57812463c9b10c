"""Online reindex & schema evolution: shadow builds with WAL-tail
catch-up and an atomic flip that survives crashes mid-migration.

The reference runs index migrations as offline distributed jobs
(WriteIndexJob / AttributeIndexJob over versioned index tables,
jobs/accumulo/AttributeIndexJob); our blocking ``store.reindex`` is the
in-process analog — it holds the store op lock for the whole rebuild.
This module applies the Resharder's protocol (cluster/reshard.py) to
schema surgery on ONE store's ``_TypeState`` instead of topology moves:

1. **snapshot** — seed a shadow ``_TypeState`` carrying the evolved
   schema, on the store's own device (``store._new_state``), from the checkpoint path (durable stores: force a checkpoint,
   load it back, transform the type's batch) or a gated live read
   (non-durable), recording the snapshot LSN as the replay cursor.
2. **dual-feed** — a write-path tap (``_EvolveFeed``) installed on the
   store refuses writes that conflict with a mid-drop attribute
   (typed ``SchemaEvolutionError``) and, on non-durable stores, queues
   every mutation for the shadow; durable stores need no queue — the
   WAL itself is the feed.
3. **catch-up** — bounded rounds replay the WAL tail (or drain the
   queue) into the shadow while the live index keeps serving; the
   shadow's z-index builds here, off the critical path.
4. **flip** — under the evolve op gate + the store op lock: replay the
   final tail to a barrier LSN, cut (ops on the type fail typed),
   reference-swap the ``_TypeState``, bump the pushdown version and
   invalidate the result cache. Plan caches are fresh by construction.

Every phase is a named kill point (``fault_hook``), and ``resume()`` /
``abort()`` are idempotent: staging is delete-then-write (the
recovery.py redo idiom), re-driving rebuilds the shadow from scratch,
and the live state is never mutated before the swap — so abort always
restores the pre-evolve state by simply discarding the shadow.

``geomesa.evolve.enabled`` (default **false**) gates every verb; off is
bit-identical to today and the blocking ``store.reindex`` stays as the
oracle.

Two copies of the type live on the store's device between the snapshot
and the flip. The flip drops the evolution's anchor on the superseded
state and an abort drops the shadow, so the copy that loses holds no
device memory once the verb returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np

from ..cluster.reshard import ReshardError, _OpGate
from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              NumericColumn, StringColumn)
from ..features.sft import (AttributeSpec, Configs, SimpleFeatureType,
                            _parse_type, check_index_version)
from ..metrics import metrics
from ..obs.trace import tracer
from ..utils.properties import SystemProperty

__all__ = ["Evolver", "SchemaEvolutionError", "EVOLVE_ENABLED",
           "EVOLVE_CATCHUP_ROUNDS", "EVOLVE_CATCHUP_SETTLE",
           "EVOLVE_GATE_TIMEOUT_S"]

# kill switch: "false" (the default) refuses every evolve verb — the
# store behaves bit-identically to the pre-evolve build and layout
# migrations go through the blocking reindex oracle
EVOLVE_ENABLED = SystemProperty("geomesa.evolve.enabled", "false")
# bounded catch-up: max WAL-tail replay rounds before the flip, and the
# per-round record count under which the delta is considered settled
EVOLVE_CATCHUP_ROUNDS = SystemProperty("geomesa.evolve.catchup.rounds",
                                       "8")
EVOLVE_CATCHUP_SETTLE = SystemProperty("geomesa.evolve.catchup.settle",
                                       "64")
# how long the flip may wait to drain evolve-plane readers before
# failing typed (the evolution stays resumable)
EVOLVE_GATE_TIMEOUT_S = SystemProperty("geomesa.evolve.gate.timeout.s",
                                       "30")


class SchemaEvolutionError(RuntimeError):
    """An evolve verb could not run (disabled, in flight, bad change
    spec), a write conflicted with an in-flight evolution (mid-drop
    attribute), or the type is mid-flip and needs ``resume()`` /
    ``abort()``. NOT retryable blindly — the message says which."""

    retryable = False


# numeric widenings update_schema allows: value-preserving casts only
# (Long -> Float would silently round 2^53-adjacent ids)
_WIDENINGS = {
    "Integer": ("Long", "Float", "Double"),
    "Long": ("Double",),
    "Float": ("Double",),
}


# -- schema / batch transforms ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ChangePlan:
    """The column-level work an update_schema implies: backfill
    defaults for adds, cast widens, omit drops. Empty for reindex."""

    adds: dict
    drops: frozenset
    widens: dict

    @property
    def empty(self) -> bool:
        return not (self.adds or self.drops or self.widens)

    def describe(self) -> dict:
        return {"adds": sorted(self.adds), "drops": sorted(self.drops),
                "widens": dict(self.widens)}


def _copy_attr(a: AttributeSpec) -> AttributeSpec:
    return AttributeSpec(a.name, a.type, dict(a.options), a.default_geom)


def _evolved_sft(sft: SimpleFeatureType, changes):
    """Apply a change list to a schema: each change is a mapping with
    ``op`` in add/widen/drop. Returns (new_sft, plan); raises typed on
    anything the evolution cannot carry out online."""
    attrs = [_copy_attr(a) for a in sft.attributes]
    by_name = {a.name: a for a in attrs}
    adds: dict = {}
    drops: set = set()
    widens: dict = {}
    if not changes:
        raise SchemaEvolutionError("update_schema needs a non-empty "
                                   "change list")
    for ch in changes:
        if not isinstance(ch, dict):
            raise SchemaEvolutionError(f"malformed change {ch!r}: "
                                       f"expected a mapping")
        op = ch.get("op")
        name = ch.get("name")
        if not name:
            raise SchemaEvolutionError(f"change {ch!r} needs a 'name'")
        if op == "add":
            if name in by_name:
                raise SchemaEvolutionError(
                    f"attribute {name!r} already exists")
            try:
                atype = _parse_type(str(ch.get("type", "String")))
            except ValueError as e:
                raise SchemaEvolutionError(str(e)) from None
            if atype.is_geometry or atype.name in ("List", "Map",
                                                   "Bytes"):
                raise SchemaEvolutionError(
                    f"cannot backfill a {atype} attribute online")
            spec = AttributeSpec(name, atype)
            attrs.append(spec)
            by_name[name] = spec
            adds[name] = ch.get("default")
        elif op == "widen":
            if name not in by_name:
                raise SchemaEvolutionError(f"no attribute {name!r} "
                                           f"in {sft.type_name}")
            cur = by_name[name].type.name
            try:
                target = _parse_type(str(ch.get("type", ""))).name
            except ValueError as e:
                raise SchemaEvolutionError(str(e)) from None
            if target not in _WIDENINGS.get(cur, ()):
                raise SchemaEvolutionError(
                    f"cannot widen {cur} -> {target} "
                    f"(value-preserving widenings only: {_WIDENINGS})")
            by_name[name].type = _parse_type(target)
            widens[name] = target
        elif op == "drop":
            if name not in by_name:
                raise SchemaEvolutionError(f"no attribute {name!r} "
                                           f"in {sft.type_name}")
            if name == sft.geom_field:
                raise SchemaEvolutionError(
                    "cannot drop the default geometry attribute")
            if name in adds or name in widens:
                raise SchemaEvolutionError(
                    f"attribute {name!r} both changed and dropped in "
                    f"one evolution")
            attrs.remove(by_name.pop(name))
            drops.add(name)
        else:
            raise SchemaEvolutionError(
                f"unknown change op {op!r}; expected add/widen/drop")
    user_data = dict(sft.user_data)
    if user_data.get(Configs.DEFAULT_DATE) in drops:
        del user_data[Configs.DEFAULT_DATE]
    new_sft = SimpleFeatureType(sft.type_name, attrs, user_data)
    return new_sft, _ChangePlan(adds, frozenset(drops), widens)


def _fill_column(a: AttributeSpec, default, n: int):
    """A length-n column holding the add-backfill default (None =
    all-null)."""
    t = a.type.name
    have = default is not None
    valid = np.full(n, have, dtype=bool)
    if t in ("Integer", "Long", "Float", "Double"):
        dtype = np.float64 if t in ("Float", "Double") else np.int64
        return NumericColumn(a.name,
                             np.full(n, default if have else 0, dtype),
                             valid)
    if t == "Boolean":
        return BoolColumn(a.name, np.full(n, bool(default), dtype=bool),
                          valid)
    if t == "Date":
        if not have:
            ms = 0
        elif isinstance(default, (int, float, np.integer)):
            ms = int(default)
        else:
            ms = int(np.datetime64(str(default), "ms").astype(np.int64))
        return DateColumn(a.name, np.full(n, ms, np.int64), valid)
    if t in ("String", "UUID"):
        if not have:
            return StringColumn(a.name, np.full(n, -1, np.int32),
                                np.empty(0, dtype=object))
        return StringColumn(a.name, np.zeros(n, np.int32),
                            np.array([str(default)], dtype=object))
    raise SchemaEvolutionError(f"cannot backfill type {t}")


def _widen_column(col, target: str):
    dtype = np.float64 if target in ("Float", "Double") else np.int64
    return NumericColumn(col.name, col.values.astype(dtype), col.valid)


def _transform_batch(batch: FeatureBatch, new_sft: SimpleFeatureType,
                     plan: _ChangePlan) -> FeatureBatch:
    """Rebuild a live-schema batch under the evolved schema. Unchanged
    columns are shared by reference — nothing mutates column arrays in
    place (flush/delete always build new arrays), so sharing is safe."""
    cols = {}
    for a in new_sft.attributes:
        if a.name in plan.adds:
            cols[a.name] = _fill_column(a, plan.adds[a.name], batch.n)
        elif a.name in plan.widens:
            cols[a.name] = _widen_column(batch.col(a.name),
                                         plan.widens[a.name])
        else:
            cols[a.name] = batch.col(a.name)
    return FeatureBatch(new_sft, batch.ids, cols)


# -- in-flight evolution state ---------------------------------------------

class _Evolution:
    """One in-flight schema evolution: the evolved schema, the shadow
    ``_TypeState`` accumulating the rebuild, and the WAL replay cursor.
    The shadow is invisible to reads until the flip — queries during
    the build stay exact against the live state."""

    def __init__(self, kind: str, type_name: str, old_sft, new_sft,
                 plan: _ChangePlan, old_state=None, registry=metrics):
        self.kind = kind                    # "reindex" | "update"
        self.type_name = type_name
        self.old_sft = old_sft
        self.new_sft = new_sft
        self.plan = plan
        self.old_state = old_state          # defensive un-swap anchor
        self.shadow = None                  # _TypeState, built by drive
        self.ids: set = set()               # shadow ids (dup detection)
        self.queue: list = []               # non-durable dual-feed
        self.phase = "install"
        self.lock = threading.RLock()
        self.cursor = 0                     # last WAL lsn staged
        self.barrier_lsn = None
        self.rows_built = 0
        self.rows_fed = 0
        self.rounds = 0
        self.started_ms = int(time.time() * 1000)
        self.error = None
        self._registry = registry

    @property
    def blocking(self) -> bool:
        """True once the flip has begun cutting — ops on the type must
        fail typed until resume/abort restores a consistent state."""
        return self.phase in ("cut", "broken")

    def describe(self) -> dict:
        return {"op": self.kind, "type": self.type_name,
                "phase": self.phase,
                "to_version": self.new_sft.index_version,
                "changes": (None if self.plan.empty
                            else self.plan.describe()),
                "rows_built": int(self.rows_built),
                "rows_fed": int(self.rows_fed),
                "rounds": self.rounds,
                "queued": len(self.queue),
                "cursor_lsn": self.cursor,
                "barrier_lsn": self.barrier_lsn,
                "started_ms": self.started_ms,
                "error": self.error}

    # -- staging (delete-then-write, idempotent on re-apply) ---------------

    def stage_write(self, batch: FeatureBatch, visibilities=None):
        b2 = _transform_batch(batch, self.new_sft, self.plan)
        ids = [str(i) for i in b2.ids]
        with self.lock:
            dup = self.ids.intersection(ids)
            if dup:
                self.shadow.delete(dup)
            self.shadow.append(b2, visibilities)
            self.ids.update(ids)
            self.rows_built = self.shadow.n
            self.rows_fed += b2.n

    def stage_delete(self, ids):
        ids = set(map(str, ids))
        with self.lock:
            present = self.ids & ids
            if present:
                self.shadow.delete(present)
                self.ids -= present
                self.rows_built = self.shadow.n


class _EvolveFeed:
    """The write-path tap ``InMemoryDataStore`` consults while an
    evolution is in flight: ``guard()`` fences every op typed while the
    flip is cut (called from ``_state``), ``check_write`` refuses
    writes carrying non-null values for a mid-drop attribute, and the
    ``on_write``/``on_delete`` hooks queue mutations for the shadow on
    non-durable stores (durable stores tail the WAL instead)."""

    def __init__(self, evo: _Evolution, queue_feed: bool):
        self._evo = evo
        self._queue_feed = queue_feed

    @property
    def blocking(self) -> bool:
        return self._evo.blocking

    def guard(self):
        evo = self._evo
        if evo.blocking:
            raise SchemaEvolutionError(
                f"type {evo.type_name!r} is mid-flip (evolution "
                f"{evo.phase}); resume() or abort() it first")

    def check_write(self, batch: FeatureBatch):
        evo = self._evo
        for name in evo.plan.drops:
            col = batch.columns.get(name)
            if col is not None and bool(np.any(col.valid)):
                evo._registry.counter("evolve.write.conflicts")
                raise SchemaEvolutionError(
                    f"attribute {name!r} of {evo.type_name!r} is being "
                    f"dropped by an in-flight schema evolution; the "
                    f"write carries non-null values for it")

    def on_write(self, batch: FeatureBatch, visibilities=None):
        if self._queue_feed:
            vis = None if visibilities is None else list(visibilities)
            with self._evo.lock:
                self._evo.queue.append(("w", batch, vis))

    def on_delete(self, ids):
        if self._queue_feed:
            with self._evo.lock:
                self._evo.queue.append(("d", sorted(ids), None))


# -- the evolver ------------------------------------------------------------

class Evolver:
    """Executes online reindex / update_schema against one
    ``InMemoryDataStore`` (or subclass). ``fault_hook(tag)`` is the
    kill-point seam the crash-safety tests arm (the CrashHarness
    shape): raising from it simulates a crash at that protocol point."""

    #: kill-point tags fault_hook can fire at, in protocol order
    PHASES = ("snapshot.start", "feed.installed", "snapshot.done",
              "catchup.done", "flip.enter", "flip.barrier", "flip.cut",
              "flip.swap", "flip.done")

    def __init__(self, store, registry=metrics):
        self._store = store
        self._registry = registry
        self._lock = threading.Lock()
        # control verbs (start/resume/abort) are mutually exclusive;
        # non-blocking acquire so a raced verb fails typed, not hangs
        self._verb_lock = threading.Lock()
        # evolve-plane surface gate (the Resharder's _OpGate): status
        # takes the shared side, install/flip/resume/abort the exclusive
        # side — writer-preferring, so a polling status stream cannot starve
        # the flip past its drain timeout. Store-op atomicity across
        # the swap comes from the store op lock (every store op is
        # _synchronized on it); the gate orders strictly before it.
        self._gate = _OpGate()
        self._active: _Evolution | None = None
        self.history: list[dict] = []
        self.fault_hook = None

    # -- plumbing ----------------------------------------------------------

    def _fault(self, tag: str):
        if self.fault_hook is not None:
            self.fault_hook(tag)

    @staticmethod
    def _enabled() -> bool:
        return str(EVOLVE_ENABLED.get()).lower() in ("true", "1", "yes")

    def _check_enabled(self):
        if not self._enabled():
            raise SchemaEvolutionError(
                "schema evolution disabled (geomesa.evolve.enabled="
                "false); use the blocking store.reindex oracle")

    def _gate_timeout(self) -> float:
        return EVOLVE_GATE_TIMEOUT_S.as_float() or 30.0

    @contextlib.contextmanager
    def _exclusive(self):
        try:
            with self._gate.exclusive(self._gate_timeout()):
                yield
        except ReshardError as e:
            # the shared gate type raises its own error on drain
            # timeout; surface it as this plane's typed error
            raise SchemaEvolutionError(str(e)) from None

    def status(self) -> dict:
        with self._gate.shared():
            evo = self._active
            return {"enabled": self._enabled(),
                    "active": None if evo is None else evo.describe(),
                    "phases": list(self.PHASES),
                    "history": list(self.history)}

    # -- verbs -------------------------------------------------------------

    def reindex(self, type_name: str, to_version=None) -> dict:
        """Migrate the type's z-index layout online: same data, same
        schema attributes, new ``geomesa.index.version`` — the shadow
        rebuilds the sort orders under the new curve while the old
        index serves every query until the flip."""
        self._check_enabled()
        to_version = check_index_version(to_version)
        old = self._store.get_schema(type_name)   # KeyError when absent
        if old.index_version == to_version:
            return {"op": "reindex", "type": type_name, "noop": True,
                    "to_version": to_version}
        user_data = dict(old.user_data)
        user_data[Configs.INDEX_VERSION] = to_version
        new_sft = SimpleFeatureType(
            old.type_name, [_copy_attr(a) for a in old.attributes],
            user_data)
        plan = _ChangePlan({}, frozenset(), {})
        return self._start("reindex", type_name, old, new_sft, plan)

    def update_schema(self, type_name: str, changes) -> dict:
        """Evolve the type's attribute set online: ``changes`` is a
        list of ``{"op": "add"|"widen"|"drop", "name": ..., ...}``
        mappings (add takes ``type`` + optional backfill ``default``,
        widen takes the target ``type``)."""
        self._check_enabled()
        old = self._store.get_schema(type_name)   # KeyError when absent
        new_sft, plan = _evolved_sft(old, changes)
        return self._start("update", type_name, old, new_sft, plan)

    def _start(self, kind, type_name, old_sft, new_sft, plan) -> dict:
        if not self._verb_lock.acquire(blocking=False):
            raise SchemaEvolutionError(
                "another evolve verb is in flight")
        try:
            evo = _Evolution(kind, type_name, old_sft, new_sft, plan,
                             old_state=self._store._types.get(type_name),
                             registry=self._registry)
            with self._lock:
                if self._active is not None:
                    raise SchemaEvolutionError(
                        f"evolution already in flight "
                        f"({self._active.type_name} "
                        f"{self._active.phase}); resume or abort it "
                        f"first")
                self._active = evo
            return self._drive(evo)
        finally:
            self._verb_lock.release()

    def resume(self) -> dict:
        """Re-drive an interrupted evolution to completion. Safe after
        a crash at any kill point: a cut flip redoes only the
        (idempotent) flip body; anything earlier rebuilds the shadow
        from scratch."""
        self._check_enabled()
        evo = self._active
        if evo is None:
            raise SchemaEvolutionError("no evolution to resume")
        if not self._verb_lock.acquire(blocking=False):
            raise SchemaEvolutionError(
                "another evolve verb is in flight")
        try:
            evo.error = None
            if evo.phase == "done":
                # crashed between the swap and the bookkeeping tail:
                # the flip itself completed — just close out
                with self._lock:
                    self._active = None
                self._persist_evolved()
                return self._record(evo, 0.0)
            if evo.phase in ("cut", "broken"):
                t0 = time.perf_counter()
                with self._exclusive():
                    with evo.lock:
                        evo.phase = "cut"
                    self._finish_flip(evo)
                self._persist_evolved()
                return self._record(
                    evo, (time.perf_counter() - t0) * 1e3)
            evo.phase = "snapshot"
            return self._drive(evo)
        finally:
            self._verb_lock.release()

    def abort(self) -> dict:
        """Cancel the active evolution and restore the pre-evolve
        state. The live ``_TypeState`` is never mutated before the
        swap, so abort just discards the shadow and uninstalls the
        feed; a post-swap evolution (phase done) cannot abort."""
        evo = self._active
        if evo is None:
            raise SchemaEvolutionError("no evolution to abort")
        if not self._verb_lock.acquire(blocking=False):
            raise SchemaEvolutionError(
                "another evolve verb is in flight")
        try:
            if evo.phase == "done":
                raise SchemaEvolutionError(
                    "evolution already flipped; run the inverse "
                    "reindex/update instead of abort")
            store = self._store
            with self._exclusive():
                with store._op_lock:
                    cur = store._types.get(evo.type_name)
                    if cur is evo.shadow and evo.old_state is not None:
                        # defensive: a half-finished swap un-swaps
                        store._types[evo.type_name] = evo.old_state
                    store._evolve_feeds.pop(evo.type_name, None)
                    store._bump_pushdown_version(evo.type_name)
                    store.result_cache.invalidate(evo.type_name)
                with evo.lock:
                    evo.phase = "aborted"
                    # the discarded shadow's device columns go with it;
                    # an aborted evolution anchors nothing
                    evo.shadow = evo.old_state = None
            with self._lock:
                self._active = None
            self._registry.counter("evolve.aborts")
            entry = {"op": "abort", "type": evo.type_name,
                     "kind": evo.kind, "ts_ms": int(time.time() * 1000)}
            self.history.append(entry)
            return entry
        finally:
            self._verb_lock.release()

    # -- protocol ----------------------------------------------------------

    def _drive(self, evo: _Evolution) -> dict:
        store = self._store
        journal = store.journal
        try:
            with tracer.span("evolve", f"{evo.kind}:{evo.type_name}"):
                self._fault("snapshot.start")
                with evo.lock:
                    # fresh shadow on every (re)drive: resume after a
                    # crash rebuilds from scratch — idempotent by
                    # reconstruction
                    evo.phase = "snapshot"
                    evo.shadow = store._new_state(evo.new_sft)
                    evo.ids = set()
                    evo.queue = []
                    evo.rows_built = 0
                    evo.rows_fed = 0
                    evo.cursor = 0
                    evo.barrier_lsn = None
                if journal is not None:
                    self._install_feed(evo, queue_feed=False)
                    self._fault("feed.installed")
                    with tracer.span("evolve-phase", "snapshot"):
                        self._snapshot_durable(evo, journal)
                else:
                    with tracer.span("evolve-phase", "snapshot"):
                        self._snapshot_live(evo)
                    self._fault("feed.installed")
                self._fault("snapshot.done")
                evo.phase = "catchup"
                with tracer.span("evolve-phase", "catchup"):
                    self._catchup(evo, journal)
                    # build the shadow's index off the critical path:
                    # the flip's final tail replay extends it
                    # incrementally and the cut stays short
                    with evo.lock:
                        evo.shadow.ensure_index()
                self._fault("catchup.done")
                with tracer.span("evolve-phase", "flip"):
                    flip_ms = self._flip(evo, journal)
            self._persist_evolved()
        except SchemaEvolutionError:
            raise
        except BaseException as e:
            evo.error = f"{type(e).__name__}: {e}"
            with evo.lock:
                if evo.phase == "cut":
                    evo.phase = "broken"
            self._registry.counter("evolve.failures")
            raise
        return self._record(evo, flip_ms)

    def _persist_evolved(self):
        """Persist the evolved schema: recovery reopens from the
        checkpoint manifest, which must carry the new
        spec/index_version (the WAL's create-schema record still holds
        the old one). Runs after EVERY completed flip — including one
        completed by resume() after a mid-flip crash."""
        if self._store.journal is None:
            return
        try:
            self._store.checkpoint()
        except Exception:
            import logging
            logging.getLogger("geomesa_tpu_torch").warning(
                "post-evolve checkpoint failed; the evolved schema is "
                "live but not yet durable", exc_info=True)

    def _install_feed(self, evo: _Evolution, queue_feed: bool):
        with self._store._op_lock:
            self._store._evolve_feeds[evo.type_name] = \
                _EvolveFeed(evo, queue_feed)

    def _snapshot_durable(self, evo: _Evolution, journal):
        """Snapshot via the checkpoint path: force a checkpoint (atomic
        + digest-verified by snapshot.py), load it back, stage the
        evolving type's batch. The WAL tail past the checkpoint LSN is
        replayed by catch-up."""
        from ..wal.snapshot import load_checkpoint
        self._store.checkpoint()
        loaded = load_checkpoint(journal.root)
        if loaded is None:
            # no loadable snapshot (all corrupt): fall back to a live
            # read under the op lock, cursor at the tail
            with self._store._op_lock:
                evo.cursor = int(journal.wal.last_lsn)
                self._copy_live(evo)
            return
        lsn, states = loaded
        evo.cursor = int(lsn)
        for sft, batch, vis in states:
            if sft.type_name != evo.type_name:
                continue
            if batch is None or not batch.n:
                continue
            evo.stage_write(batch,
                            None if vis is None else list(vis))

    def _snapshot_live(self, evo: _Evolution):
        """Non-durable store: copy the live state and install the
        queueing feed in ONE op-lock critical section, so no write can
        land between the point-in-time read and the dual-feed."""
        with self._store._op_lock:
            self._copy_live(evo)
            self._store._evolve_feeds[evo.type_name] = \
                _EvolveFeed(evo, queue_feed=True)

    def _copy_live(self, evo: _Evolution):
        st = self._store._types.get(evo.type_name)
        if st is None:
            raise SchemaEvolutionError(
                f"schema {evo.type_name!r} was dropped mid-evolution")
        batch = st.batch   # flushes pending
        if batch is None or not batch.n:
            return
        vis = list(st.vis) if st.has_vis else None
        evo.stage_write(batch, vis)

    def _replay_tail(self, evo: _Evolution, journal, upto=None) -> int:
        """Stage the WAL records past the cursor, filtered to the
        evolving type (LSN order is authoritative, so this converges
        regardless of interleaving)."""
        from ..wal.log import DELETE, WRITE, decode_delete, decode_write
        n = 0
        for lsn, kind, payload in journal.wal.records(evo.cursor + 1):
            if upto is not None and lsn > upto:
                break
            if kind == WRITE:
                tn, batch, vis = decode_write(payload)
                if (tn == evo.type_name and batch is not None
                        and batch.n):
                    evo.stage_write(batch,
                                    None if vis is None else list(vis))
            elif kind == DELETE:
                tn, ids = decode_delete(payload)
                if tn == evo.type_name:
                    evo.stage_delete(ids)
            evo.cursor = int(lsn)
            n += 1
        return n

    def _drain_queue(self, evo: _Evolution) -> int:
        n = 0
        while True:
            with evo.lock:
                if not evo.queue:
                    return n
                kind, payload, vis = evo.queue.pop(0)
                if kind == "w":
                    evo.stage_write(payload, vis)
                else:
                    evo.stage_delete(payload)
            n += 1

    def _catchup(self, evo: _Evolution, journal):
        """Bounded catch-up rounds: replay the tail while writers keep
        appending; once a round stages few enough records the final
        (gated) barrier replay is short."""
        rounds = max(EVOLVE_CATCHUP_ROUNDS.as_int() or 8, 1)
        settle = max(EVOLVE_CATCHUP_SETTLE.as_int() or 64, 0)
        for _ in range(rounds):
            evo.rounds += 1
            self._registry.counter("evolve.catchup.rounds")
            n = (self._replay_tail(evo, journal)
                 if journal is not None else self._drain_queue(evo))
            if n <= settle:
                return

    def _flip(self, evo: _Evolution, journal) -> float:
        store = self._store
        t0 = time.perf_counter()
        with self._exclusive():
            self._fault("flip.enter")
            with store._op_lock:
                if journal is not None:
                    evo.barrier_lsn = int(journal.wal.last_lsn)
                    self._replay_tail(evo, journal,
                                      upto=evo.barrier_lsn)
                else:
                    self._drain_queue(evo)
                self._fault("flip.barrier")
                with evo.lock:
                    evo.phase = "cut"   # ops on the type now fail typed
                self._fault("flip.cut")
                self._finish_flip(evo)
        return (time.perf_counter() - t0) * 1e3

    def _finish_flip(self, evo: _Evolution):
        """The flip body — idempotent end to end (reference-swap the
        state, recompute what the schema change invalidates) so
        ``resume()`` can re-run it after a crash at any point."""
        store = self._store
        with store._op_lock:
            if evo.type_name not in store._types:
                raise SchemaEvolutionError(
                    f"schema {evo.type_name!r} was dropped "
                    f"mid-evolution; abort")
            self._fault("flip.swap")
            old = store._types[evo.type_name]
            if old is not evo.shadow:
                store._types[evo.type_name] = evo.shadow
                # outstanding small lazy results must not pin the
                # superseded column snapshot
                old._detach_live()
            if evo.kind == "update":
                # additive stats accumulated under the old schema may
                # reference dropped/narrowed attributes: recompute
                store.stats.clear(evo.type_name)
                b = evo.shadow.batch
                if b is not None and b.n:
                    store.stats.observe(evo.new_sft, b)
                else:
                    store.stats.ensure(evo.new_sft)
            store._evolve_feeds.pop(evo.type_name, None)
            store._bump_pushdown_version(evo.type_name)
            store.result_cache.invalidate(evo.type_name)
            with evo.lock:
                evo.phase = "done"
                # a done evolution cannot abort: nothing un-swaps, so
                # the superseded state's device columns go now, even
                # while a crash below keeps the evolution active
                evo.old_state = None
        self._fault("flip.done")
        with self._lock:
            self._active = None

    def _record(self, evo: _Evolution, flip_ms: float) -> dict:
        entry = {"op": evo.kind, "type": evo.type_name,
                 "rows": int(evo.rows_built),
                 "to_version": evo.new_sft.index_version,
                 "barrier_lsn": evo.barrier_lsn,
                 "rounds": evo.rounds,
                 "flip_ms": round(flip_ms, 3),
                 "ts_ms": int(time.time() * 1000)}
        if not evo.plan.empty:
            entry["changes"] = evo.plan.describe()
        self.history.append(entry)
        self._registry.counter("evolve.completed")
        self._registry.counter("evolve.rows.built",
                               int(evo.rows_built))
        self._registry.gauge("evolve.flip.ms", flip_ms)
        return entry
