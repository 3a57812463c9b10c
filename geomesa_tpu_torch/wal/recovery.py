"""Open-time crash recovery: snapshot load + redo replay.

ARIES redo, restricted to the logical-record level: restore the newest
durable checkpoint, then re-apply every log record past the checkpoint
LSN. Replay is idempotent — a WRITE deletes its ids before re-inserting
(so a record applied both by the snapshot and the log, or replayed
twice, lands exactly once) — which lets the checkpoint capture state
concurrently with appenders: the snapshot may already contain rows
whose records sit above the checkpoint LSN, and redo simply re-applies
them.

Per-record apply failures are tolerated and counted (a generic
``DurableStore`` wrapper can journal a record whose apply then fails;
recovery must not wedge on it), and the torn-tail records dropped by
``WriteAheadLog`` open are surfaced here so one ``RecoveryReport``
describes the whole reopen.

The redo's delete goes only to ids the table holds. Replay keeps one set
of ids per type (``_HeldIds``), read from the store when a record first
touches the type and kept up to date as records apply; a WRITE deletes
just its ids that are in the set, and skips the delete when none are. A
delete of absent ids changes no row and no row order, so the rows and
their order equal the JAX recovery's, while a record of new ids costs
time in proportion to its own rows rather than the table's (the port's
``delete`` rebuilds the type's index and device columns).
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass, field

from ..metrics import metrics
from .log import (CHECKPOINT_MARK, CREATE_SCHEMA, DELETE, DROP_SCHEMA,
                  WRITE, _FRAME, decode_delete, decode_schema, decode_write)
from .snapshot import load_checkpoint

__all__ = ["RecoveryReport", "recover", "replay_into"]

_log = logging.getLogger("geomesa_tpu_torch.wal")


@dataclass
class RecoveryReport:
    """What a reopen did: how much state came from the snapshot, how
    much was redone from the log, and what the log scan cost."""

    checkpoint_lsn: int = 0
    snapshot_types: int = 0
    snapshot_rows: int = 0
    records_replayed: int = 0
    records_failed: int = 0          # apply raised; tolerated + counted
    rows_replayed: int = 0
    bytes_scanned: int = 0
    torn_records_dropped: int = 0
    corrupt_frames: int = 0          # invalid frames that ENDED replay
    replay_stopped_lsn: int = 0      # last LSN applied before the stop
    checkpoints_skipped: int = 0     # corrupt snapshots fallen past
    last_lsn: int = 0
    wall_time_s: float = 0.0
    errors: list = field(default_factory=list)  # first few, for the CLI

    def to_json_object(self) -> dict:
        return asdict(self)


def _ensure_schema(store, sft):
    if sft.type_name not in store.get_type_names():
        store.create_schema(sft)


class _HeldIds:
    """The feature ids each type of an InMemoryDataStore holds, as
    replay changes them. A type's set is read from the store's rows when
    a record first needs it."""

    def __init__(self, store):
        if not hasattr(store, "_types"):
            raise TypeError(f"cannot replay into a {type(store).__name__}")
        self._types = store._types
        self._sets: dict[str, set] = {}

    def get(self, type_name: str) -> set:
        held = self._sets.get(type_name)
        if held is None:
            batch = self._types[type_name].batch
            held = set() if batch is None else set(map(str, batch.ids))
            self._sets[type_name] = held
        return held

    def forget(self, type_name: str):
        self._sets.pop(type_name, None)


def _apply(store, kind: int, payload: bytes, report: RecoveryReport,
           held: _HeldIds):
    if kind == WRITE:
        tn, batch, vis = decode_write(payload)
        if batch is None or batch.n == 0:
            return
        _ensure_schema(store, batch.sft)
        # idempotence: a redo of rows the snapshot (or an earlier
        # replayed record) already holds must not duplicate them
        ids = held.get(tn)
        new = batch.ids.tolist()    # str: decoded from the record
        present = ids.intersection(new)
        if present:
            store.delete(tn, present)
            ids.difference_update(present)
        else:
            # the reference deletes the record's ids unconditionally,
            # and that delete stamps a pushdown version: stamp one here
            # too, so the versions after a reopen are the reference's
            store._bump_pushdown_version(tn)
        store.write(tn, batch,
                    visibilities=None if vis is None else list(vis))
        ids.update(new)
        report.rows_replayed += batch.n
    elif kind == DELETE:
        tn, gone = decode_delete(payload)
        if tn in store.get_type_names():
            store.delete(tn, gone)
            held.get(tn).difference_update(map(str, gone))
    elif kind == CREATE_SCHEMA:
        tn, spec = decode_schema(payload)
        if tn not in store.get_type_names():
            store.create_schema(tn, spec or "")
            held.forget(tn)
    elif kind == DROP_SCHEMA:
        tn, _spec = decode_schema(payload)
        if tn in store.get_type_names():
            store.remove_schema(tn)
            held.forget(tn)
    elif kind == CHECKPOINT_MARK:
        pass  # position marker only; the snapshot is the state
    else:
        raise ValueError(f"unknown record kind {kind}")


def replay_into(store, records, report: RecoveryReport | None = None,
                held: _HeldIds | None = None) -> RecoveryReport:
    """Redo an iterable of ``(lsn, kind, payload)`` records against a
    store (journaling suppressed by the caller). ``held`` carries the
    id sets across calls for a caller that alone writes the store (a
    replica applying one record at a time); by default each call reads
    them anew."""
    report = report if report is not None else RecoveryReport()
    held = _HeldIds(store) if held is None else held
    for lsn, kind, payload in records:
        report.bytes_scanned += _FRAME.size + len(payload)
        try:
            _apply(store, kind, payload, report, held)
        except Exception as e:
            report.records_failed += 1
            if len(report.errors) < 5:
                report.errors.append(f"lsn {lsn}: {e!r}")
            _log.warning("WAL replay: record lsn=%s kind=%s failed",
                         lsn, kind, exc_info=True)
        else:
            report.records_replayed += 1
        report.replay_stopped_lsn = lsn
    return report


def recover(store, wal, root: str, registry=metrics) -> RecoveryReport:
    """Full reopen sequence: load the newest checkpoint under ``root``
    into ``store``, then redo every log record past its LSN. ``wal`` is
    an already-open WriteAheadLog (its open truncated any torn tail)."""
    t0 = time.perf_counter()
    report = RecoveryReport()
    report.torn_records_dropped = getattr(wal, "torn_tail_records", 0)
    from_lsn = 1

    def skipped(path, why):
        report.checkpoints_skipped += 1
        if len(report.errors) < 5:
            report.errors.append(f"checkpoint skipped: {path}: {why}")
        _log.warning("recovery: skipping corrupt checkpoint %s (%s)",
                     path, why)

    ckpt = load_checkpoint(root, on_skip=skipped)
    if ckpt is not None:
        lsn0, states = ckpt
        report.checkpoint_lsn = lsn0
        from_lsn = lsn0 + 1
        for sft, batch, vis in states:
            _ensure_schema(store, sft)
            if batch is not None and batch.n:
                store.write(sft.type_name, batch,
                            visibilities=None if vis is None else list(vis))
                report.snapshot_rows += int(batch.n)
            report.snapshot_types += 1

    def torn(path, frames):
        report.corrupt_frames += frames
        if len(report.errors) < 5:
            report.errors.append(
                f"replay stopped at lsn {report.replay_stopped_lsn}: "
                f"{frames} invalid frame(s) in {path}")

    replay_into(store, wal.records(from_lsn, on_torn=torn), report)
    report.last_lsn = wal.last_lsn
    report.wall_time_s = time.perf_counter() - t0
    registry.gauge("wal.recovery.seconds", report.wall_time_s)
    registry.counter("wal.recovery.records", report.records_replayed)
    if report.checkpoints_skipped:
        registry.counter("integrity.recovery.checkpoints_skipped",
                         report.checkpoints_skipped)
    return report
