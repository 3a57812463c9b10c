"""The ``Journal`` façade stores embed, and a generic ``DurableStore``.

Two ways to opt in:

- constructor knob — ``InMemoryDataStore(durable_dir=...)`` embeds a
  ``Journal`` and follows the validate → journal → apply discipline
  natively (the live and lambda stores take the same knob);
- wrapper — ``DurableStore(inner, root)`` journals every mutation
  before delegating to any ``DataStore`` implementation, and replays
  the log into it on open.

Both journal BEFORE apply (write-ahead rule): a crash after the journal
fsync but before the in-memory apply is repaired by replay; a crash
before the fsync loses only what was never acknowledged durable.
"""

from __future__ import annotations

import json
import os

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType, parse_spec
from ..index.api import Query
from ..integrity.verify import quarantine, verify_checkpoint
from ..metrics import metrics
from ..store.api import DataStore
from .log import (CHECKPOINT_MARK, CREATE_SCHEMA, DROP_SCHEMA, DELETE, WRITE,
                  WriteAheadLog, encode_delete, encode_drop_schema,
                  encode_schema, encode_write)
from .recovery import RecoveryReport, recover
from .snapshot import (checkpoint_dirs, drop_stale_checkpoints,
                       iter_store_states, latest_checkpoint_lsn,
                       write_checkpoint)

__all__ = ["Journal", "DurableStore"]


class Journal:
    """One durable root = one WAL (``<root>/log``) + its checkpoints
    (``<root>/snapshots``). The ``log_*`` methods are no-ops while
    ``replaying`` — recovery drives the store's normal mutation surface
    and must not re-journal what it reads from the log."""

    def __init__(self, root: str, fsync: str | None = None,
                 segment_bytes: int | None = None,
                 interval_ms: float | None = None, registry=metrics):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.registry = registry
        self.wal = WriteAheadLog(os.path.join(root, "log"), fsync=fsync,
                                 segment_bytes=segment_bytes,
                                 interval_ms=interval_ms, registry=registry)
        self.replaying = False
        self.last_report: RecoveryReport | None = None

    # -- journaling (called by stores BEFORE they apply) -------------------

    def log_write(self, type_name: str, batch, visibilities=None):
        if self.replaying:
            return None
        with self.registry.time("wal.encode"):
            payload = encode_write(type_name, batch, visibilities)
        return self.wal.append(WRITE, payload)

    def log_delete(self, type_name: str, ids):
        if self.replaying:
            return None
        return self.wal.append(DELETE, encode_delete(type_name, ids))

    def log_create_schema(self, sft):
        if self.replaying:
            return None
        return self.wal.append(CREATE_SCHEMA, encode_schema(sft))

    def log_drop_schema(self, type_name: str):
        if self.replaying:
            return None
        return self.wal.append(DROP_SCHEMA, encode_drop_schema(type_name))

    # -- recovery / checkpoint ---------------------------------------------

    def recover(self, store) -> RecoveryReport:
        """Replay checkpoint + log into ``store`` (journaling
        suppressed for the duration)."""
        self.replaying = True
        try:
            self.last_report = recover(store, self.wal, self.root,
                                       self.registry)
        finally:
            self.replaying = False
        return self.last_report

    def checkpoint(self, store, keep: int = 2) -> dict:
        """Snapshot ``store`` and compact the log.

        The covered LSN is captured BEFORE the snapshot: rows appended
        while the snapshot runs may land in both the snapshot and the
        replayed tail, which idempotent redo collapses — so appenders
        are never blocked.

        Two integrity couplings gate the compaction. First, the fresh
        snapshot is read back and digest-verified before any log
        truncation — a checkpoint silently corrupted on the way down
        (bit flip) must never become the excuse for deleting the
        records that could rebuild it. Second, the log is truncated
        below the OLDEST checkpoint still retained (``keep`` defaults
        to 2), so if the newest snapshot later rots, replaying from the
        prior one is id-exact rather than lossy."""
        lsn = self.wal.last_lsn
        self.wal.sync()  # records <= lsn must be durable before the
        #                  checkpoint claims to cover them
        path = write_checkpoint(self.root, iter_store_states(store), lsn,
                                self.registry)
        rep = verify_checkpoint(path)
        if not rep["ok"]:
            self.registry.counter("integrity.checkpoint.writeback_failures")
            quarantine(path, self.registry)
            raise OSError("checkpoint failed read-back verification "
                          "(log NOT truncated): "
                          + "; ".join(rep["errors"]))
        self.wal.append(CHECKPOINT_MARK,
                        json.dumps({"lsn": lsn}).encode())
        stale = drop_stale_checkpoints(self.root, keep=keep)
        dirs = checkpoint_dirs(self.root)
        floor = dirs[0][0] if dirs else lsn
        dropped = self.wal.truncate_below(floor)
        return {"lsn": lsn, "path": path, "segments_dropped": dropped,
                "checkpoints_dropped": stale}

    # -- inspection ---------------------------------------------------------

    @property
    def poisoned(self) -> bool:
        """True once the WAL refused durability (failed fsync/write):
        journal-before-apply then makes the owning store read-only —
        every mutation raises ``DurabilityError`` at the journal step,
        before any in-memory state changes."""
        return self.wal.poisoned

    def stats(self) -> dict:
        out = self.wal.scan_stats()
        out["root"] = self.root
        out["checkpoint_lsn"] = latest_checkpoint_lsn(self.root)
        out["poisoned"] = self.wal.poisoned
        if self.wal.poison_cause is not None:
            out["poison_cause"] = repr(self.wal.poison_cause)
        if self.last_report is not None:
            out["recovery"] = self.last_report.to_json_object()
        return out

    def close(self):
        self.wal.close()

    def abort(self):
        """Simulated-crash disposal: drop the WAL handle without
        flushing (see ``WriteAheadLog.abort``)."""
        self.wal.abort()


class DurableStore(DataStore):
    """Journal-before-apply wrapper over any DataStore. On open it
    replays the durable root into ``inner`` (pass a FRESH inner store —
    replay assumes it holds nothing the log doesn't know about).

    Don't stack it on a store that already journals natively
    (``durable_dir=`` knob) — every mutation would be logged twice."""

    def __init__(self, inner: DataStore, root: str,
                 fsync: str | None = None,
                 segment_bytes: int | None = None,
                 interval_ms: float | None = None,
                 recover_on_open: bool = True, registry=metrics):
        self.inner = inner
        self.journal = Journal(root, fsync=fsync,
                               segment_bytes=segment_bytes,
                               interval_ms=interval_ms, registry=registry)
        self.recovery: RecoveryReport | None = (
            self.journal.recover(inner) if recover_on_open else None)

    # -- schema -------------------------------------------------------------

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        if sft.type_name in self.inner.get_type_names():
            raise ValueError(f"schema {sft.type_name!r} already exists")
        self.journal.log_create_schema(sft)
        self.inner.create_schema(sft)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self.inner.get_schema(type_name)

    def get_type_names(self) -> list[str]:
        return self.inner.get_type_names()

    def remove_schema(self, type_name: str):
        if type_name in self.inner.get_type_names():
            self.journal.log_drop_schema(type_name)
        self.inner.remove_schema(type_name)

    # -- mutations (journal, then apply) ------------------------------------

    def write(self, type_name: str, batch: FeatureBatch, **kwargs):
        vis = kwargs.get("visibilities")
        self.journal.log_write(type_name, batch, vis)
        self.inner.write(type_name, batch, **kwargs)

    def delete(self, type_name: str, ids):
        ids = [str(i) for i in ids]
        self.journal.log_delete(type_name, ids)
        self.inner.delete(type_name, ids)

    # -- queries (pure delegation) -------------------------------------------

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None):
        return self.inner.query(q, type_name, explain_out=explain_out)

    def count(self, type_name: str) -> int:
        return self.inner.count(type_name)

    # -- durability surface ---------------------------------------------------

    def checkpoint(self, keep: int = 2) -> dict:
        return self.journal.checkpoint(self.inner, keep=keep)

    def close(self):
        self.journal.close()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        # everything else (query_batched, density, stats_query, ...)
        # rides through to the wrapped store
        return getattr(self.inner, name)
