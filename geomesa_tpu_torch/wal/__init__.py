"""Durability subsystem: write-ahead log, checkpoints, crash recovery.

The reference gets durability for its near-real-time tier by layering
on Kafka (the Lambda store merges transient state with long-term
persistence); an in-memory store's columns live on the GPU, so without
a journal a process crash loses every write since startup. This package
closes that gap with the classic ARIES-style journal/checkpoint/replay
discipline, in the JAX package's on-disk layout (either package
recovers a directory the other wrote):

- ``log.py``      — append-only segmented log, CRC-framed records,
  monotonic LSNs, group-commit with a configurable fsync policy,
  torn-tail truncation on open;
- ``snapshot.py`` — atomic checkpoint of a store's host-side column
  state + schema + index-version metadata, with retention that drops
  log segments wholly below the last durable checkpoint;
- ``recovery.py`` — open-time replay (snapshot load + redo past the
  checkpoint LSN, idempotent on reapplied ids, deleting only ids the
  table holds) with a RecoveryReport;
- ``durable.py``  — the ``Journal`` façade the stores embed, and a
  generic ``DurableStore`` wrapper for any DataStore.
"""

from .log import (CHECKPOINT_MARK, CREATE_SCHEMA, DELETE, DROP_SCHEMA,
                  WRITE, DurabilityError, WriteAheadLog, decode_delete,
                  decode_schema, decode_write, encode_delete,
                  encode_drop_schema, encode_schema, encode_write)
from .snapshot import (latest_checkpoint_lsn, load_checkpoint,
                       write_checkpoint)
from .recovery import RecoveryReport, recover, replay_into
from .durable import DurableStore, Journal

__all__ = [
    "WriteAheadLog", "DurabilityError", "WRITE", "DELETE",
    "CREATE_SCHEMA", "DROP_SCHEMA", "CHECKPOINT_MARK",
    "encode_write", "decode_write", "encode_delete", "decode_delete",
    "encode_schema", "decode_schema", "encode_drop_schema",
    "write_checkpoint", "load_checkpoint", "latest_checkpoint_lsn",
    "RecoveryReport", "recover", "replay_into",
    "Journal", "DurableStore",
]
