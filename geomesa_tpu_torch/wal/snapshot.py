"""Checkpoint/restore: atomic snapshots of a store's host-side state.

A checkpoint bounds recovery time and enables log compaction: once a
snapshot at LSN ``L`` is durable, replay starts from the snapshot and
only redoes records past ``L``, and segments wholly below ``L`` can be
unlinked (``log.truncate_below``).

Layout (under the durable root)::

    snapshots/ckpt-<lsn:020d>/
        <type>.bin      — filebus wire format: JSON header (spec, vis)
                          + Arrow IPC column batch
        MANIFEST.json   — {lsn, types: [{name, rows, index_version,
                          file}], created_ms}

Every file goes through ``filebus.write_bytes_atomic`` /
``write_json_atomic`` (tmp + fsync + rename + directory fsync), and the
manifest is written LAST — a crash mid-checkpoint leaves either a fully
valid snapshot or a manifest-less directory that loaders ignore.
"""

from __future__ import annotations

import os
import json
import shutil
import time

from ..features.sft import encode_spec, parse_spec
from ..integrity.verify import quarantine, sha256_hex, verify_checkpoint
from ..metrics import metrics
from ..store.filebus import fsync_dir, write_bytes_atomic, write_json_atomic
from ..utils.properties import INTEGRITY_QUARANTINE
from .log import decode_write, encode_write

__all__ = ["write_checkpoint", "load_checkpoint", "latest_checkpoint_lsn",
           "iter_store_states", "drop_stale_checkpoints"]

_DIR_PREFIX = "ckpt-"


def _snap_root(root: str) -> str:
    return os.path.join(root, "snapshots")


def checkpoint_dirs(root: str) -> list[tuple[int, str]]:
    """Sorted (lsn, path) of checkpoint dirs that have a manifest."""
    base = _snap_root(root)
    out = []
    if not os.path.isdir(base):
        return out
    for d in os.listdir(base):
        if not d.startswith(_DIR_PREFIX):
            continue
        path = os.path.join(base, d)
        if not os.path.exists(os.path.join(path, "MANIFEST.json")):
            continue  # crash mid-checkpoint: ignore, never load
        try:
            out.append((int(d[len(_DIR_PREFIX):]), path))
        except ValueError:
            continue
    return sorted(out)


def latest_checkpoint_lsn(root: str) -> int:
    """LSN of the newest durable checkpoint, 0 when none exists."""
    dirs = checkpoint_dirs(root)
    return dirs[-1][0] if dirs else 0


def iter_store_states(store):
    """Yield (sft, host batch | None, vis array | None) for every type
    in a store, reaching through the wrapper layers the durable knob
    composes (live -> memory, lambda -> transient live, DurableStore ->
    inner)."""
    if hasattr(store, "_types"):          # InMemoryDataStore
        for st in store._types.values():
            st.flush()
            yield st.sft, st._batch, (st._vis if st.has_vis else None)
        return
    if hasattr(store, "_mem"):            # LiveDataStore
        yield from iter_store_states(store._mem)
        return
    if hasattr(store, "transient"):       # LambdaDataStore
        yield from iter_store_states(store.transient)
        return
    if hasattr(store, "inner"):           # DurableStore wrapper
        yield from iter_store_states(store.inner)
        return
    raise TypeError(f"cannot snapshot a {type(store).__name__}")


def write_checkpoint(root: str, states, lsn: int,
                     registry=metrics) -> str:
    """Write a snapshot of ``states`` (an ``iter_store_states``-shaped
    iterable) tagged with the log position ``lsn`` it covers. Returns
    the checkpoint directory path.

    The whole directory is staged as a ``.tmp`` sibling and renamed
    into place once complete — re-using the final directory would let a
    crashed earlier attempt at the same LSN leave stale ``.bin`` files
    the new manifest doesn't reference. Within the staged dir the
    manifest is still written last and carries each payload's SHA-256 +
    length, so loaders and replicas can verify end-to-end."""
    base = _snap_root(root)
    path = os.path.join(base, f"{_DIR_PREFIX}{lsn:020d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)  # debris from a crashed earlier attempt
    os.makedirs(tmp)
    types = []
    total_bytes = 0
    for sft, batch, vis in states:
        fname = f"{sft.type_name}.bin"
        n = 0 if batch is None else batch.n
        if batch is not None:
            raw = encode_write(sft.type_name, batch, vis)
        else:
            # schema-only type: persist the spec so recovery recreates
            # the (empty) schema without a CREATE_SCHEMA log record
            raw = b""
        entry = {"name": sft.type_name, "rows": int(n),
                 "index_version": sft.index_version,
                 "spec": encode_spec(sft),
                 "file": fname if raw else None}
        if raw:
            entry["sha256"] = sha256_hex(raw)
            entry["bytes"] = len(raw)
            write_bytes_atomic(os.path.join(tmp, fname), raw)
            total_bytes += len(raw)
        types.append(entry)
    write_json_atomic(os.path.join(tmp, "MANIFEST.json"),
                      {"lsn": int(lsn), "types": types,
                       "created_ms": int(time.time() * 1000)})
    if os.path.exists(path):
        shutil.rmtree(path)  # same-LSN predecessor being replaced
    os.rename(tmp, path)
    fsync_dir(base)
    registry.counter("wal.checkpoints")
    registry.counter("wal.checkpoint.bytes", total_bytes)
    return path


def load_checkpoint(root: str, on_skip=None):
    """Load the newest durable checkpoint that VERIFIES.

    Each candidate (newest first) is digest-checked against its
    manifest before a byte of it is trusted; a corrupt one is reported
    via ``on_skip(path, why)``, quarantined (renamed ``*.corrupt``)
    when ``geomesa.integrity.quarantine`` is on, and the next-newest
    tried — degrading to ``None`` (full WAL replay) when none survive.
    Returns ``(lsn, [(sft, batch | None, vis | None)])`` or ``None``."""
    for lsn, path in reversed(checkpoint_dirs(root)):
        rep = verify_checkpoint(path)
        if not rep["ok"]:
            metrics.counter("integrity.load.fallbacks")
            if on_skip is not None:
                on_skip(path, "; ".join(rep["errors"]) or "corrupt")
            if INTEGRITY_QUARANTINE.as_bool():
                quarantine(path)
            continue
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        out = []
        for t in manifest["types"]:
            sft = parse_spec(t["name"], t.get("spec") or "")
            if t.get("file"):
                with open(os.path.join(path, t["file"]), "rb") as f:
                    _tn, batch, vis = decode_write(f.read())
                out.append((sft, batch, vis))
            else:
                out.append((sft, None, None))
        return int(manifest["lsn"]), out
    return None


def drop_stale_checkpoints(root: str, keep: int = 1) -> int:
    """Remove all but the ``keep`` newest checkpoints (retention after
    a successful new checkpoint). Returns directories removed.

    The manifest is deleted first and the deletion fsynced before the
    rest of the tree goes: a crash mid-``rmtree`` then leaves a
    manifest-less directory that ``checkpoint_dirs`` already ignores,
    never a manifest-bearing husk that ``load_checkpoint`` would select
    and crash on."""
    dirs = checkpoint_dirs(root)
    removed = 0
    for _lsn, path in dirs[:-keep] if keep else dirs:
        manifest = os.path.join(path, "MANIFEST.json")
        try:
            os.unlink(manifest)
        except FileNotFoundError:
            pass
        fsync_dir(path)
        shutil.rmtree(path, ignore_errors=True)
        removed += 1
    return removed
