"""End-to-end integrity checks over the durable artifacts.

The WAL already CRC-frames every record; this module closes the other
gaps: checkpoint ``.bin`` payloads get a per-file SHA-256 + length in
the manifest (written by ``wal.snapshot.write_checkpoint``), and the
functions here re-verify both artifact families: at load time
(``load_checkpoint`` falls back past a corrupt snapshot) and at write
time (``Journal.checkpoint`` reads a new snapshot back before it
truncates the log). The scrubber and the replicas' checks come with the
cluster tier (ROADMAP.md section 6).

``quarantine`` renames a corrupt artifact to ``*.corrupt`` so loaders
stop selecting it while the evidence survives for forensics — the
disposition Ext4/ZFS scrubs apply to unrecoverable blocks.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..metrics import metrics

__all__ = ["sha256_hex", "file_sha256", "verify_checkpoint",
           "verify_wal", "ids_digest", "quarantine"]

_QUARANTINE_SUFFIX = ".corrupt"


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_sha256(path: str) -> tuple[str, int]:
    """(hex digest, byte length) of a file, streamed."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def verify_checkpoint(path: str) -> dict:
    """Re-verify one checkpoint directory against its manifest.

    Returns ``{"ok", "lsn", "errors": [...], "files_checked",
    "unreferenced": [...]}``. Manifests from before digests were
    recorded verify by existence only (never retroactively condemned).
    ``unreferenced`` lists files the manifest doesn't claim — debris
    from a crashed earlier checkpoint attempt at the same LSN; they are
    flagged, not errors (the referenced state is intact)."""
    out = {"ok": True, "lsn": 0, "errors": [], "files_checked": 0,
           "unreferenced": []}

    def fail(msg):
        out["ok"] = False
        out["errors"].append(msg)

    mpath = os.path.join(path, "MANIFEST.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        fail("missing MANIFEST.json")
        return out
    except (ValueError, OSError) as e:
        fail(f"unreadable MANIFEST.json: {e!r}")
        return out
    out["lsn"] = int(manifest.get("lsn", 0))
    referenced = {"MANIFEST.json"}
    for t in manifest.get("types", []):
        fname = t.get("file")
        if not fname:
            continue
        referenced.add(fname)
        fpath = os.path.join(path, fname)
        try:
            digest, size = file_sha256(fpath)
        except FileNotFoundError:
            fail(f"{fname}: missing")
            continue
        except OSError as e:
            fail(f"{fname}: unreadable ({e!r})")
            continue
        out["files_checked"] += 1
        want_bytes = t.get("bytes")
        if want_bytes is not None and int(want_bytes) != size:
            fail(f"{fname}: length {size} != manifest {want_bytes}")
            continue
        want_sha = t.get("sha256")
        if want_sha is not None and want_sha != digest:
            fail(f"{fname}: sha256 mismatch")
    try:
        for fname in sorted(os.listdir(path)):
            if fname in referenced or fname.endswith(_QUARANTINE_SUFFIX):
                continue
            out["unreferenced"].append(fname)
    except OSError:
        pass
    return out


def verify_wal(logdir: str) -> dict:
    """Re-scan every WAL segment's CRC frames.

    A torn/invalid frame in the *tail* segment is the normal crash
    residue the next open truncates (reported, not an error); the same
    thing mid-history means silent corruption of records that were once
    valid — those segments are reported in ``corrupt_segments`` and
    fail the check."""
    from ..wal.log import _scan_segment, list_segments
    out = {"ok": True, "segments": 0, "records": 0, "corrupt_segments": [],
           "tail_torn_records": 0, "errors": []}
    segs = list_segments(logdir)
    out["segments"] = len(segs)
    for i, (first_lsn, path) in enumerate(segs):
        n = 0

        def count(rec):
            nonlocal n
            n += 1
        try:
            _good_end, torn = _scan_segment(path, on_record=count)
        except (OSError, ValueError) as e:
            out["ok"] = False
            out["errors"].append(f"{os.path.basename(path)}: {e!r}")
            out["corrupt_segments"].append(os.path.basename(path))
            continue
        out["records"] += n
        if torn:
            if i == len(segs) - 1:
                out["tail_torn_records"] += torn
            else:
                out["ok"] = False
                out["corrupt_segments"].append(os.path.basename(path))
                out["errors"].append(
                    f"{os.path.basename(path)}: {torn} invalid frame(s) "
                    f"mid-history")
    return out


def ids_digest(store, type_name: str) -> tuple[int, str]:
    """(row count, order-independent content digest) for one type — the
    anti-entropy comparison unit: two stores holding the same feature
    ids produce the same digest regardless of insertion order."""
    res = store.query("INCLUDE", type_name)
    ids = sorted(map(str, res.ids)) if res.batch is not None else []
    h = hashlib.sha256()
    for i in ids:
        h.update(i.encode())
        h.update(b"\x00")
    return len(ids), h.hexdigest()


def quarantine(path: str, registry=metrics) -> str | None:
    """Rename a corrupt artifact (file or checkpoint directory) to
    ``<path>.corrupt`` so loaders skip it. Returns the new path, or
    None when the rename failed (already quarantined / races)."""
    from ..store.filebus import fsync_dir
    target = path + _QUARANTINE_SUFFIX
    n = 1
    while os.path.exists(target):
        target = f"{path}{_QUARANTINE_SUFFIX}.{n}"
        n += 1
    try:
        os.rename(path, target)
    except OSError:
        return None
    fsync_dir(os.path.dirname(path) or ".")
    registry.counter("integrity.quarantined")
    return target
