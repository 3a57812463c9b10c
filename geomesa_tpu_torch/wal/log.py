"""Append-only segmented write-ahead log with CRC-framed records.

The journal half of the durability subsystem (the redo log of ARIES;
Kafka's per-partition segment log has the same on-disk shape). Records
carry monotonically increasing LSNs and append through a group-commit
path whose fsync policy is configurable:

- ``always``      — every ``append`` returns only after the record is
  fsynced; concurrent appenders coalesce into one fsync (the leader
  syncs for everyone appended so far — group commit);
- ``interval_ms`` — a daemon flusher fsyncs at most every N ms; an
  acknowledged write can lose at most that window on a crash;
- ``never``       — no explicit fsync (the OS decides); fastest, for
  workloads whose durability floor is the periodic checkpoint.

Segment files are named by the first LSN they contain
(``wal-<lsn:020d>.log``) and rotate at a size threshold, so retention
after a checkpoint is just "unlink whole segments below the checkpoint
LSN". Each segment starts with a small header naming the frame version
and the checksum algorithm in use; each record frame is::

    u32 crc   — over the 13 header bytes after it + the payload
    u32 len   — payload length
    u64 lsn
    u8  kind
    payload

On open, the tail segment is scanned and truncated at the last valid
frame (torn-tail discipline: a crash mid-append must not wedge the log
or replay garbage). CRC-32C (Castagnoli) is used when a native
implementation is importable; otherwise the frame falls back to zlib's
CRC-32 and the segment header records which one, so readers always
validate with the writer's algorithm. The frames, the segment header and
the WRITE/DELETE payloads are byte-compatible with the JAX package's
log: either package reads a directory the other wrote.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
import zlib

from ..features.sft import encode_spec
from ..integrity import faultfs
from ..metrics import metrics
from ..store.filebus import _decode, _encode, fsync_dir
from ..store.live import GeoMessage
from ..utils.properties import WAL_FSYNC, WAL_INTERVAL_MS, WAL_SEGMENT_BYTES

__all__ = ["WriteAheadLog", "DurabilityError", "WRITE", "DELETE",
           "CREATE_SCHEMA", "DROP_SCHEMA", "CHECKPOINT_MARK",
           "inspect_dir",
           "WAL_FSYNC", "WAL_SEGMENT_BYTES", "WAL_INTERVAL_MS",
           "encode_write", "decode_write", "encode_delete",
           "decode_delete", "encode_schema", "decode_schema",
           "encode_drop_schema"]


class DurabilityError(OSError):
    """The WAL can no longer promise durability and has poisoned
    itself. Raised by every subsequent append/sync; the owning store
    degrades to read-only.

    The trigger is a failed storage-side write or fsync. After a
    failed fsync in particular the kernel may have already dropped the
    dirty pages while keeping the file marked clean, so retrying the
    same fsync can falsely succeed without the data being on disk
    (fsyncgate — Rebello et al., ATC '20). The only honest move is to
    refuse further writes on this log handle; recovery is a fresh
    process re-reading what the disk actually holds."""

# record kinds
WRITE = 1
DELETE = 2
CREATE_SCHEMA = 3
DROP_SCHEMA = 4
CHECKPOINT_MARK = 5

KIND_NAMES = {WRITE: "write", DELETE: "delete",
              CREATE_SCHEMA: "create_schema", DROP_SCHEMA: "drop_schema",
              CHECKPOINT_MARK: "checkpoint"}

_MAGIC = b"GMTPUWAL"
_SEG_VERSION = 1
_HEADER = struct.Struct("<8sBB")      # magic, version, checksum algo
_FRAME = struct.Struct("<IIQB")       # crc, len, lsn, kind
_CKSUM_CRC32C = 1
_CKSUM_CRC32 = 2


def _resolve_checksum():
    """(algo id, fn) — native CRC-32C when available, zlib CRC-32
    otherwise. The algo id is persisted in each segment header so the
    reader always validates with the writer's algorithm."""
    try:
        from crc32c import crc32c as f  # type: ignore[import-not-found]
        return _CKSUM_CRC32C, lambda b: f(b) & 0xFFFFFFFF
    except ImportError:
        pass
    try:
        import google_crc32c  # type: ignore[import-not-found]
        return _CKSUM_CRC32C, lambda b: google_crc32c.value(b)
    except ImportError:
        pass
    return _CKSUM_CRC32, lambda b: zlib.crc32(b) & 0xFFFFFFFF


def _checksum_for(algo: int):
    if algo == _CKSUM_CRC32:
        return lambda b: zlib.crc32(b) & 0xFFFFFFFF
    got, fn = _resolve_checksum()
    if got != algo:
        raise ValueError("segment written with CRC-32C but no native "
                         "crc32c implementation is importable")
    return fn


def segment_file(first_lsn: int) -> str:
    return f"wal-{first_lsn:020d}.log"


def list_segments(root: str) -> list[tuple[int, str]]:
    """Sorted (first_lsn, path) for every segment under ``root``."""
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return out
    for f in names:
        if f.startswith("wal-") and f.endswith(".log"):
            try:
                out.append((int(f[4:-4]), os.path.join(root, f)))
            except ValueError:
                continue
    return sorted(out)


def inspect_dir(root: str) -> dict:
    """Read-only scan of a WAL directory (the CLI's ``wal inspect``):
    the ``scan_stats()`` shape without opening the log for append — no
    torn-tail truncation, no lock, safe against a live writer."""
    segs = []
    counts: dict[str, int] = {}
    total_bytes = 0
    torn = 0
    last_lsn = 0
    last_checkpoint = None
    for first_lsn, path in list_segments(root):
        n = 0
        lo = hi = None

        def note(rec):
            nonlocal n, lo, hi, last_lsn, last_checkpoint
            lsn, kind, payload = rec
            n += 1
            lo = lsn if lo is None else lo
            hi = lsn
            last_lsn = max(last_lsn, lsn)
            name = KIND_NAMES.get(kind, str(kind))
            counts[name] = counts.get(name, 0) + 1
            if kind == CHECKPOINT_MARK:
                try:
                    last_checkpoint = json.loads(payload.decode())
                except (ValueError, UnicodeDecodeError):
                    pass
        good_end, t = _scan_segment(path, on_record=note)
        torn += t
        size = os.path.getsize(path)
        total_bytes += size
        segs.append({"file": os.path.basename(path),
                     "first_lsn": first_lsn, "records": n,
                     "lsn_range": [lo, hi], "bytes": size,
                     "valid_bytes": good_end})
    return {"segments": segs, "records_by_kind": counts,
            "bytes": total_bytes, "last_lsn": last_lsn,
            "torn_records": torn, "last_checkpoint": last_checkpoint}


# -- record payload codecs -------------------------------------------------
# WRITE/DELETE reuse the filebus GeoMessage wire format (JSON header +
# Arrow IPC batch): self-describing, so replay needs no out-of-band
# schema exchange and the two durable logs stay mutually readable.

def encode_write(type_name: str, batch, visibilities=None) -> bytes:
    vis = (None if visibilities is None
           else tuple(None if v is None else str(v) for v in visibilities))
    return _encode(GeoMessage("create", type_name, batch,
                              timestamp_ms=int(time.time() * 1000),
                              visibilities=vis))


def decode_write(payload: bytes):
    """-> (type_name, FeatureBatch, visibilities tuple | None)"""
    msg = _decode(payload)
    return msg.type_name, msg.batch, msg.visibilities


def encode_delete(type_name: str, ids) -> bytes:
    return _encode(GeoMessage("delete", type_name,
                              ids=tuple(map(str, ids)),
                              timestamp_ms=int(time.time() * 1000)))


def decode_delete(payload: bytes):
    """-> (type_name, ids tuple)"""
    msg = _decode(payload)
    return msg.type_name, msg.ids


def encode_schema(sft) -> bytes:
    return json.dumps({"type_name": sft.type_name,
                       "spec": encode_spec(sft)}).encode()


def decode_schema(payload: bytes):
    """-> (type_name, spec string | None)"""
    obj = json.loads(payload.decode())
    return obj["type_name"], obj.get("spec")


def encode_drop_schema(type_name: str) -> bytes:
    return json.dumps({"type_name": type_name}).encode()


class WriteAheadLog:
    """Segmented append-only log; thread-safe.

    ``append`` frames the payload, writes it to the current segment and
    applies the fsync policy before returning; ``records`` iterates
    every valid frame at or past a starting LSN; ``truncate_below``
    unlinks segments wholly below a retention LSN (checkpoint
    compaction).
    """

    def __init__(self, root: str, fsync: str | None = None,
                 segment_bytes: int | None = None,
                 interval_ms: float | None = None, registry=metrics):
        self.root = root
        self.fsync_policy = str(fsync if fsync is not None
                                else WAL_FSYNC.get())
        if self.fsync_policy not in ("always", "interval", "never"):
            raise ValueError(
                f"unknown fsync policy {self.fsync_policy!r}")
        self.segment_bytes = int(segment_bytes if segment_bytes is not None
                                 else WAL_SEGMENT_BYTES.get())
        self.interval_ms = float(interval_ms if interval_ms is not None
                                 else WAL_INTERVAL_MS.get())
        self.registry = registry
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()          # append path
        self._sync_cond = threading.Condition()  # group-commit path
        self._sync_in_progress = False
        self._fd: io.BufferedWriter | None = None
        self._seg_start_lsn = 0
        self._seg_bytes = 0
        self._seg_path = ""
        self._closed = False
        self._poisoned: OSError | None = None
        self.torn_tail_records = 0  # dropped by open-time truncation
        self._cksum_algo, self._cksum = _resolve_checksum()
        self._recover_tail()
        self._flusher: threading.Thread | None = None
        self._flusher_stop = threading.Event()
        if self.fsync_policy == "interval":
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name="wal-interval-flusher")
            self._flusher.start()

    # -- open-time tail recovery ------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        """Sorted (first_lsn, path) for every segment on disk."""
        return list_segments(self.root)

    def _recover_tail(self):
        """Find the last LSN by scanning the tail segment, truncating a
        torn final record (crash mid-append) at the last valid frame."""
        segs = self._segments()
        last_lsn = 0
        if segs:
            first_lsn, path = segs[-1]
            last_lsn = first_lsn - 1
            good_end, torn = _scan_segment(path, on_record=lambda rec: None)
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
            if good_end < size:
                with open(path, "r+b") as f:
                    f.truncate(good_end)
                self.torn_tail_records += torn
            # last valid lsn in the tail segment
            def note(rec):
                nonlocal last_lsn
                last_lsn = rec[0]
            _scan_segment(path, on_record=note)
        self._next_lsn = last_lsn + 1
        self._appended_lsn = last_lsn
        self._synced_lsn = last_lsn
        self._open_segment(self._next_lsn)

    def _open_segment(self, first_lsn: int):
        path = os.path.join(self.root, segment_file(first_lsn))
        exists = os.path.exists(path)
        self._fd = open(path, "ab")
        self._seg_start_lsn = first_lsn
        self._seg_path = path
        self._seg_bytes = self._fd.tell()
        if not exists or self._seg_bytes == 0:
            faultfs.write(self._fd, _HEADER.pack(_MAGIC, _SEG_VERSION,
                                                 self._cksum_algo), path)
            self._fd.flush()
            self._seg_bytes = _HEADER.size

    # -- append / group commit --------------------------------------------

    @property
    def next_lsn(self) -> int:
        return self._next_lsn

    @property
    def last_lsn(self) -> int:
        return self._appended_lsn

    @property
    def durable_lsn(self) -> int:
        """Highest LSN known to be fsynced (== last_lsn under the
        ``always`` policy once append returns)."""
        return self._synced_lsn

    @property
    def poisoned(self) -> bool:
        return self._poisoned is not None

    @property
    def poison_cause(self) -> OSError | None:
        return self._poisoned

    def _poison(self, cause: OSError):
        """Mark the log permanently unusable for writes and raise the
        typed refusal. Idempotent; wakes blocked group-committers so
        they observe the poison instead of retrying the fsync."""
        with self._sync_cond:
            if self._poisoned is None:
                self._poisoned = cause
                self.registry.counter("wal.poisoned")
            self._sync_cond.notify_all()
        raise DurabilityError(
            f"write-ahead log poisoned: {cause}") from cause

    def _raise_if_poisoned(self):
        if self._poisoned is not None:
            raise DurabilityError(
                f"write-ahead log poisoned: {self._poisoned}")

    def append(self, kind: int, payload: bytes) -> int:
        """Frame and write one record; returns its LSN after the fsync
        policy is satisfied. A storage failure along the way (frame
        write, rotation, fsync) poisons the log: the tail position is
        no longer trustworthy, so every later append raises
        ``DurabilityError`` rather than risk stranding valid frames
        behind a torn one."""
        if self._closed:
            raise ValueError("log is closed")
        self._raise_if_poisoned()
        err: OSError | None = None
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            rest = struct.pack("<IQB", len(payload), lsn, kind)
            crc = self._cksum(rest + payload)
            frame = struct.pack("<I", crc) + rest + payload
            try:
                if (self._seg_bytes + len(frame) > self.segment_bytes
                        and self._seg_bytes > _HEADER.size):
                    self._rotate(lsn)
                faultfs.write(self._fd, frame, self._seg_path)
                self._fd.flush()  # to the OS; fsync is the policy's call
                self._seg_bytes += len(frame)
                self._appended_lsn = lsn
            except OSError as e:
                err = e
        if err is not None:
            self._poison(err)
        reg = self.registry
        reg.counter("wal.appended.records")
        reg.counter("wal.appended.bytes", len(frame))
        if self.fsync_policy == "always":
            self._commit(lsn)
        return lsn

    def _rotate(self, first_lsn: int):
        """Seal the current segment (fsync so earlier records stay
        durable regardless of policy timing) and start the next."""
        self._fd.flush()
        faultfs.fsync(self._fd.fileno(), self._seg_path)
        self._fd.close()
        self._open_segment(first_lsn)
        self.registry.counter("wal.segments.rotated")

    def _commit(self, lsn: int):
        """Group commit: one fsync covers every record appended so far;
        concurrent committers wait for the in-flight sync and return
        without a second fsync when it already covered their LSN. A
        failed fsync poisons the log — the kernel may have dropped the
        dirty pages, so neither this committer nor a waiter may retry
        (fsyncgate)."""
        with self._sync_cond:
            while self._sync_in_progress and self._synced_lsn < lsn:
                self._sync_cond.wait()
            self._raise_if_poisoned()
            if self._synced_lsn >= lsn:
                return
            self._sync_in_progress = True
        pending: int | None = None
        err: OSError | None = None
        t0 = time.perf_counter()
        try:
            from ..obs import tracer
            from ..obs.prof import watchdog
            cur = tracer.current()
            with self._lock, \
                    watchdog.watch("wal.fsync",
                                   span=cur[1] if cur else None):
                fd, path = self._fd, self._seg_path
                fd.flush()
                faultfs.fsync(fd.fileno(), path)
                pending = self._appended_lsn
        except OSError as e:
            err = e
        finally:
            with self._sync_cond:
                batch = 0
                if pending is not None:
                    batch = pending - self._synced_lsn
                    self._synced_lsn = max(self._synced_lsn, pending)
                self._sync_in_progress = False
                self._sync_cond.notify_all()
        if err is not None:
            self._poison(err)
        self.registry.counter("wal.fsyncs")
        dt = time.perf_counter() - t0
        self.registry.observe("wal.fsync", dt)
        from ..obs import annotate
        annotate("wal.fsync", lsn=lsn, batch=batch, ms=round(dt * 1000, 3))
        if batch > 0:
            self.registry.gauge("wal.group_commit.batch", batch)

    def sync(self):
        """Force-fsync everything appended so far (any policy)."""
        self._raise_if_poisoned()
        if self._appended_lsn > self._synced_lsn:
            self._commit(self._appended_lsn)

    def _flush_loop(self):
        while not self._flusher_stop.wait(self.interval_ms / 1e3):
            try:
                self.sync()
            except (OSError, ValueError):
                return  # closed under us

    # -- read / replay -----------------------------------------------------

    def records(self, from_lsn: int = 1, on_torn=None):
        """Yield (lsn, kind, payload) for every valid record with
        ``lsn >= from_lsn``, in LSN order. Iteration ends ENTIRELY at
        the first invalid frame — in the tail segment that is the
        normal crash residue, but mid-history it means silent
        corruption, and continuing into later segments would replay
        across a hole (records applied out of prefix order; deletes or
        overwrites before the hole replayed, their predecessors lost).
        ``on_torn(path, frames)`` fires when iteration stops early so
        recovery can report exactly where.

        Segments wholly below ``from_lsn`` are skipped without being
        opened — segment file names carry their first LSN, so a segment
        whose successor starts at or below ``from_lsn`` cannot contain
        anything to yield. Replication shippers tail this call in a
        loop from an advancing cursor; without the skip every tail
        iteration would rescan the whole log."""
        segs = self._segments()
        for i, (first_lsn, path) in enumerate(segs):
            nxt = segs[i + 1][0] if i + 1 < len(segs) else None
            if nxt is not None and nxt <= from_lsn:
                continue  # every record in [first_lsn, nxt) < from_lsn
            out: list = []
            try:
                _good_end, torn = _scan_segment(path, on_record=out.append,
                                                min_lsn=from_lsn)
            except FileNotFoundError:
                # checkpoint truncation unlinked it between the listing
                # and the open: it was wholly below the checkpoint LSN,
                # so a reader positioned at/above the checkpoint loses
                # nothing by skipping it
                continue
            for rec in out:
                yield rec
            if torn:
                self.registry.counter("wal.replay.stopped")
                if on_torn is not None:
                    on_torn(path, torn)
                return

    def scan_stats(self) -> dict:
        """Inspection summary over the whole log (CLI surface)."""
        segs = []
        counts: dict[str, int] = {}
        total_bytes = 0
        last_checkpoint = None
        for first_lsn, path in self._segments():
            n = 0
            lo = hi = None

            def note(rec):
                nonlocal n, lo, hi, last_checkpoint
                lsn, kind, payload = rec
                n += 1
                lo = lsn if lo is None else lo
                hi = lsn
                counts[KIND_NAMES.get(kind, str(kind))] = \
                    counts.get(KIND_NAMES.get(kind, str(kind)), 0) + 1
                if kind == CHECKPOINT_MARK:
                    try:
                        last_checkpoint = json.loads(payload.decode())
                    except (ValueError, UnicodeDecodeError):
                        pass
            good_end, _ = _scan_segment(path, on_record=note)
            size = os.path.getsize(path)
            total_bytes += size
            segs.append({"file": os.path.basename(path),
                         "first_lsn": first_lsn, "records": n,
                         "lsn_range": [lo, hi], "bytes": size,
                         "valid_bytes": good_end})
        return {"segments": segs, "records_by_kind": counts,
                "bytes": total_bytes, "last_lsn": self.last_lsn,
                "durable_lsn": self.durable_lsn,
                "torn_tail_records": self.torn_tail_records,
                "last_checkpoint": last_checkpoint,
                "checksum": ("crc32c" if self._cksum_algo == _CKSUM_CRC32C
                             else "crc32"),
                "fsync_policy": self.fsync_policy}

    # -- retention ---------------------------------------------------------

    def truncate_below(self, lsn: int) -> int:
        """Unlink segments whose every record is below ``lsn`` (the
        last durable checkpoint). The segment containing ``lsn`` and
        everything after it stay. Returns segments dropped."""
        dropped = 0
        with self._lock:
            segs = self._segments()
            for i, (first, path) in enumerate(segs):
                nxt = segs[i + 1][0] if i + 1 < len(segs) else None
                # a segment is wholly below lsn iff the next segment
                # starts at or below it (its records end at nxt-1);
                # never drop the active tail segment
                if nxt is None or nxt > lsn:
                    break
                os.unlink(path)
                dropped += 1
        if dropped:
            self.registry.counter("wal.segments.dropped", dropped)
            fsync_dir(self.root)
        return dropped

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._flusher_stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        try:
            if self.fsync_policy != "never" and self._poisoned is None:
                self.sync()
        finally:
            with self._lock:
                if self._fd is not None:
                    self._fd.close()
                    self._fd = None

    def abort(self):
        """Drop the log handle without flushing or syncing — the
        simulated-crash close. The crash harness uses this so an
        injected failure's aftermath reaches the next open exactly as
        the disk holds it; also the right disposal for a poisoned log,
        where a clean close would imply durability it can't promise."""
        self._closed = True
        self._flusher_stop.set()
        with self._lock:
            if self._fd is not None:
                try:
                    self._fd.close()
                except OSError:
                    pass
                self._fd = None


def _scan_segment(path: str, on_record, min_lsn: int = 0):
    """Scan one segment file, invoking ``on_record((lsn, kind,
    payload))`` for each valid frame with lsn >= min_lsn. Returns
    (offset of the end of the last valid frame, frames dropped after
    it). Stops at the first invalid frame."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size:
        return 0, (1 if raw else 0)
    magic, version, algo = _HEADER.unpack_from(raw, 0)
    if magic != _MAGIC or version != _SEG_VERSION:
        raise ValueError(f"not a WAL segment: {path}")
    cksum = _checksum_for(algo)
    off = _HEADER.size
    good_end = off
    torn = 0
    n = len(raw)
    while off < n:
        if off + _FRAME.size > n:
            torn += 1
            break
        crc, length, lsn, kind = _FRAME.unpack_from(raw, off)
        end = off + _FRAME.size + length
        if end > n:
            torn += 1
            break
        body = raw[off + 4:end]
        if cksum(body) != crc:
            torn += 1
            break
        if lsn >= min_lsn:
            on_record((lsn, kind, raw[off + _FRAME.size:end]))
        off = end
        good_end = off
    return good_end, torn

