"""Injectable fault disk: the storage tier's chaos proxy.

This module is the disk's adversary for the durability stack (the
write-ahead log, its checkpoints and the atomic file writes of
``store/filebus.py``). Production code routes its storage-side
writes and fsyncs through the two module functions below (``write`` /
``fsync``) — zero-cost pass-throughs until a ``FaultDisk`` is
installed, at which point chosen operations fail the way real disks
fail (Pillai et al., OSDI '14; Rebello et al., ATC '20):

- ``eio`` / ``enospc``  — the syscall raises (I/O error, disk full);
- ``fsync``             — fsync raises EIO *without* syncing: the page
  cache state is unknowable afterwards (fsyncgate), which is why the
  WAL poisons itself rather than retrying;
- ``torn``              — only a prefix of the buffer reaches the file,
  then ``CrashPoint`` unwinds the caller like a power cut mid-write;
- ``bitflip``           — one bit of the buffer inverts and the write
  *succeeds silently* (firmware/cable corruption; only end-to-end
  checksums catch it).

Faults are matched by operation + path substring and are one-shot by
default (``count=1``), with ``skip=N`` to arm on the (N+1)-th matching
call — the randomized kill-point knob the crash-consistency harness
turns. ``flip_bit`` corrupts a file already at rest (bit rot), for
scrubber and recovery tests.

Install is process-global but explicitly scoped::

    disk = FaultDisk()
    disk.add("fsync", match="log", kind="fsync")   # one-shot
    with disk:
        ...workload...
    assert disk.injected  # [(op, path, kind), ...]
"""

from __future__ import annotations

import errno
import os
import threading

from ..metrics import metrics

__all__ = ["FaultDisk", "Fault", "CrashPoint", "install", "uninstall",
           "active", "write", "fsync", "flip_bit"]

_KINDS = ("eio", "enospc", "torn", "bitflip", "fsync")


class CrashPoint(OSError):
    """A torn write's unwind: the simulated machine lost power with
    only a prefix of the buffer on disk. Harnesses catch it and treat
    the store as dead (reopen, never close cleanly)."""


class Fault:
    """One armed fault: fires on matching (op, path) calls."""

    __slots__ = ("op", "match", "kind", "count", "skip")

    def __init__(self, op: str, match: str = "", kind: str = "eio",
                 count: int = 1, skip: int = 0):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if op not in ("write", "fsync"):
            raise ValueError(f"unknown fault op {op!r}")
        self.op = op
        self.match = match
        self.kind = kind
        self.count = int(count)   # firings left (<=0 = spent)
        self.skip = int(skip)     # matching calls to let through first

    def __repr__(self):
        return (f"Fault({self.op!r}, match={self.match!r}, "
                f"kind={self.kind!r}, count={self.count}, "
                f"skip={self.skip})")


class FaultDisk:
    """A programmable plan of storage faults; a context manager that
    installs itself as the process's active injector."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: list[Fault] = []
        self.injected: list[tuple[str, str, str]] = []

    def add(self, op: str, match: str = "", kind: str = "eio",
            count: int = 1, skip: int = 0) -> "FaultDisk":
        with self._lock:
            self._faults.append(Fault(op, match, kind, count, skip))
        return self

    def _take(self, op: str, path: str) -> Fault | None:
        with self._lock:
            for f in self._faults:
                if f.op != op or f.count <= 0 or f.match not in path:
                    continue
                if f.skip > 0:
                    f.skip -= 1
                    continue
                f.count -= 1
                self.injected.append((op, path, f.kind))
                return f
        return None

    def pending(self) -> int:
        """Armed (unfired) faults left in the plan."""
        with self._lock:
            return sum(1 for f in self._faults if f.count > 0)

    def __enter__(self) -> "FaultDisk":
        install(self)
        return self

    def __exit__(self, *exc):
        uninstall(self)


_active: FaultDisk | None = None


def install(disk: FaultDisk):
    global _active
    _active = disk


def uninstall(disk: FaultDisk | None = None):
    global _active
    if disk is None or _active is disk:
        _active = None


def active() -> FaultDisk | None:
    return _active


def _flip(data: bytes) -> bytes:
    """One inverted bit mid-buffer: past any header, inside payload."""
    buf = bytearray(data)
    buf[len(buf) // 2] ^= 0x01
    return bytes(buf)


def write(f, data: bytes, path: str):
    """Write ``data`` to the open file object ``f`` whose destination
    is ``path`` (the logical target, not a tmp name), applying any
    armed write fault."""
    disk = _active
    if disk is None:
        f.write(data)
        return
    fault = disk._take("write", path)
    if fault is None:
        f.write(data)
        return
    metrics.counter("integrity.faults.injected")
    if fault.kind == "eio":
        raise OSError(errno.EIO, f"injected I/O error: {path}")
    if fault.kind == "enospc":
        raise OSError(errno.ENOSPC, f"injected disk full: {path}")
    if fault.kind == "torn":
        f.write(data[:max(len(data) // 2, 1)])
        f.flush()
        raise CrashPoint(errno.EIO, f"injected torn write: {path}")
    if fault.kind == "bitflip":
        f.write(_flip(data))  # succeeds silently — checksums must catch
        return
    raise OSError(errno.EIO, f"injected {fault.kind}: {path}")


def fsync(fd: int, path: str = ""):
    """fsync ``fd`` (whose file is ``path``), applying any armed fsync
    fault. An injected failure raises WITHOUT syncing — afterwards the
    kernel may have dropped the dirty pages (fsyncgate), so callers
    must treat the data as possibly lost."""
    disk = _active
    if disk is not None and disk._take("fsync", path) is not None:
        metrics.counter("integrity.faults.injected")
        raise OSError(errno.EIO, f"injected fsync failure: {path}")
    os.fsync(fd)


def flip_bit(path: str, offset: int | None = None):
    """Corrupt one bit of a file at rest (silent media bit rot). The
    default offset lands mid-file — inside frame payloads / column
    bytes, past headers."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a bit in empty file {path}")
    off = size // 2 if offset is None else int(offset)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x01]))
