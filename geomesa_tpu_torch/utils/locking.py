"""Distributed-style locking for schema mutations.

Analog of DistributedLocking / ZookeeperLocking (geomesa-index-api/
.../utils/DistributedLocking.scala:14, geomesa-zk-utils) — the
reference guards schema create/delete with ZK locks; here the two
deployment shapes are in-process (LocalLock) and cross-process via
kernel-arbitrated flock(2) lock files (FileLock) — like ZK ephemeral
nodes, the kernel releases the lock when the holder dies, so no
stale-lock heuristics (and none of their TOCTOU races) are needed."""

from __future__ import annotations

import contextlib
import fcntl
import os
import threading
import time

__all__ = ["LocalLock", "FileLock", "with_lock"]


class LocalLock:
    """Named in-process locks (LocalLocking analog)."""

    _locks: dict[str, threading.RLock] = {}
    _guard = threading.Lock()

    def __init__(self, key: str):
        with LocalLock._guard:
            self._lock = LocalLock._locks.setdefault(key, threading.RLock())

    def acquire(self, timeout_s: float = 60.0) -> bool:
        return self._lock.acquire(timeout=timeout_s)

    def release(self):
        self._lock.release()


class FileLock:
    """Cross-process lock via flock(2) on a lock file. The kernel owns
    the lock state: a crashed holder's lock is released automatically
    (the ZK ephemeral-node analog), so there is no staleness window and
    no lock-breaking race. The file itself is never deleted.

    `stale_s` is accepted for API compatibility but unused — crash
    recovery is immediate under flock.
    """

    def __init__(self, path: str, stale_s: float = 300.0):
        self.path = path
        self.stale_s = stale_s
        self._fd: int | None = None

    def acquire(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        fd = os.open(self.path, os.O_CREAT | os.O_WRONLY, 0o644)
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                os.truncate(fd, 0)
                os.write(fd, f"{os.getpid()} {time.time()}".encode())
                self._fd = fd
                return True
            except OSError:
                if time.monotonic() >= deadline:
                    os.close(fd)
                    return False
                time.sleep(0.02)

    def release(self):
        if self._fd is not None:
            fd, self._fd = self._fd, None
            with contextlib.suppress(OSError):
                fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


@contextlib.contextmanager
def with_lock(lock, timeout_s: float = 60.0):
    if not lock.acquire(timeout_s):
        raise TimeoutError(f"could not acquire lock within {timeout_s}s")
    try:
        yield
    finally:
        lock.release()
