"""Replica-side sync client: negotiate, bootstrap, stream.

``ReplClient`` is a thin connection to a ``WalShipper``: request/
response ops (``hello`` / ``manifest`` / ``fetch_ckpt``) and the
terminal ``stream`` op that turns the connection into a record feed.

``bootstrap_from_checkpoint`` is the replica's fast-forward path — the
streaming analog of open-time recovery: fetch the primary's newest
checkpoint manifest and per-type files over the wire, load them into
the replica store, and return the checkpoint LSN so streaming resumes
at ``lsn + 1``. A new replica therefore costs O(current state), not
O(log history), and a replica whose cursor fell behind checkpoint
truncation can rejoin instead of being stuck.
"""

from __future__ import annotations

import socket

from ..metrics import metrics
from ..store.socketbus import _recv_frame, _send_frame
from ..wal.log import decode_write
from ..wal.recovery import _ensure_schema

__all__ = ["ReplClient", "BootstrapError", "bootstrap_from_checkpoint"]


class BootstrapError(ConnectionError):
    """Checkpoint bootstrap failed mid-way (file withdrawn by retention,
    malformed manifest). Retryable: the next attempt sees the newer
    checkpoint."""

    retryable = True


class ReplClient:
    """One TCP connection to a ``WalShipper``."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)

    def _rpc(self, header: dict):
        _send_frame(self._sock, header)
        return _recv_frame(self._sock)

    def hello(self) -> dict:
        h, _ = self._rpc({"op": "hello"})
        return h

    def manifest(self) -> dict:
        h, _ = self._rpc({"op": "manifest"})
        return h

    def fetch_ckpt(self, lsn: int, file: str) -> bytes:
        h, payload = self._rpc({"op": "fetch_ckpt", "lsn": lsn,
                                "file": file})
        if h.get("error"):
            raise BootstrapError(f"checkpoint file {file!r}@{lsn}: "
                                 f"{h['error']}")
        return payload

    def digest(self) -> dict:
        """Primary-side per-type ``{rows, digest}`` plus the bracketing
        ``last_lsn_pre``/``last_lsn`` — the anti-entropy comparison
        unit (valid only when the two LSNs agree)."""
        h, _ = self._rpc({"op": "digest"})
        return h

    def stream(self, from_lsn: int):
        """Yield ``(header, payload)`` frames until the peer drops the
        connection. Headers are records, heartbeats, or a terminal
        ``{"error": "compacted"}``."""
        _send_frame(self._sock, {"op": "stream", "from_lsn": from_lsn})
        while True:
            yield _recv_frame(self._sock)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def bootstrap_from_checkpoint(client: ReplClient, store,
                              registry=metrics) -> int:
    """Load the primary's newest checkpoint into ``store`` over
    ``client``. Returns the checkpoint LSN (0 when the primary has no
    checkpoint — stream from 1 instead).

    The caller must hand in an EMPTY store (or one it has cleared): a
    checkpoint is full state, and rows deleted on the primary since the
    replica's stale state would otherwise survive the merge."""
    from ..features.sft import parse_spec
    manifest = client.manifest()
    lsn = int(manifest.get("lsn", 0))
    if not lsn:
        return 0
    rows = 0
    for t in manifest.get("types", []):
        sft = parse_spec(t["name"], t.get("spec") or "")
        _ensure_schema(store, sft)
        if t.get("file"):
            raw = client.fetch_ckpt(lsn, t["file"])
            # end-to-end: the manifest's digest covers the payload all
            # the way from the primary's disk through the socket — a
            # corrupt source file or truncated transfer fails HERE, not
            # as garbage rows on the replica
            want_bytes = t.get("bytes")
            if want_bytes is not None and int(want_bytes) != len(raw):
                registry.counter("integrity.bootstrap.rejects")
                raise BootstrapError(
                    f"checkpoint file {t['file']!r}@{lsn}: got "
                    f"{len(raw)} bytes, manifest says {want_bytes}")
            want_sha = t.get("sha256")
            if want_sha is not None:
                from ..integrity.verify import sha256_hex
                if sha256_hex(raw) != want_sha:
                    registry.counter("integrity.bootstrap.rejects")
                    raise BootstrapError(
                        f"checkpoint file {t['file']!r}@{lsn}: "
                        f"sha256 mismatch")
            tn, batch, vis = decode_write(raw)
            if batch is not None and batch.n:
                store.write(tn, batch,
                            visibilities=None if vis is None else list(vis))
                rows += int(batch.n)
    registry.counter("replication.bootstraps")
    registry.counter("replication.bootstrap.rows", rows)
    return lsn
