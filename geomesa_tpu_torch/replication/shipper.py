"""Primary-side WAL shipper: stream log records to replicas over TCP.

One ``WalShipper`` embeds in the primary process next to its
``Journal``. Replicas connect and speak a tiny length-prefixed frame
protocol (the SocketBus framing — JSON header + raw payload):

- ``{"op": "hello"}`` -> the primary's log coordinates
  (``last_lsn`` / ``durable_lsn`` / ``oldest_lsn`` /
  ``checkpoint_lsn``), so the replica can decide between streaming
  catch-up and checkpoint bootstrap;
- ``{"op": "manifest"}`` -> the newest checkpoint's MANIFEST.json
  content (``{"lsn": 0}`` when none exists);
- ``{"op": "fetch_ckpt", "lsn": L, "file": name}`` -> that checkpoint
  file's bytes as the frame payload (pinned by LSN so a concurrent
  newer checkpoint + retention pass can't swap files mid-bootstrap);
- ``{"op": "stream", "from_lsn": N}`` -> the connection turns into a
  one-way record feed: ``{"lsn", "kind", "last_lsn", "durable_lsn"}``
  headers with the raw WAL payload, heartbeat frames
  (``{"heartbeat": true, ...}``) every poll tick while idle, or a
  terminal ``{"error": "compacted", ...}`` when ``from_lsn`` has been
  truncated away (the replica must re-bootstrap).

The shipper tails the live ``WriteAheadLog`` via ``records(from_lsn)``
— segment skipping makes each tail iteration O(segments past the
cursor) — and only rescans when ``last_lsn`` has actually advanced.
Records are shipped as written, durable or not; the ACK boundary
(which writes survive failover) is enforced by the router, which
compares a write's durable LSN against replica applied LSNs.
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
import time

from ..metrics import metrics
from ..store.socketbus import ProtocolError, _recv_frame, _send_frame
from ..utils.device import cuda_index, device_scope
from ..utils.properties import SystemProperty
from ..wal.log import list_segments
from ..wal.snapshot import checkpoint_dirs

__all__ = ["WalShipper", "REPL_POLL_MS"]

# how often a streaming connection polls the WAL for new records (also
# the heartbeat cadence while idle)
REPL_POLL_MS = SystemProperty("geomesa.repl.poll.ms", "20")


class WalShipper:
    """TCP server that ships a ``Journal``'s WAL to replicas.

    ``journal`` is the primary store's journal (``store.journal``);
    the shipper reads its WAL and serves checkpoint files from the same
    durable root. Start is implicit in construction; ``stop()`` closes
    the listener and every streaming connection.
    """

    def __init__(self, journal, host: str = "127.0.0.1", port: int = 0,
                 poll_ms: float | None = None, store=None,
                 registry=metrics):
        self.journal = journal
        self.wal = journal.wal
        self.root = journal.root
        # optional: the primary store itself, enabling the ``digest``
        # anti-entropy op (per-type row-count + content digest)
        self.store = store
        self._cuda = cuda_index(store)
        self.poll_s = ((REPL_POLL_MS.as_float() or 20.0)
                       if poll_ms is None else float(poll_ms)) / 1e3
        self._registry = registry
        self._stopped = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()

        shipper = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with shipper._conns_lock:
                    shipper._conns.add(self.request)
                shipper._registry.counter("replication.ship.connections")
                try:
                    self.request.settimeout(30.0)
                    with device_scope(shipper._cuda):
                        shipper._serve(self.request)
                except (ConnectionError, TimeoutError, OSError,
                        ProtocolError, json.JSONDecodeError):
                    pass  # peer gone or garbage: drop the connection
                finally:
                    with shipper._conns_lock:
                        shipper._conns.discard(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name=f"wal-shipper:{self.port}", daemon=True)
        self._thread.start()

    # -- per-connection protocol -------------------------------------------

    def _serve(self, sock):
        while not self._stopped.is_set():
            header, _payload = _recv_frame(sock)
            op = header.get("op")
            if op == "hello":
                _send_frame(sock, self._coords())
            elif op == "manifest":
                _send_frame(sock, self._manifest())
            elif op == "fetch_ckpt":
                self._fetch_ckpt(sock, header)
            elif op == "digest":
                _send_frame(sock, self._digest())
            elif op == "stream":
                self._stream(sock, int(header.get("from_lsn", 1)))
                return  # streaming is terminal for the connection
            else:
                _send_frame(sock, {"error": f"unknown op {op!r}"})
                return

    def _coords(self) -> dict:
        segs = list_segments(self.wal.root)
        oldest = segs[0][0] if segs else self.wal.next_lsn
        ckpts = checkpoint_dirs(self.root)
        return {"last_lsn": self.wal.last_lsn,
                "durable_lsn": self.wal.durable_lsn,
                "oldest_lsn": oldest,
                "checkpoint_lsn": ckpts[-1][0] if ckpts else 0}

    def _manifest(self) -> dict:
        ckpts = checkpoint_dirs(self.root)
        if not ckpts:
            return {"lsn": 0, "types": []}
        _lsn, path = ckpts[-1]
        with open(os.path.join(path, "MANIFEST.json")) as f:
            return json.load(f)

    def _digest(self) -> dict:
        """Anti-entropy unit: per-type ``{rows, digest}`` bracketed by
        the WAL position before and after the computation. Only when
        the two LSNs agree (no concurrent writes) AND match the
        replica's applied LSN is the comparison meaningful — the
        replica-side scrubber enforces that."""
        if self.store is None:
            return {"error": "digest unavailable (shipper has no store)"}
        from ..integrity.verify import ids_digest
        pre = self.wal.last_lsn
        types = {}
        for name in self.store.get_type_names():
            rows, digest = ids_digest(self.store, name)
            types[name] = {"rows": rows, "digest": digest}
        return {"last_lsn_pre": pre, "last_lsn": self.wal.last_lsn,
                "types": types}

    def _fetch_ckpt(self, sock, header: dict):
        lsn = int(header.get("lsn", 0))
        name = os.path.basename(str(header.get("file", "")))
        path = os.path.join(self.root, "snapshots", f"ckpt-{lsn:020d}", name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            # retention dropped this checkpoint mid-bootstrap: tell the
            # replica to restart from the (newer) manifest
            _send_frame(sock, {"error": "gone", "lsn": lsn, "file": name})
            return
        _send_frame(sock, {"bytes": len(raw)}, raw)

    def _stream(self, sock, from_lsn: int):
        segs = list_segments(self.wal.root)
        oldest = segs[0][0] if segs else self.wal.next_lsn
        if from_lsn < oldest:
            # records below `oldest` were checkpoint-truncated: the
            # replica's cursor points into compacted history
            ckpts = checkpoint_dirs(self.root)
            _send_frame(sock, {"error": "compacted", "oldest_lsn": oldest,
                               "checkpoint_lsn": ckpts[-1][0] if ckpts else 0})
            return
        cursor = from_lsn
        while not self._stopped.is_set():
            if self.wal.last_lsn >= cursor:
                for lsn, kind, payload in self.wal.records(cursor):
                    if self._stopped.is_set():
                        return
                    _send_frame(sock,
                                {"lsn": lsn, "kind": kind,
                                 "last_lsn": self.wal.last_lsn,
                                 "durable_lsn": self.wal.durable_lsn},
                                payload)
                    cursor = lsn + 1
                    self._registry.counter("replication.shipped.records")
                    self._registry.counter("replication.shipped.bytes",
                                           len(payload))
                continue  # re-check before sleeping: more may have landed
            _send_frame(sock, {"heartbeat": True,
                               "last_lsn": self.wal.last_lsn,
                               "durable_lsn": self.wal.durable_lsn})
            if self._stopped.wait(self.poll_s):
                return

    # -- lifecycle / admin --------------------------------------------------

    def status(self) -> dict:
        with self._conns_lock:
            n = len(self._conns)
        return {"role": "primary", "address": f"{self.host}:{self.port}",
                "connections": n, **self._coords()}

    def stop(self):
        self._stopped.set()
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=5.0)
