"""TCP message bus: a network transport for the live tier.

The reference's live tier is network pub/sub: feature mutations flow
through Kafka brokers and consumer offsets checkpoint server-side
(kafka/data/KafkaDataStore.scala:44,
lambda/stream/ZookeeperOffsetManager.scala:27). ``FileBus`` reproduces
the log design over a shared filesystem; this module adds a wire
transport, so producers and consumers on different hosts interoperate:

- ``SocketBroker``: the Kafka-cluster analog. Per-topic ordered
  in-memory logs, consumer-group offsets (the Zookeeper role), served
  over a length-prefixed TCP protocol. With ``root=`` it persists
  messages in the FileBus segment layout (same directory structure and
  payload bytes, via filebus's shared atomic-write helpers), so a
  broker restart replays the durable log and a FileBus pointed at the
  same root can read it.
- ``SocketBus``: producer/consumer client with the same
  subscribe/publish/poll surface as FileBus (LiveDataStore plugs in
  unchanged). A single multi-topic fetch supports LONG-POLL
  (``poll(wait_s=...)``): the broker parks it until a publish arrives
  on ANY subscribed topic. Long polls ride a dedicated connection, so a
  same-client publish (the wakeup source) is never serialized behind a
  parked fetch.

Frames, ops and the persisted layout are the JAX package's
(``geomesa_tpu/store/socketbus.py``): a port client talks to a JAX
broker and the other way round, and a root written by either broker is
replayed by the other. Payloads reuse the FileBus GeoMessage encoding
(JSON header + Arrow IPC stream).
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Callable

from ..metrics import metrics
from ..resilience import RetryPolicy
from .filebus import (_SEQ_DIGITS, _decode, _encode, segment_name,
                      write_bytes_atomic, write_json_atomic)
from .live import GeoMessage

__all__ = ["SocketBroker", "SocketBus", "ProtocolError"]

# frame hardening: declared lengths past these caps are garbage or
# hostile input (port scan, HTTP probe) — reject BEFORE allocating,
# not after an unbounded _recv_exact
_MAX_HEADER_BYTES = 1 << 20    # 1 MiB of JSON header
_MAX_PAYLOAD_BYTES = 1 << 28   # 256 MiB frame payload

# how many publish idempotency keys the broker remembers per topic
# (the dedup window for client retries)
_PUB_KEY_WINDOW = 8192


class ProtocolError(ConnectionError):
    """Wire-protocol violation (oversized or truncated frame): the
    stream position is unrecoverable, the connection must be dropped
    and re-established."""


def _send_frame(sock, header: dict, payload: bytes = b""):
    h = json.dumps(header).encode()
    sock.sendall(struct.pack(">II", len(h), len(payload)) + h + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(sock):
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    if hlen > _MAX_HEADER_BYTES or plen > _MAX_PAYLOAD_BYTES:
        raise ProtocolError(
            f"frame lengths {hlen}/{plen} exceed caps "
            f"{_MAX_HEADER_BYTES}/{_MAX_PAYLOAD_BYTES}")
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


class SocketBroker:
    """Append-only per-topic logs + consumer-group offsets behind a
    TCP server. One instance per deployment (the broker role); clients
    connect with SocketBus."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 root: str | None = None):
        self._logs: dict[str, list[bytes]] = {}
        self._group_offsets: dict[str, dict[str, int]] = {}
        # publish idempotency keys -> assigned seq, per topic (bounded
        # window): a client retrying a publish whose ACK was lost gets
        # the original seq back instead of a duplicate log entry
        self._pub_keys: dict[str, OrderedDict[str, int]] = {}
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.root = root
        if root:
            self._load_root()

        broker = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                broker._track(self.request)
                try:
                    while True:
                        try:
                            header, payload = _recv_frame(self.request)
                        except (json.JSONDecodeError, UnicodeDecodeError,
                                ProtocolError):
                            # not our protocol (port scan, garbage,
                            # absurd declared lengths): drop the
                            # connection quietly, allocate nothing
                            return
                        try:
                            broker._handle(self.request, header, payload)
                        except (KeyError, TypeError, ValueError) as e:
                            _send_frame(self.request,
                                        {"error": f"bad request: {e}"})
                except (ConnectionError, OSError, struct.error):
                    pass  # client went away
                finally:
                    broker._untrack(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            # a restarted broker must rebind its old port immediately
            # (crash recovery), not wait out TIME_WAIT
            allow_reuse_address = True

        self._srv = _Server((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def start(self) -> "SocketBroker":
        self._thread.start()
        return self

    def stop(self):
        """Stop serving AND sever live client connections — a stopped
        broker must look like a dead broker (clients see a closed
        peer and run their reconnect path), not a half-alive one
        whose surviving handler threads keep answering."""
        self._srv.shutdown()
        self._srv.server_close()
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _track(self, sock):
        with self._conns_lock:
            self._conns.add(sock)

    def _untrack(self, sock):
        with self._conns_lock:
            self._conns.discard(sock)

    # -- request dispatch --------------------------------------------------

    def _handle(self, sock, header: dict, payload: bytes):
        op = header.get("op")
        if op == "publish":
            topic = header["topic"]
            key = header.get("key")
            with self._cond:
                if key is not None:
                    keys = self._pub_keys.setdefault(topic, OrderedDict())
                    dup = keys.get(key)
                    if dup is not None:
                        # retried publish: already appended (and
                        # persisted) under this key — ack, don't dup
                        metrics.counter("resilience.socketbus.pub_dedup")
                        _send_frame(sock, {"seq": dup, "dup": True})
                        return
                log = self._logs.setdefault(topic, [])
                log.append(payload)
                seq = len(log)
                if key is not None:
                    keys[key] = seq
                    while len(keys) > _PUB_KEY_WINDOW:
                        keys.popitem(last=False)
                self._cond.notify_all()
            if self.root:
                self._persist(topic, seq, payload)
            _send_frame(sock, {"seq": seq})
        elif op == "fetch":
            # one fetch covers every topic the consumer follows; the
            # park wakes on a publish to ANY of them
            offsets = {t: int(v) for t, v in header["topics"].items()}
            maxm = header.get("max")
            wait_s = float(header.get("wait_s", 0) or 0)
            deadline = time.monotonic() + wait_s
            with self._cond:
                while True:
                    ready = {t: self._logs.get(t, [])[off:]
                             for t, off in offsets.items()}
                    ready = {t: m for t, m in ready.items() if m}
                    if ready or wait_s <= 0:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            meta: dict = {}
            chunks: list[bytes] = []
            budget = None if maxm is None else int(maxm)
            for t in sorted(ready):
                msgs = ready[t]
                if budget is not None:
                    msgs = msgs[:budget]
                meta[t] = {"count": len(msgs)}
                chunks.extend(struct.pack(">I", len(m)) + m for m in msgs)
                if budget is not None:
                    budget -= len(msgs)
                    if budget <= 0:
                        break
            _send_frame(sock, {"topics": meta}, b"".join(chunks))
        elif op == "commit":
            group = header["group"]
            with self._lock:
                g = self._group_offsets.setdefault(group, {})
                g.update({k: int(v)
                          for k, v in header["offsets"].items()})
            if self.root:
                self._persist_offsets(group)
            _send_frame(sock, {"ok": True})
        elif op == "offsets":
            with self._lock:
                offs = dict(self._group_offsets.get(header["group"], {}))
            _send_frame(sock, {"offsets": offs})
        else:
            _send_frame(sock, {"error": f"unknown op {op!r}"})

    # -- durable tier (FileBus segment layout, shared helpers) -------------

    def _persist(self, topic: str, seq: int, raw: bytes):
        d = os.path.join(self.root, "topics", topic)
        os.makedirs(d, exist_ok=True)
        write_bytes_atomic(os.path.join(d, segment_name(seq)), raw)

    def _persist_offsets(self, group: str):
        d = os.path.join(self.root, "offsets")
        os.makedirs(d, exist_ok=True)
        with self._lock:
            offs = dict(self._group_offsets.get(group, {}))
        write_json_atomic(os.path.join(d, f"{group}.json"), offs)

    def _load_root(self):
        """Replay the durable log on startup (broker restart = the
        reference's log-backed recovery). Gaps (e.g. a FileBus claim
        skipped as stale) load as empty messages that consumers skip."""
        tdir = os.path.join(self.root, "topics")
        if os.path.isdir(tdir):
            for topic in os.listdir(tdir):
                d = os.path.join(tdir, topic)
                seqs = sorted(int(f[:_SEQ_DIGITS]) for f in os.listdir(d)
                              if f.endswith(".msg"))
                log: list[bytes] = []
                for seq in seqs:
                    while len(log) < seq - 1:
                        log.append(b"")
                    with open(os.path.join(d, segment_name(seq)),
                              "rb") as f:
                        log.append(f.read())
                self._logs[topic] = log
        odir = os.path.join(self.root, "offsets")
        if os.path.isdir(odir):
            for fn in os.listdir(odir):
                if not fn.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(odir, fn)) as f:
                        self._group_offsets[fn[:-5]] = {
                            k: int(v) for k, v in json.load(f).items()}
                except (json.JSONDecodeError, ValueError):
                    continue


class _Channel:
    """One broker connection + its lock (commands and long-polls ride
    separate channels so a parked fetch never blocks a publish).

    ``rpc`` reconnects transparently with backoff under ``policy``: a
    reset connection (or a down broker, within the retry deadline) is
    absorbed here, so callers only see failures that outlived the
    policy. Safe because every broker op is idempotent at the protocol
    level — fetch/offsets are reads against client-held offsets,
    commit sets absolute offsets, and publish carries a dedup key."""

    def __init__(self, host, port, timeout_s, policy=None):
        self.host, self.port, self.timeout_s = host, port, timeout_s
        self.lock = threading.Lock()
        self.sock = None
        self.policy = policy if policy is not None else RetryPolicy()
        self._ever_connected = False

    def _attempt(self, header, payload, timeout_s):
        with self.lock:
            if self.sock is None:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout_s)
                if self._ever_connected:
                    metrics.counter("resilience.socketbus.reconnects")
                self._ever_connected = True
            self.sock.settimeout(timeout_s or self.timeout_s)
            try:
                _send_frame(self.sock, header, payload)
                return _recv_frame(self.sock)
            except (ConnectionError, OSError):
                try:
                    self.sock.close()
                finally:
                    self.sock = None
                raise

    def rpc(self, header: dict, payload: bytes = b"",
            timeout_s: float | None = None):
        return self.policy.call(
            lambda: self._attempt(header, payload, timeout_s),
            name="socketbus")

    def close(self):
        with self.lock:
            if self.sock is not None:
                try:
                    self.sock.close()
                finally:
                    self.sock = None


class SocketBus:
    """Network MessageBus client: FileBus's subscribe/publish/poll
    surface over a broker connection, with server-side consumer-group
    offsets and long-poll wakeups."""

    def __init__(self, host: str, port: int, group: str = "default",
                 timeout_s: float = 30.0,
                 retry_policy: RetryPolicy | None = None):
        self.host = host
        self.port = port
        self.group = group
        self.timeout_s = timeout_s
        self._subs: dict[str, list[Callable[[GeoMessage], None]]] = {}
        self._cmd = _Channel(host, port, timeout_s, policy=retry_policy)
        self._fetch = _Channel(host, port, timeout_s, policy=retry_policy)
        header, _ = self._cmd.rpc({"op": "offsets", "group": group})
        self._offsets: dict[str, int] = {
            k: int(v) for k, v in header.get("offsets", {}).items()}

    def close(self):
        self._cmd.close()
        self._fetch.close()

    # -- offsets -----------------------------------------------------------

    def offset(self, topic: str) -> int:
        return self._offsets.get(topic, 0)

    def set_offset(self, topic: str, offset: int):
        """Manual seek (offset = last consumed sequence number),
        committed to the broker."""
        self._offsets[topic] = int(offset)
        self._commit()

    def _commit(self):
        self._cmd.rpc({"op": "commit", "group": self.group,
                       "offsets": self._offsets})

    # -- producer / consumer -----------------------------------------------

    def publish(self, topic: str, msg: GeoMessage) -> int:
        # the client-assigned idempotency key makes retried publishes
        # (ACK lost to a reset) exactly-once: the broker dedups on it
        header, _ = self._cmd.rpc(
            {"op": "publish", "topic": topic, "key": uuid.uuid4().hex},
            _encode(msg))
        return int(header["seq"])

    def subscribe(self, topic: str, fn: Callable[[GeoMessage], None]):
        self._subs.setdefault(topic, []).append(fn)

    def poll(self, max_messages: int | None = None,
             wait_s: float = 0.0) -> int:
        """Drain new messages on subscribed topics, in sequence order;
        commits offsets to the broker. ``wait_s`` long-polls: when no
        subscribed topic has news, the broker parks the fetch until a
        publish arrives on any of them (wakeup-on-publish). Returns
        messages delivered."""
        topics = {t: self._offsets.get(t, 0) for t in list(self._subs)}
        if not topics:
            return 0
        # the fetch channel reconnects under its retry policy: a
        # broker restart mid-long-poll re-issues this fetch against
        # the new broker, which resumes at our (server-committed)
        # offsets — exactly-once from the last commit
        header, body = self._fetch.rpc(
            {"op": "fetch", "topics": topics, "max": max_messages,
             "wait_s": wait_s},
            timeout_s=self.timeout_s + wait_s)
        delivered = 0
        advanced = False
        error: Exception | None = None
        pos = 0
        try:
            for t, info in header.get("topics", {}).items():
                off = self._offsets.get(t, 0)
                count = int(info.get("count", 0))
                for _ in range(count):
                    if pos + 4 > len(body):
                        self._fetch.close()  # stream position is junk
                        raise ProtocolError(
                            f"truncated fetch body at {pos}/{len(body)}")
                    (mlen,) = struct.unpack(">I", body[pos:pos + 4])
                    if pos + 4 + mlen > len(body):
                        self._fetch.close()
                        raise ProtocolError(
                            f"truncated fetch message ({mlen} declared, "
                            f"{len(body) - pos - 4} available)")
                    raw = body[pos + 4:pos + 4 + mlen]
                    pos += 4 + mlen
                    if raw:
                        msg = _decode(raw)
                        # read the live subscriber list — consumer-side
                        # schema auto-create may append handlers mid-poll
                        for fn in self._subs.get(t, []):
                            fn(msg)
                        delivered += 1
                    # a message advances our offset only once every
                    # handler ran; a raising subscriber leaves it due
                    # for redelivery (at-least-once for that message)
                    off += 1
                    self._offsets[t] = off
                    advanced = True
        except Exception as e:
            error = e
        if advanced:
            # progress made before a failure still commits: a raising
            # subscriber (or torn body) must not force redelivery of
            # the messages that were already fully delivered
            self._commit()
        if error is not None:
            raise error
        return delivered

    def wait_for(self, predicate, timeout_s: float = 10.0,
                 interval_s: float = 0.25) -> bool:
        """Long-poll until predicate() is true or the timeout lapses
        (interval_s bounds each broker park, not a sleep)."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll(wait_s=min(interval_s,
                                 max(deadline - time.monotonic(), 0)))
            if predicate():
                return True
            if time.monotonic() >= deadline:
                return False
