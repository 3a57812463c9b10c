"""Fault-injecting TCP proxy: the network you actually deploy on.

Sits between a client and an upstream (a socket broker, a server) and
injects the faults the resilience layer claims to survive, so a test
proves recovery END TO END over real sockets rather than monkeypatched
stubs:

    broker = SocketBroker().start()
    proxy = ChaosProxy(broker.host, broker.port, reset_rate=0.01,
                       jitter_s=0.010, seed=7).start()
    bus = SocketBus(proxy.host, proxy.port)   # faults in the path

Faults (all runtime-mutable attributes):

- ``reset_rate``: probability a connection is killed with a hard RST
  (SO_LINGER 0) after a random number of forwarded bytes — covers
  connect-phase, mid-request and mid-response cuts;
- ``delay_s`` + ``jitter_s``: fixed + uniform-random added latency per
  forwarded chunk (WAN jitter);
- ``partial_write_rate``: probability a chunk is truncated mid-write
  and the connection reset (torn frame on the wire);
- ``bandwidth_bytes_s``: crude rate limit (sleep per chunk);
- ``slow_rate`` + ``slow_s``: probability a CONNECTION is a straggler —
  its first response chunk stalls ``slow_s`` before delivery. This is
  the tail-at-scale profile hedged requests exist for: most calls are
  fast, a random few hit a slow endpoint (GC pause, contended replica),
  and only a speculative second attempt rescues the p99;
- ``blackhole``: accept, read, forward NOTHING (client sees a silent
  peer and must rely on its own timeout);
- ``drop_all()``: cut every live connection at once (partition /
  upstream crash), independent of the probabilistic faults.

Deterministic under ``seed``; ``stats`` counts connections and each
injected fault kind.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time

__all__ = ["ChaosProxy"]

_CHUNK = 65536


def _hard_reset(sock):
    """Close with RST (not FIN): the peer sees ECONNRESET."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 reset_rate: float = 0.0, delay_s: float = 0.0,
                 jitter_s: float = 0.0, partial_write_rate: float = 0.0,
                 bandwidth_bytes_s: float | None = None,
                 blackhole: bool = False, seed: int | None = None,
                 slow_rate: float = 0.0, slow_s: float = 0.0):
        self.upstream = (upstream_host, upstream_port)
        self.reset_rate = reset_rate
        self.delay_s = delay_s
        self.jitter_s = jitter_s
        self.partial_write_rate = partial_write_rate
        self.bandwidth_bytes_s = bandwidth_bytes_s
        self.blackhole = blackhole
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.stats = {"connections": 0, "resets": 0, "partial_writes": 0,
                      "delayed_chunks": 0, "blackholed": 0, "dropped": 0,
                      "slowed": 0}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._live: set[socket.socket] = set()
        self._live_lock = threading.Lock()
        self._running = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)

    def _rand(self) -> float:
        with self._rng_lock:
            return self._rng.random()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ChaosProxy":
        self._running = True
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass
        self.drop_all()

    def drop_all(self):
        """Hard-reset every live connection (simulated partition)."""
        with self._live_lock:
            socks, self._live = list(self._live), set()
        for s in socks:
            self.stats["dropped"] += 1
            _hard_reset(s)

    # -- data path ---------------------------------------------------------

    def _accept_loop(self):
        while self._running:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            self.stats["connections"] += 1
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True).start()

    def _serve(self, client: socket.socket):
        if self.blackhole:
            # hold the connection, consume and discard: the client
            # must save itself with its own timeout
            self.stats["blackholed"] += 1
            self._track(client)
            try:
                while client.recv(_CHUNK):
                    pass
            except OSError:
                pass
            finally:
                self._untrack(client)
            return
        try:
            up = socket.create_connection(self.upstream, timeout=10.0)
        except OSError:
            _hard_reset(client)
            return
        # per-connection reset point: a byte count the combined
        # traffic crosses (uniform in a small window so cuts land in
        # connects, requests and responses alike)
        reset_after = None
        if self.reset_rate > 0 and self._rand() < self.reset_rate:
            reset_after = int(self._rand() * 4096)
        # straggler profile: decided per CONNECTION so a hedged second
        # attempt (a fresh connection) rolls the dice again — mostly
        # landing on a fast path, which is the whole bet of hedging
        slow = 0.0
        if self.slow_rate > 0 and self._rand() < self.slow_rate:
            slow = self.slow_s
            self.stats["slowed"] += 1
        ctl = {"forwarded": 0, "reset_after": reset_after,
               "done": threading.Event()}
        self._track(client)
        self._track(up)
        t1 = threading.Thread(target=self._pump, args=(client, up, ctl),
                              daemon=True)
        t2 = threading.Thread(target=self._pump, args=(up, client, ctl),
                              kwargs={"stall_s": slow}, daemon=True)
        t1.start()
        t2.start()
        ctl["done"].wait()
        for s in (client, up):
            self._untrack(s)
            try:
                s.close()
            except OSError:
                pass

    def _pump(self, src: socket.socket, dst: socket.socket, ctl: dict,
              stall_s: float = 0.0):
        try:
            while True:
                try:
                    data = src.recv(_CHUNK)
                except OSError:
                    break
                if not data:
                    break
                if stall_s > 0:
                    # straggler: one stall before the first response
                    # chunk (total added latency = stall_s, however
                    # many chunks follow)
                    time.sleep(stall_s)
                    stall_s = 0.0
                if self.delay_s or self.jitter_s:
                    self.stats["delayed_chunks"] += 1
                    time.sleep(self.delay_s + self._rand() * self.jitter_s)
                if self.bandwidth_bytes_s:
                    time.sleep(len(data) / self.bandwidth_bytes_s)
                if self.partial_write_rate > 0 \
                        and self._rand() < self.partial_write_rate \
                        and len(data) > 1:
                    self.stats["partial_writes"] += 1
                    try:
                        dst.sendall(data[:len(data) // 2])
                    except OSError:
                        pass
                    self._reset_pair(src, dst)
                    break
                try:
                    dst.sendall(data)
                except OSError:
                    break
                ctl["forwarded"] += len(data)
                ra = ctl["reset_after"]
                if ra is not None and ctl["forwarded"] >= ra:
                    self._reset_pair(src, dst)
                    break
        finally:
            ctl["done"].set()

    def _reset_pair(self, a: socket.socket, b: socket.socket):
        self.stats["resets"] += 1
        for s in (a, b):
            self._untrack(s)
            _hard_reset(s)

    def _track(self, s: socket.socket):
        with self._live_lock:
            self._live.add(s)

    def _untrack(self, s: socket.socket):
        with self._live_lock:
            self._live.discard(s)
