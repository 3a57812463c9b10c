"""Consuming half of a materialized view's delta stream.

Every fold publishes one message on ``view.<name>``: a JSON payload in
the message's ``ids`` header carrying the changed groups' finalized
rows, the removed group keys, the view's LSN and a per-view contiguous
``seq``. ``ViewDeltaSubscriber`` mirrors ``ContinuousQuerySubscriber``:
its own consumer group commits offsets independently, so across a
broker kill/restart (persistent broker ``root=``) delivery is
exactly-once from the last commit — the ``seq`` field lets consumers
assert it.
"""

from __future__ import annotations

import json
from typing import Callable

__all__ = ["ViewDeltaSubscriber", "view_topic"]


def view_topic(name: str) -> str:
    return f"view.{name}"


class ViewDeltaSubscriber:
    def __init__(self, name: str, host: str | None = None,
                 port: int | None = None, group: str = "default",
                 bus=None, timeout_s: float = 30.0):
        self.name = name
        self.topic = view_topic(name)
        if bus is None:
            if host is None or port is None:
                raise ValueError("pass host/port or bus=")
            from ..store.socketbus import SocketBus
            bus = SocketBus(host, port, group=f"view.{name}.{group}",
                            timeout_s=timeout_s)
            self._owns_bus = True
        else:
            self._owns_bus = False
        self.bus = bus
        self._handlers: list[Callable[[dict], None]] = []
        bus.subscribe(self.topic, self._deliver)

    def _deliver(self, msg):
        if not msg.ids:
            return
        delta = json.loads(msg.ids[0])
        for fn in self._handlers:
            fn(delta)

    def on_delta(self, fn: Callable[[dict], None]):
        """fn(delta) per fold; delta = {"view", "lsn", "seq",
        "rows": [{"key", "row"}...], "removed": [key...]}."""
        self._handlers.append(fn)
        return fn

    def poll(self, wait_s: float = 0.0,
             max_messages: int | None = None) -> int:
        poll = getattr(self.bus, "poll", None)
        if poll is None:
            return 0
        return poll(max_messages=max_messages, wait_s=wait_s)

    def offset(self) -> int:
        off = getattr(self.bus, "offset", None)
        return off(self.topic) if callable(off) else 0

    def close(self):
        if self._owns_bus:
            close = getattr(self.bus, "close", None)
            if callable(close):
                close()
