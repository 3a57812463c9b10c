"""Generic streaming sources: raw feeds -> converter -> queryable cache.

The analog of geomesa-stream (stream/generic/
GenericSimpleFeatureStreamSourceFactory.scala:26 and
stream/datastore/StreamDataStore.scala:49): the reference wires an
Apache Camel route (file, netty, ...) through a converter into an
in-memory queryable cache with expiry and listeners. Here the route is a
``StreamSource`` SPI — anything that yields raw records when polled —
and the cache is the live tier on the card:

    source.poll() -> converter.process(...) -> LiveDataStore cache
                                                (ttl expiry, listeners,
                                                 full query surface)

Built-in sources: ``FileTailSource`` (a growing file, the camel `file:`
route analog) and ``IterableSource`` (any generator/queue). New
transports implement ``poll``. ``device=None`` means ``"cuda"``, as for
every entry point of the port.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Iterable

from ..features.sft import SimpleFeatureType, parse_spec
from ..index.api import Query
from .api import DataStore
from .live import LiveDataStore, MessageBus

__all__ = ["StreamSource", "FileTailSource", "IterableSource",
           "StreamDataStore"]


class StreamSource(abc.ABC):
    """SPI: a transport that yields raw records (lines/objects)."""

    @abc.abstractmethod
    def poll(self) -> list[Any]:
        """Records that arrived since the last poll (may be empty)."""


class FileTailSource(StreamSource):
    """Tails a text file: each poll returns complete new lines."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._inode: int | None = None

    def poll(self) -> list[str]:
        try:
            stat = os.stat(self.path)  # one syscall: no exists/size race
        except FileNotFoundError:
            return []  # not created yet / mid-rotation: retry next poll
        if (stat.st_size < self._offset
                or (self._inode is not None
                    and stat.st_ino != self._inode)):
            # truncated in place, or replaced by a new file (rename
            # rotation): restart from the top instead of tailing a
            # stale offset into unrelated bytes
            self._offset = 0
        self._inode = stat.st_ino
        # binary mode: the offset is in BYTES, so multi-byte characters
        # never desynchronize the tail position
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except FileNotFoundError:
            return []  # removed between stat and open (rotation)
        # other OSErrors (EACCES, EISDIR, ...) are real
        # misconfigurations and must surface, not silently no-op
        if not chunk:
            return []
        # hold back a trailing partial line until its newline arrives
        complete = chunk.rfind(b"\n")
        if complete < 0:
            return []
        self._offset += complete + 1
        return [ln.decode("utf-8", "replace")
                for ln in chunk[:complete].split(b"\n") if ln]


class IterableSource(StreamSource):
    """Adapts a python iterable/generator; each poll drains up to
    ``batch`` pending records."""

    def __init__(self, it: Iterable, batch: int = 1024):
        self._it = iter(it)
        self.batch = batch

    def poll(self) -> list[Any]:
        out = []
        for _ in range(self.batch):
            try:
                out.append(next(self._it))
            except StopIteration:
                break
        return out


class StreamDataStore(DataStore):
    """A queryable cache fed by a StreamSource through a converter.

    ``tick()`` advances the pipeline one poll; everything else is the
    standard DataStore surface over the live cache (ttl expiry and
    listeners included, StreamDataStore.scala:49's cache semantics).
    """

    def __init__(self, sft: SimpleFeatureType | str,
                 converter_config: dict, source: StreamSource,
                 spec: str | None = None,
                 ttl_millis: int | None = None,
                 bus: MessageBus | None = None, device=None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        from ..convert import converter_for
        self.sft = sft
        self.source = source
        self.converter = converter_for(sft, converter_config)
        self._live = LiveDataStore(bus=bus, ttl_millis=ttl_millis,
                                   device=device)
        self.device = self._live.device
        self._live.create_schema(sft)

    # -- pipeline ----------------------------------------------------------

    def tick(self) -> int:
        """Poll the source, convert, apply to the cache; returns the
        number of features ingested this tick."""
        records = self.source.poll()
        if not records:
            self._live.expire(self.sft.type_name)
            return 0
        # converters consume text streams: string records join as
        # lines; structured records (dicts/lists from a queue source)
        # serialize to JSON lines for the json converter. Records that
        # serialize to nothing sane become bad-record lines the
        # converter counts as failures, not a dead pipeline.
        import json as _json

        def as_line(r) -> str:
            if isinstance(r, str):
                # records read from file handles keep their newline;
                # strip so the join never produces blank "bad records"
                return r.rstrip("\r\n")
            try:
                return _json.dumps(r)
            except (TypeError, ValueError):
                return str(r)

        payload: Any = "\n".join(as_line(r) for r in records) + "\n"
        batch, ctx = self.converter.process(payload)
        if batch.n:
            self._live.write(self.sft.type_name, batch)
        self._live.expire(self.sft.type_name)
        return batch.n

    def add_listener(self, fn):
        self._live.add_listener(self.sft.type_name, fn)

    def remove_listener(self, fn):
        self._live.remove_listener(self.sft.type_name, fn)

    # -- DataStore surface -------------------------------------------------

    def create_schema(self, sft, spec=None):
        raise NotImplementedError("a stream store is bound to one type")

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._live.get_schema(type_name)

    def get_type_names(self) -> list[str]:
        return self._live.get_type_names()

    def write(self, type_name: str, batch, **kwargs):
        self._live.write(type_name, batch, **kwargs)

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None):
        return self._live.query(q, type_name, explain_out=explain_out)

    def count(self, type_name: str) -> int:
        return self._live.count(type_name)
