"""Minimal Avro Object Container File reader (no external avro dep —
the environment has none; the reference ingests Avro via the Java avro
library, geomesa-convert-avro).

Supports the OCF layout (magic 'Obj\\x01', metadata map with
avro.schema/avro.codec, sync-marker-delimited blocks; null and deflate
codecs) and the standard binary encoding for: null, boolean, int, long
(zigzag varints), float, double, bytes, string, fixed, enum, array,
map, union, record. Logical types surface as their base type.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, BinaryIO, Iterator

__all__ = ["AvroFileReader", "read_avro"]

_MAGIC = b"Obj\x01"


class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) < n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def value(self, schema) -> Any:
        if isinstance(schema, list):  # union
            idx = self.long()
            return self.value(schema[idx])
        if isinstance(schema, str):
            t = schema
        else:
            t = schema["type"]
        if t == "null":
            return None
        if t == "boolean":
            return self.read(1) != b"\x00"
        if t in ("int", "long"):
            return self.long()
        if t == "float":
            return struct.unpack("<f", self.read(4))[0]
        if t == "double":
            return struct.unpack("<d", self.read(8))[0]
        if t == "bytes":
            return self.read(self.long())
        if t == "string":
            return self.read(self.long()).decode("utf-8")
        if t == "fixed":
            return self.read(schema["size"])
        if t == "enum":
            return schema["symbols"][self.long()]
        if t == "array":
            out = []
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:  # block with byte size
                    self.long()
                    n = -n
                out.extend(self.value(schema["items"]) for _ in range(n))
            return out
        if t == "map":
            out = {}
            while True:
                n = self.long()
                if n == 0:
                    break
                if n < 0:
                    self.long()
                    n = -n
                for _ in range(n):
                    k = self.read(self.long()).decode("utf-8")
                    out[k] = self.value(schema["values"])
            return out
        if t == "record":
            return {f["name"]: self.value(f["type"])
                    for f in schema["fields"]}
        if isinstance(schema, dict) and t not in (
                "record", "array", "map", "fixed", "enum"):
            return self.value(t)  # {"type": "string", "logicalType": ...}
        raise ValueError(f"unsupported avro type {t!r}")


class AvroFileReader:
    """Iterate records of an Avro OCF stream."""

    def __init__(self, source: "BinaryIO | bytes"):
        if isinstance(source, (bytes, bytearray)):
            source = io.BytesIO(source)
        self._fh = source
        if self._fh.read(4) != _MAGIC:
            raise ValueError("not an Avro object container file")
        meta_dec = _Decoder(self._read_all_header())
        self.metadata = {}
        while True:
            n = meta_dec.long()
            if n == 0:
                break
            if n < 0:
                meta_dec.long()
                n = -n
            for _ in range(n):
                k = meta_dec.read(meta_dec.long()).decode()
                self.metadata[k] = meta_dec.read(meta_dec.long())
        self._header_tail = meta_dec.buf[meta_dec.pos:]
        self.schema = json.loads(self.metadata["avro.schema"])
        self.codec = self.metadata.get("avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {self.codec!r}")
        self.sync = self._header_tail[:16]
        self._body = self._header_tail[16:]

    def _read_all_header(self) -> bytes:
        return self._fh.read()

    def __iter__(self) -> Iterator[dict]:
        dec = _Decoder(self._body)
        while not dec.eof:
            count = dec.long()
            size = dec.long()
            block = dec.read(size)
            if self.codec == "deflate":
                block = zlib.decompress(block, -15)
            bdec = _Decoder(block)
            for _ in range(count):
                yield bdec.value(self.schema)
            if dec.read(16) != self.sync:
                raise ValueError("avro sync marker mismatch")


def read_avro(source) -> tuple[dict, list]:
    """(schema, records) of an OCF file/bytes."""
    r = AvroFileReader(source)
    return r.schema, list(r)


# -- writer (test/export support) ---------------------------------------

def write_avro(schema: dict, records: list, codec: str = "null") -> bytes:
    """Encode records as an OCF byte string (enough of a writer for
    round-trip tests and the CLI avro export)."""
    out = io.BytesIO()
    out.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    _w_long(out, len(meta))
    for k, v in meta.items():
        _w_bytes(out, k.encode())
        _w_bytes(out, v)
    _w_long(out, 0)
    sync = b"0123456789abcdef"
    out.write(sync)
    body = io.BytesIO()
    for r in records:
        _w_value(body, schema, r)
    block = body.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        block = comp.compress(block) + comp.flush()
    _w_long(out, len(records))
    _w_long(out, len(block))
    out.write(block)
    out.write(sync)
    return out.getvalue()


def _w_long(fh, v: int):
    v = (v << 1) ^ (v >> 63)  # zigzag
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            fh.write(bytes([b | 0x80]))
        else:
            fh.write(bytes([b]))
            break


def _w_bytes(fh, b: bytes):
    _w_long(fh, len(b))
    fh.write(b)


def _w_value(fh, schema, v):
    if isinstance(schema, list):
        for i, s in enumerate(schema):
            t = s if isinstance(s, str) else s["type"]
            if (v is None) == (t == "null"):
                _w_long(fh, i)
                return _w_value(fh, s, v)
        raise ValueError("no union branch")
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return
    if t == "boolean":
        fh.write(b"\x01" if v else b"\x00")
    elif t in ("int", "long"):
        _w_long(fh, int(v))
    elif t == "float":
        fh.write(struct.pack("<f", v))
    elif t == "double":
        fh.write(struct.pack("<d", v))
    elif t == "bytes":
        _w_bytes(fh, bytes(v))
    elif t == "string":
        _w_bytes(fh, str(v).encode("utf-8"))
    elif t == "record":
        for f in schema["fields"]:
            _w_value(fh, f["type"], v[f["name"]])
    elif t == "array":
        if v:
            _w_long(fh, len(v))
            for e in v:
                _w_value(fh, schema["items"], e)
        _w_long(fh, 0)
    elif t == "map":
        if v:
            _w_long(fh, len(v))
            for k, e in v.items():
                _w_bytes(fh, str(k).encode())
                _w_value(fh, schema["values"], e)
        _w_long(fh, 0)
    else:
        raise ValueError(f"unsupported write type {t!r}")
