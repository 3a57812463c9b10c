"""Minimal Avro Object Container File writer (pairs with avro_reader;
no external avro dependency — the reference exports Avro via the Java
library, geomesa-tools export/formats/AvroExporter).

Writes OCF with the null codec: records of null/boolean/long/double/
string/bytes; a FeatureBatch maps to a record schema of
[fid: string] + attributes (dates as long epoch-millis with the
timestamp-millis logical type, geometries as WKT strings — matching
the reference's avro export shape of simple-feature avro files).
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any

from .avro_reader import _MAGIC, _w_bytes, _w_long

__all__ = ["AvroFileWriter", "write_avro_batch"]


class _Encoder:
    """Thin buffer over the shared OCF wire primitives in avro_reader
    (one zigzag-varint implementation for both writers)."""

    def __init__(self):
        self.buf = io.BytesIO()

    def write_long(self, v: int):
        _w_long(self.buf, v)

    def write_double(self, v: float):
        self.buf.write(struct.pack("<d", v))

    def write_bytes(self, v: bytes):
        _w_bytes(self.buf, v)

    def write_string(self, v: str):
        _w_bytes(self.buf, v.encode("utf-8"))

    def write_boolean(self, v: bool):
        self.buf.write(b"\x01" if v else b"\x00")

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


def _avro_type(spec_type: str) -> Any:
    t = spec_type.lower()
    if t in ("integer", "int", "long"):
        return ["null", "long"]
    if t in ("float", "double"):
        return ["null", "double"]
    if t == "boolean":
        return ["null", "boolean"]
    if t == "date":
        return ["null", {"type": "long", "logicalType": "timestamp-millis"}]
    if t == "bytes":
        return ["null", "bytes"]
    return ["null", "string"]  # strings + WKT geometries


class AvroFileWriter:
    """Stream FeatureBatches into one OCF."""

    def __init__(self, sink, sft):
        self.sink = sink
        self.sft = sft
        self.sync = os.urandom(16)
        fields = [{"name": "__fid__", "type": "string"}]
        self._types = []
        for a in sft.attributes:
            fields.append({"name": a.name, "type": _avro_type(a.type.name)})
            self._types.append(a.type.name.lower())
        self.schema = {"type": "record", "name": sft.type_name,
                       "fields": fields}
        self._write_header()

    def _write_header(self):
        enc = _Encoder()
        meta = {"avro.schema": json.dumps(self.schema).encode(),
                "avro.codec": b"null"}
        enc.write_long(len(meta))
        for k, v in meta.items():
            enc.write_string(k)
            enc.write_bytes(v)
        enc.write_long(0)  # end of map
        self.sink.write(_MAGIC + enc.getvalue() + self.sync)

    def _encode_value(self, enc: _Encoder, t: str, v):
        if v is None:
            enc.write_long(0)  # union branch: null
            return
        enc.write_long(1)
        if t in ("integer", "int", "long"):
            enc.write_long(int(v))
        elif t in ("float", "double"):
            enc.write_double(float(v))
        elif t == "boolean":
            enc.write_boolean(bool(v))
        elif t == "date":
            enc.write_long(int(v))
        elif t == "bytes":
            enc.write_bytes(bytes(v))
        else:
            enc.write_string(str(v))

    def write(self, batch):
        if batch.n == 0:
            return
        enc = _Encoder()
        geom = batch.sft.geom_field
        for i in range(batch.n):
            f = batch.feature(i)
            enc.write_string(str(f["id"]))
            for a, t in zip(batch.sft.attributes, self._types):
                v = f[a.name]
                if a.name == geom or t in ("point", "polygon", "linestring",
                                           "geometry", "multipoint",
                                           "multipolygon", "multilinestring"):
                    if v is not None:
                        from ..geometry import to_wkt
                        v = to_wkt(v)
                elif t == "date" and v is not None:
                    v = int(v)
                self._encode_value(enc, t, v)
        block = enc.getvalue()
        head = _Encoder()
        head.write_long(batch.n)
        head.write_long(len(block))
        self.sink.write(head.getvalue() + block + self.sync)


def write_avro_batch(sft, batch) -> bytes:
    sink = io.BytesIO()
    w = AvroFileWriter(sink, sft)
    w.write(batch)
    return sink.getvalue()
