"""SFB (simple-feature-binary) codec: versioned row serialization with a
per-row offset table for lazy attribute access.

The analog of the reference's Kryo feature serializer
(geomesa-features/.../kryo/KryoFeatureSerializer.scala:19) and its lazy
buffer feature (kryo/KryoBufferSimpleFeature.scala: an attribute offsets
array + ``setBuffer``): a serialized row serves a single attribute read
without decoding the rest. The batch encode and the column extracts run
in the port's native library (``native/src/feature_codec.cpp``, built at
first use; a failed build raises ``NativeBuildError``). Their Python
versions are the plain twins beside them (``encode_batch_plain``,
``decode_attribute_plain``, ``decode_batch_plain``), which the tests
hold them to, byte for byte; the blobs equal the JAX package's.

Row layout (little-endian, version 1): see feature_codec.cpp's header.

Wire encodings per SFT type:
  Integer        i32            Float          f32
  Long           i64            Double         f64
  Boolean        u8             Date           i64 epoch-millis
  Point          f64 x, f64 y   String/UUID    utf-8 bytes
  Bytes          raw bytes      other geometry WKB
  List/Map       recursive (count + elements), single-feature API only
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np

from .. import native
from ..geometry import Geometry, Point
from ..geometry.wkb import from_wkb, to_wkb
from .batch import (BoolColumn, DateColumn, FeatureBatch, GeometryColumn,
                    NumericColumn, PointColumn, StringColumn)
from .sft import SimpleFeatureType

__all__ = ["FeatureCodec", "EncodedBatch", "LazyFeature"]

_FIXED_WIDTH = {"Integer": 4, "Long": 8, "Float": 4, "Double": 8,
                "Boolean": 1, "Date": 8, "Point": 16}
_FIXED_DTYPE = {"Integer": "<i4", "Long": "<i8", "Float": "<f4",
                "Double": "<f8", "Boolean": "u1", "Date": "<i8"}


@dataclasses.dataclass
class EncodedBatch:
    """A batch of SFB rows: one contiguous blob + row offsets + ids."""
    blob: bytes
    row_offsets: np.ndarray   # int64[n+1]
    ids: np.ndarray           # object[n]

    @property
    def n(self) -> int:
        return len(self.row_offsets) - 1

    def row(self, i: int) -> bytes:
        return self.blob[self.row_offsets[i]:self.row_offsets[i + 1]]


def _cell_inputs(codec: "FeatureCodec", batch: FeatureBatch):
    """Normalize columns into (kind, width, fixed_bytes, var_bytes,
    var_offsets, valid) per attribute: kind 0 is fixed width, 1 is
    variable width."""
    out = []
    for a in codec.sft.attributes:
        col = batch.columns[a.name]
        t = a.type.name
        valid = np.ascontiguousarray(col.valid, dtype=np.uint8)
        if t == "Point":
            xy = np.empty((col.n, 2), dtype="<f8")
            xy[:, 0] = col.x
            xy[:, 1] = col.y
            out.append((0, 16, xy.view(np.uint8).reshape(-1), None, None,
                        valid))
        elif t in _FIXED_DTYPE:
            vals = col.millis if isinstance(col, DateColumn) else col.values
            arr = np.ascontiguousarray(vals.astype(_FIXED_DTYPE[t]))
            out.append((0, _FIXED_WIDTH[t], arr.view(np.uint8).reshape(-1),
                        None, None, valid))
        else:
            if t in ("String", "UUID"):
                vocab = [s.encode("utf-8") for s in col.vocab]
                cells = [vocab[c] if c >= 0 else b"" for c in col.codes]
            elif isinstance(col, GeometryColumn):
                cells = [to_wkb(g) if g is not None else b""
                         for g in col.geoms]
            else:   # Bytes
                cells = [bytes(v) if v is not None else b""
                         for v in (col.value(i) for i in range(col.n))]
            offsets = np.zeros(len(cells) + 1, dtype=np.int64)
            np.cumsum([len(b) for b in cells], out=offsets[1:])
            out.append((1, 0, None, np.frombuffer(b"".join(cells),
                                                  dtype=np.uint8),
                        offsets, valid))
    return out


class FeatureCodec:
    """Batch-oriented SFB serializer for one SimpleFeatureType."""

    def __init__(self, sft: SimpleFeatureType):
        self.sft = sft
        self.n_attrs = len(sft.attributes)
        self._bitmap_len = (self.n_attrs + 7) // 8
        self._header = 1 + self._bitmap_len + 4 * self.n_attrs

    # -- batch encode -----------------------------------------------------

    def encode_batch(self, batch: FeatureBatch) -> EncodedBatch:
        """The batch as SFB rows, interleaved in the native library."""
        cells = _cell_inputs(self, batch)
        lib = native.library()
        n, na = batch.n, self.n_attrs
        kinds = np.array([c[0] for c in cells], dtype=np.uint8)
        widths = np.array([c[1] for c in cells], dtype=np.int32)
        fixed = (native.U8P * na)(*[native.ptr(c[2], native.U8P)
                                    for c in cells])
        var = (native.U8P * na)(*[native.ptr(c[3], native.U8P)
                                  for c in cells])
        voff = (native.I64P * na)(*[native.ptr(c[4], native.I64P)
                                    for c in cells])
        valids = (native.U8P * na)(*[native.ptr(c[5], native.U8P)
                                     for c in cells])
        kp = native.ptr(kinds, native.U8P)
        wp = native.ptr(widths, native.I32P)
        size = lib.sfb_encoded_size(n, na, kp, wp, voff, valids)
        out = np.zeros(size, dtype=np.uint8)
        row_offsets = np.zeros(n + 1, dtype=np.int64)
        written = lib.sfb_encode_batch(
            n, na, kp, wp, fixed, var, voff, valids,
            native.ptr(out, native.U8P), size,
            native.ptr(row_offsets, native.I64P))
        if written != size:
            raise RuntimeError(f"native encode wrote {written}, "
                               f"expected {size}")
        return EncodedBatch(out.tobytes(), row_offsets,
                            np.asarray(batch.ids, dtype=object))

    def encode_batch_plain(self, batch: FeatureBatch) -> EncodedBatch:
        """``encode_batch``'s plain twin: one Python loop a row."""
        cells = _cell_inputs(self, batch)
        n = batch.n
        rows = []
        pos = 0
        row_offsets = np.zeros(n + 1, dtype=np.int64)
        for r in range(n):
            bm = bytearray(self._bitmap_len)
            offs = np.zeros(self.n_attrs, dtype="<u4")
            payload = bytearray()
            for a, (kind, width, fixed, var, voff, valid) in enumerate(cells):
                offs[a] = len(payload)
                if not valid[r]:
                    continue
                bm[a >> 3] |= 1 << (a & 7)
                if kind == 0:
                    payload += fixed[r * width:(r + 1) * width].tobytes()
                else:
                    payload += var[voff[r]:voff[r + 1]].tobytes()
            row = b"\x01" + bytes(bm) + offs.tobytes() + bytes(payload)
            rows.append(row)
            pos += len(row)
            row_offsets[r + 1] = pos
        return EncodedBatch(b"".join(rows), row_offsets,
                            np.asarray(batch.ids, dtype=object))

    # -- batch decode -----------------------------------------------------

    def decode_batch(self, enc: EncodedBatch) -> FeatureBatch:
        return FeatureBatch(self.sft, enc.ids,
                            {a.name: self.decode_attribute(enc, a.name)
                             for a in self.sft.attributes})

    def decode_batch_plain(self, enc: EncodedBatch) -> FeatureBatch:
        return FeatureBatch(self.sft, enc.ids,
                            {a.name: self.decode_attribute_plain(enc, a.name)
                             for a in self.sft.attributes})

    def decode_attribute(self, enc: EncodedBatch, name: str):
        """Lazily extract ONE attribute column from the blob (native)."""
        return self._decode_attribute(enc, name, plain=False)

    def decode_attribute_plain(self, enc: EncodedBatch, name: str):
        """``decode_attribute``'s plain twin: one Python loop a row."""
        return self._decode_attribute(enc, name, plain=True)

    def _decode_attribute(self, enc: EncodedBatch, name: str, plain: bool):
        attr = self.sft.index_of(name)
        t = self.sft.attributes[attr].type.name
        n = enc.n
        blob = np.frombuffer(enc.blob, dtype=np.uint8)
        offsets = np.ascontiguousarray(enc.row_offsets, dtype=np.int64)
        if t in _FIXED_WIDTH:
            width = _FIXED_WIDTH[t]
            vals = np.zeros(n * width, dtype=np.uint8)
            valid = np.zeros(n, dtype=np.uint8)
            if plain:
                self._decode_fixed_plain(blob, offsets, attr, width, vals,
                                         valid)
            else:
                rc = native.library().sfb_decode_fixed(
                    native.ptr(blob, native.U8P),
                    native.ptr(offsets, native.I64P), n, self.n_attrs,
                    attr, width, native.ptr(vals, native.U8P),
                    native.ptr(valid, native.U8P))
                if rc != n:
                    raise ValueError("corrupt SFB blob (width mismatch)")
            vmask = valid.astype(bool)
            if t == "Point":
                xy = vals.view("<f8").reshape(n, 2)
                return PointColumn(name, np.where(vmask, xy[:, 0], np.nan),
                                   np.where(vmask, xy[:, 1], np.nan), vmask)
            arr = vals.view(_FIXED_DTYPE[t]).copy()
            if t == "Date":
                return DateColumn(name, arr.astype(np.int64), vmask)
            if t == "Boolean":
                return BoolColumn(name, arr.astype(bool), vmask)
            if t in ("Double", "Float"):
                return NumericColumn(name, arr.astype(np.float64), vmask)
            return NumericColumn(name, arr.astype(np.int64), vmask)
        cells, vmask = (self._decode_var_plain(blob, offsets, attr) if plain
                        else self._decode_var(blob, offsets, attr))
        if t in ("String", "UUID"):
            return StringColumn.from_strings(
                name, [c.tobytes().decode("utf-8") if v else None
                       for c, v in zip(cells, vmask)])
        if t == "Bytes":
            return _BytesColumn(name, [c.tobytes() if v else None
                                       for c, v in zip(cells, vmask)])
        return GeometryColumn.from_geoms(
            name, [from_wkb(c.tobytes()) if v else None
                   for c, v in zip(cells, vmask)])

    def _cell_span(self, blob, base, end, attr):
        bm = blob[base + 1:base + 1 + self._bitmap_len]
        ok = bool((bm[attr >> 3] >> (attr & 7)) & 1)
        offs = blob[base + 1 + self._bitmap_len:base + self._header]
        offs = offs.view("<u4")
        s = int(offs[attr])
        e = (int(offs[attr + 1]) if attr + 1 < self.n_attrs
             else end - base - self._header)
        return s, e, ok, base + self._header

    def _decode_fixed_plain(self, blob, row_offsets, attr, width, vals, valid):
        for r in range(len(row_offsets) - 1):
            s, e, ok, pstart = self._cell_span(
                blob, int(row_offsets[r]), int(row_offsets[r + 1]), attr)
            valid[r] = 1 if ok else 0
            if ok:
                if e - s != width:
                    raise ValueError("corrupt SFB blob (width mismatch)")
                vals[r * width:(r + 1) * width] = blob[pstart + s:pstart + e]

    def _decode_var(self, blob, row_offsets, attr):
        n = len(row_offsets) - 1
        lib = native.library()
        lens = np.zeros(n, dtype=np.int64)
        valid = np.zeros(n, dtype=np.uint8)
        bp = native.ptr(blob, native.U8P)
        rp = native.ptr(row_offsets, native.I64P)
        total = lib.sfb_decode_varlen_sizes(
            bp, rp, n, self.n_attrs, attr, native.ptr(lens, native.I64P),
            native.ptr(valid, native.U8P))
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        out = np.zeros(total, dtype=np.uint8)
        lib.sfb_decode_varlen(bp, rp, n, self.n_attrs, attr,
                              native.ptr(offsets, native.I64P),
                              native.ptr(out, native.U8P))
        return ([out[offsets[r]:offsets[r + 1]] for r in range(n)],
                valid.astype(bool))

    def _decode_var_plain(self, blob, row_offsets, attr):
        n = len(row_offsets) - 1
        cells, valid = [], np.zeros(n, dtype=bool)
        for r in range(n):
            s, e, ok, pstart = self._cell_span(
                blob, int(row_offsets[r]), int(row_offsets[r + 1]), attr)
            valid[r] = ok
            cells.append(blob[pstart + s:pstart + e] if ok
                         else np.empty(0, dtype=np.uint8))
        return cells, valid

    # -- single features ----------------------------------------------------

    def serialize(self, values: dict[str, Any]) -> bytes:
        """Serialize one feature (dict of attribute values) to SFB bytes;
        every type, List, Map and Bytes included."""
        bm = bytearray(self._bitmap_len)
        offs = np.zeros(self.n_attrs, dtype="<u4")
        payload = bytearray()
        for a, spec in enumerate(self.sft.attributes):
            offs[a] = len(payload)
            v = values.get(spec.name)
            if v is None:
                continue
            bm[a >> 3] |= 1 << (a & 7)
            payload += _encode_value(spec.type, v)
        return b"\x01" + bytes(bm) + offs.tobytes() + bytes(payload)

    def deserialize(self, buf: bytes) -> "LazyFeature":
        return LazyFeature(self, buf)


@dataclasses.dataclass
class _BytesColumn:
    """Object column of raw bytes values (Bytes attribute type)."""
    name: str
    data: list

    @property
    def n(self) -> int:
        return len(self.data)

    @property
    def valid(self) -> np.ndarray:
        return np.array([v is not None for v in self.data])

    def take(self, idx):
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return _BytesColumn(self.name, [self.data[i] for i in idx])

    def value(self, i: int):
        return self.data[i]


def _encode_value(atype, v) -> bytes:
    t = atype.name
    if t == "Integer":
        return struct.pack("<i", int(v))
    if t in ("Long", "Date"):
        return struct.pack("<q", int(v))
    if t == "Float":
        return struct.pack("<f", float(v))
    if t == "Double":
        return struct.pack("<d", float(v))
    if t == "Boolean":
        return struct.pack("B", 1 if v else 0)
    if t in ("String", "UUID"):
        return str(v).encode("utf-8")
    if t == "Bytes":
        return bytes(v)
    if t == "Point":
        if isinstance(v, Point):
            return struct.pack("<dd", v.x, v.y)
        return struct.pack("<dd", float(v[0]), float(v[1]))
    if t == "List":
        elems = [_encode_value(_ET(atype.value_type), e) for e in v]
        return struct.pack("<I", len(elems)) + b"".join(
            struct.pack("<I", len(e)) + e for e in elems)
    if t == "Map":
        items = list(v.items())
        out = [struct.pack("<I", len(items))]
        for k, val in items:
            ke = _encode_value(_ET(atype.key_type), k)
            ve = _encode_value(_ET(atype.value_type), val)
            out.append(struct.pack("<I", len(ke)) + ke)
            out.append(struct.pack("<I", len(ve)) + ve)
        return b"".join(out)
    if isinstance(v, Geometry):
        return to_wkb(v)
    raise TypeError(f"cannot encode {t}")


def _decode_value(atype, buf: bytes):
    t = atype.name
    if t == "Integer":
        return struct.unpack("<i", buf)[0]
    if t in ("Long", "Date"):
        return struct.unpack("<q", buf)[0]
    if t == "Float":
        return struct.unpack("<f", buf)[0]
    if t == "Double":
        return struct.unpack("<d", buf)[0]
    if t == "Boolean":
        return bool(buf[0])
    if t in ("String", "UUID"):
        return buf.decode("utf-8")
    if t == "Bytes":
        return bytes(buf)
    if t == "Point":
        return Point(*struct.unpack("<dd", buf))
    if t == "List":
        n = struct.unpack_from("<I", buf, 0)[0]
        pos, out = 4, []
        et = _ET(atype.value_type)
        for _ in range(n):
            ln = struct.unpack_from("<I", buf, pos)[0]
            out.append(_decode_value(et, buf[pos + 4:pos + 4 + ln]))
            pos += 4 + ln
        return out
    if t == "Map":
        n = struct.unpack_from("<I", buf, 0)[0]
        pos, out = 4, {}
        kt, vt = _ET(atype.key_type), _ET(atype.value_type)
        for _ in range(n):
            ln = struct.unpack_from("<I", buf, pos)[0]
            k = _decode_value(kt, buf[pos + 4:pos + 4 + ln])
            pos += 4 + ln
            ln = struct.unpack_from("<I", buf, pos)[0]
            out[k] = _decode_value(vt, buf[pos + 4:pos + 4 + ln])
            pos += 4 + ln
        return out
    return from_wkb(bytes(buf))


@dataclasses.dataclass(frozen=True)
class _ET:
    """A List's or Map's element type, by name."""
    name: str


class LazyFeature:
    """Offset-table view over one SFB row: attribute reads decode only
    the requested cell (KryoBufferSimpleFeature.scala semantics)."""

    def __init__(self, codec: FeatureCodec, buf: bytes):
        if not buf or buf[0] != 1:
            raise ValueError("bad SFB version")
        self._codec = codec
        self._buf = buf

    def get(self, i: int):
        codec = self._codec
        bm = self._buf[1:1 + codec._bitmap_len]
        if not (bm[i >> 3] >> (i & 7)) & 1:
            return None
        offs = np.frombuffer(self._buf, dtype="<u4", count=codec.n_attrs,
                             offset=1 + codec._bitmap_len)
        start = codec._header + int(offs[i])
        end = (codec._header + int(offs[i + 1]) if i + 1 < codec.n_attrs
               else len(self._buf))
        return _decode_value(codec.sft.attributes[i].type,
                             self._buf[start:end])

    def get_by_name(self, name: str):
        return self.get(self._codec.sft.index_of(name))

    def as_dict(self) -> dict[str, Any]:
        return {a.name: self.get(i)
                for i, a in enumerate(self._codec.sft.attributes)}
