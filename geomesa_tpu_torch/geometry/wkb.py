"""OGC Well-Known-Binary geometry serialization.

The reference serializes geometries with a WKB-ish twkb/kryo scheme
(geomesa-features/.../kryo/serialization/KryoGeometrySerialization.scala);
here we use standard little-endian WKB so buffers interoperate with
pyarrow/GDAL tooling directly.

Supported: Point, LineString, Polygon, MultiPoint, MultiLineString,
MultiPolygon, GeometryCollection (2D).
"""

from __future__ import annotations

import struct

import numpy as np

from .base import (Geometry, GeometryCollection, LineString, MultiLineString,
                   MultiPoint, MultiPolygon, Point, Polygon)

__all__ = ["to_wkb", "from_wkb"]

_WKB_POINT = 1
_WKB_LINESTRING = 2
_WKB_POLYGON = 3
_WKB_MULTIPOINT = 4
_WKB_MULTILINESTRING = 5
_WKB_MULTIPOLYGON = 6
_WKB_COLLECTION = 7


def _coords_bytes(coords: np.ndarray) -> bytes:
    c = np.ascontiguousarray(coords, dtype="<f8")
    return struct.pack("<I", len(c)) + c.tobytes()


def _write(g: Geometry, out: list) -> None:
    if isinstance(g, Point):
        out.append(struct.pack("<BI", 1, _WKB_POINT))
        out.append(struct.pack("<dd", g.x, g.y))
    elif isinstance(g, LineString):
        out.append(struct.pack("<BI", 1, _WKB_LINESTRING))
        out.append(_coords_bytes(g.coords))
    elif isinstance(g, Polygon):
        rings = g.coords_list()
        out.append(struct.pack("<BI", 1, _WKB_POLYGON))
        out.append(struct.pack("<I", len(rings)))
        for r in rings:
            out.append(_coords_bytes(r))
    elif isinstance(g, (MultiPoint, MultiLineString, MultiPolygon,
                        GeometryCollection)):
        code = {MultiPoint: _WKB_MULTIPOINT,
                MultiLineString: _WKB_MULTILINESTRING,
                MultiPolygon: _WKB_MULTIPOLYGON,
                GeometryCollection: _WKB_COLLECTION}[type(g)]
        out.append(struct.pack("<BI", 1, code))
        out.append(struct.pack("<I", len(g.parts)))
        for p in g.parts:
            _write(p, out)
    else:  # pragma: no cover
        raise TypeError(f"cannot WKB-encode {type(g).__name__}")


def to_wkb(g: Geometry) -> bytes:
    out: list = []
    _write(g, out)
    return b"".join(out)


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _order(self) -> str:
        b = self.buf[self.pos]
        self.pos += 1
        return "<" if b == 1 else ">"

    def _u32(self, order: str) -> int:
        v = struct.unpack_from(order + "I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def _coords(self, order: str) -> np.ndarray:
        n = self._u32(order)
        arr = np.frombuffer(self.buf, dtype=order + "f8",
                            count=2 * n, offset=self.pos)
        self.pos += 16 * n
        return arr.reshape(-1, 2).astype(np.float64)

    def read(self) -> Geometry:
        order = self._order()
        code = self._u32(order)
        if code == _WKB_POINT:
            x, y = struct.unpack_from(order + "dd", self.buf, self.pos)
            self.pos += 16
            return Point(x, y)
        if code == _WKB_LINESTRING:
            return LineString(self._coords(order))
        if code == _WKB_POLYGON:
            nr = self._u32(order)
            rings = [self._coords(order) for _ in range(nr)]
            return Polygon(rings[0], rings[1:])
        if code in (_WKB_MULTIPOINT, _WKB_MULTILINESTRING,
                    _WKB_MULTIPOLYGON, _WKB_COLLECTION):
            n = self._u32(order)
            parts = [self.read() for _ in range(n)]
            cls = {_WKB_MULTIPOINT: MultiPoint,
                   _WKB_MULTILINESTRING: MultiLineString,
                   _WKB_MULTIPOLYGON: MultiPolygon,
                   _WKB_COLLECTION: GeometryCollection}[code]
            return cls(parts)
        raise ValueError(f"unsupported WKB geometry code {code}")


def from_wkb(buf: bytes) -> Geometry:
    return _Reader(buf).read()
