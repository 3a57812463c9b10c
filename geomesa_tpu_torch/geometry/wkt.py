"""WKT (Well-Known Text) parse/format for the geometry model.

Replaces the reference's use of JTS WKTReader/WKTWriter
(geomesa-utils/.../text/WKTUtils). Supports POINT, LINESTRING, POLYGON,
MULTIPOINT, MULTILINESTRING, MULTIPOLYGON, GEOMETRYCOLLECTION and EMPTY.
"""

from __future__ import annotations

import re

import numpy as np

from .base import (Geometry, GeometryCollection, LineString, MultiLineString,
                   MultiPoint, MultiPolygon, Point, Polygon)

__all__ = ["parse_wkt", "to_wkt"]


class _Scanner:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self.skip_ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch: str):
        self.skip_ws()
        if self.i >= len(self.s) or self.s[self.i] != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s[:80]!r}")
        self.i += 1

    def word(self) -> str:
        self.skip_ws()
        m = re.match(r"[A-Za-z]+", self.s[self.i:])
        if not m:
            raise ValueError(f"expected word at {self.i} in {self.s[:80]!r}")
        self.i += m.end()
        return m.group(0).upper()

    def number(self) -> float:
        self.skip_ws()
        m = re.match(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", self.s[self.i:])
        if not m:
            raise ValueError(f"expected number at {self.i} in {self.s[:80]!r}")
        self.i += m.end()
        return float(m.group(0))


def _coords(sc: _Scanner) -> np.ndarray:
    """Parse '(x y, x y, ...)' -> (n, 2). Z/M ordinates are dropped."""
    sc.expect("(")
    pts = []
    while True:
        x = sc.number()
        y = sc.number()
        # optional extra ordinates (z / m)
        while sc.peek() not in ",)":
            sc.number()
        pts.append((x, y))
        if sc.peek() == ",":
            sc.expect(",")
        else:
            break
    sc.expect(")")
    return np.array(pts, dtype=np.float64)


def _maybe_empty(sc: _Scanner) -> bool:
    save = sc.i
    try:
        if sc.word() == "EMPTY":
            return True
    except ValueError:
        pass
    sc.i = save
    return False


def _rings(sc: _Scanner) -> list[np.ndarray]:
    sc.expect("(")
    rings = [_coords(sc)]
    while sc.peek() == ",":
        sc.expect(",")
        rings.append(_coords(sc))
    sc.expect(")")
    return rings


def _parse_geom(sc: _Scanner) -> Geometry:
    tag = sc.word()
    if tag == "POINT":
        if _maybe_empty(sc):
            return Point(np.nan, np.nan)
        c = _coords(sc)
        return Point(c[0, 0], c[0, 1])
    if tag == "LINESTRING":
        if _maybe_empty(sc):
            return LineString(np.empty((0, 2)))
        return LineString(_coords(sc))
    if tag == "POLYGON":
        if _maybe_empty(sc):
            return Polygon(np.empty((0, 2)))
        rings = _rings(sc)
        return Polygon(rings[0], rings[1:])
    if tag == "MULTIPOINT":
        if _maybe_empty(sc):
            return MultiPoint([])
        # both MULTIPOINT(1 2, 3 4) and MULTIPOINT((1 2), (3 4))
        sc.expect("(")
        pts = []
        while True:
            if sc.peek() == "(":
                c = _coords(sc)
                pts.append(Point(c[0, 0], c[0, 1]))
            else:
                x = sc.number()
                y = sc.number()
                pts.append(Point(x, y))
            if sc.peek() == ",":
                sc.expect(",")
            else:
                break
        sc.expect(")")
        return MultiPoint(pts)
    if tag == "MULTILINESTRING":
        if _maybe_empty(sc):
            return MultiLineString([])
        return MultiLineString([LineString(c) for c in _rings(sc)])
    if tag == "MULTIPOLYGON":
        if _maybe_empty(sc):
            return MultiPolygon([])
        sc.expect("(")
        polys = []
        while True:
            rings = _rings(sc)
            polys.append(Polygon(rings[0], rings[1:]))
            if sc.peek() == ",":
                sc.expect(",")
            else:
                break
        sc.expect(")")
        return MultiPolygon(polys)
    if tag == "GEOMETRYCOLLECTION":
        if _maybe_empty(sc):
            return GeometryCollection([])
        sc.expect("(")
        geoms = [_parse_geom(sc)]
        while sc.peek() == ",":
            sc.expect(",")
            geoms.append(_parse_geom(sc))
        sc.expect(")")
        return GeometryCollection(geoms)
    raise ValueError(f"unknown WKT type: {tag}")


def parse_wkt(s: str) -> Geometry:
    sc = _Scanner(s)
    g = _parse_geom(sc)
    sc.skip_ws()
    if sc.i != len(sc.s):
        raise ValueError(f"trailing characters in WKT: {s[sc.i:][:40]!r}")
    return g


def _fmt(v: float) -> str:
    v = float(v)
    if not np.isfinite(v):
        return repr(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_coords(c: np.ndarray) -> str:
    return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in c) + ")"


def to_wkt(g: Geometry) -> str:
    t = g.geom_type
    if isinstance(g, Point):
        if g.is_empty:
            return "POINT EMPTY"
        return f"POINT ({_fmt(g.x)} {_fmt(g.y)})"
    if isinstance(g, LineString):
        if g.is_empty:
            return "LINESTRING EMPTY"
        return "LINESTRING " + _fmt_coords(g.coords)
    if isinstance(g, Polygon):
        if g.is_empty:
            return "POLYGON EMPTY"
        rings = ", ".join(_fmt_coords(r) for r in g.coords_list())
        return f"POLYGON ({rings})"
    if isinstance(g, MultiPoint):
        if g.is_empty:
            return "MULTIPOINT EMPTY"
        inner = ", ".join(f"({_fmt(p.x)} {_fmt(p.y)})" for p in g.parts)
        return f"MULTIPOINT ({inner})"
    if isinstance(g, MultiLineString):
        if g.is_empty:
            return "MULTILINESTRING EMPTY"
        inner = ", ".join(_fmt_coords(p.coords) for p in g.parts)
        return f"MULTILINESTRING ({inner})"
    if isinstance(g, MultiPolygon):
        if g.is_empty:
            return "MULTIPOLYGON EMPTY"
        inner = ", ".join("(" + ", ".join(_fmt_coords(r) for r in p.coords_list()) + ")"
                          for p in g.parts)
        return f"MULTIPOLYGON ({inner})"
    if isinstance(g, GeometryCollection):
        if g.is_empty:
            return "GEOMETRYCOLLECTION EMPTY"
        inner = ", ".join(to_wkt(p) for p in g.parts)
        return f"GEOMETRYCOLLECTION ({inner})"
    raise TypeError(f"cannot write WKT for {t}")
