"""Geo input formats: shapefile, JDBC (sqlite), and OSM XML converters.

The reference ships these as converter modules
(/root/reference/geomesa-convert/ geomesa-convert-jdbc, -osm; shapefile
ingest via geomesa-tools/.../ingest ShapefileConverter). Here each is a
``SimpleFeatureConverter`` whose record stream exposes columns to the
same transform DSL as every other format:

- **shapefile** — a from-scratch reader of the ESRI .shp (geometry) +
  .dbf (dBase III attributes) pair; no external libraries. Record
  columns: $1 = geometry WKT, $2.. = dbf attribute values in file
  order. Config: {"type": "shapefile", ...fields}
- **jdbc** — rows from a SQL query against a sqlite database (the
  stdlib stand-in for the reference's JDBC connections). Record
  columns: $1.. = selected columns. Config: {"type": "jdbc",
  "query": "SELECT ..."}; the process() input is the database path.
- **osm** — OpenStreetMap XML: nodes become points, ways become
  linestrings (closed ways polygons) via node-reference resolution.
  Record columns: $1 = element id, $2 = element type ('node'/'way'),
  $3 = geometry WKT, $0 = the tags dict (transforms can use
  ``mapValue($0, 'name')``). Config: {"type": "osm"}.
"""

from __future__ import annotations

import struct
from typing import Any, Iterable

from .converter import _BAD_RECORD, SimpleFeatureConverter

__all__ = ["ShapefileConverter", "JdbcConverter", "OsmConverter",
           "read_shapefile"]


# -- shapefile (.shp + .dbf) ----------------------------------------------


def _ring_wkt(pts) -> str:
    return "(" + ", ".join(f"{x!r} {y!r}" for x, y in pts) + ")"


def _signed_area(pts) -> float:
    a = 0.0
    for (x1, y1), (x2, y2) in zip(pts, pts[1:]):
        a += x1 * y2 - x2 * y1
    return a / 2.0


def _polygon_wkt(rings) -> str:
    """Group shapefile rings (outer = clockwise = negative area) into
    polygons; counter-clockwise rings are holes of the preceding outer."""
    polys: list[list] = []
    for ring in rings:
        if _signed_area(ring) <= 0 or not polys:
            polys.append([ring])
        else:
            polys[-1].append(ring)
    if len(polys) == 1:
        return "POLYGON (" + ", ".join(_ring_wkt(r)
                                       for r in polys[0]) + ")"
    return "MULTIPOLYGON (" + ", ".join(
        "(" + ", ".join(_ring_wkt(r) for r in p) + ")"
        for p in polys) + ")"


def _shape_wkt(shape_type: int, buf: bytes) -> str | None:
    if shape_type == 0:
        return None
    if shape_type == 1:                      # Point
        x, y = struct.unpack_from("<2d", buf, 0)
        return f"POINT ({x!r} {y!r})"
    if shape_type == 8:                      # MultiPoint
        (n,) = struct.unpack_from("<i", buf, 32)
        pts = struct.unpack_from(f"<{2 * n}d", buf, 36)
        return "MULTIPOINT (" + ", ".join(
            f"{pts[2*i]!r} {pts[2*i+1]!r}" for i in range(n)) + ")"
    if shape_type in (3, 5):                 # PolyLine / Polygon
        nparts, npoints = struct.unpack_from("<2i", buf, 32)
        parts = struct.unpack_from(f"<{nparts}i", buf, 40)
        coords = struct.unpack_from(f"<{2 * npoints}d", buf,
                                    40 + 4 * nparts)
        pts = [(coords[2 * i], coords[2 * i + 1]) for i in range(npoints)]
        rings = [pts[parts[i]:(parts[i + 1] if i + 1 < nparts
                               else npoints)]
                 for i in range(nparts)]
        if shape_type == 3:
            if len(rings) == 1:
                return "LINESTRING " + _ring_wkt(rings[0])
            return "MULTILINESTRING (" + ", ".join(
                _ring_wkt(r) for r in rings) + ")"
        return _polygon_wkt(rings)
    raise ValueError(f"unsupported shape type {shape_type}")


def _read_dbf(path: str) -> list[list]:
    """dBase III attribute rows (strings/numbers/bools/date strings)."""
    with open(path, "rb") as f:
        data = f.read()
    n_rec, hdr_len, rec_len = struct.unpack_from("<IHH", data, 4)
    fields = []
    off = 32
    while off < hdr_len - 1 and data[off] != 0x0D:
        name = data[off:off + 11].split(b"\x00")[0].decode("ascii",
                                                           "replace")
        ftype = chr(data[off + 11])
        flen = data[off + 16]
        fields.append((name, ftype, flen))
        off += 32
    rows = []
    pos = hdr_len
    for _ in range(n_rec):
        if pos + rec_len > len(data):
            break
        rec = data[pos:pos + rec_len]
        pos += rec_len
        if rec[:1] == b"*":                  # deleted
            continue
        vals: list[Any] = []
        o = 1
        for name, ftype, flen in fields:
            raw = rec[o:o + flen].decode("latin-1").strip()
            o += flen
            if ftype in ("N", "F"):
                try:
                    vals.append(float(raw) if ("." in raw or "e" in raw)
                                else int(raw))
                except ValueError:
                    vals.append(None)
            elif ftype == "L":
                vals.append(raw.upper() in ("T", "Y"))
            else:                            # C, D, ...
                vals.append(raw or None)
        rows.append(vals)
    return rows


def read_shapefile(shp_path: str) -> Iterable[tuple]:
    """Yield (wkt, *dbf_values) per feature from a .shp/.dbf pair."""
    with open(shp_path, "rb") as f:
        data = f.read()
    dbf_path = shp_path[:-4] + ".dbf"
    import os
    dbf = _read_dbf(dbf_path) if os.path.exists(dbf_path) else None
    pos = 100                                # past the file header
    i = 0
    while pos + 8 <= len(data):
        (_recno, content_words) = struct.unpack_from(">2i", data, pos)
        pos += 8
        (shape_type,) = struct.unpack_from("<i", data, pos)
        wkt = _shape_wkt(shape_type, data[pos + 4:pos + content_words * 2])
        pos += content_words * 2
        attrs = dbf[i] if dbf is not None and i < len(dbf) else []
        yield (wkt, *attrs)
        i += 1


class ShapefileConverter(SimpleFeatureConverter):
    """process() input: path to a .shp file (its .dbf sits beside it)."""

    def _records(self, source) -> Iterable[list]:
        for tup in read_shapefile(str(source)):
            yield [None, *tup]


# -- JDBC (sqlite) --------------------------------------------------------


class JdbcConverter(SimpleFeatureConverter):
    """process() input: sqlite database path; config['query'] selects
    the rows ($1.. = columns in SELECT order)."""

    def _records(self, source) -> Iterable[list]:
        import sqlite3
        conn = sqlite3.connect(str(source))
        try:
            cur = conn.execute(self.config["query"])
            for row in cur:
                yield [row, *row]
        finally:
            conn.close()


# -- OSM XML --------------------------------------------------------------


class OsmConverter(SimpleFeatureConverter):
    """process() input: OSM XML text, bytes, or a path to an .osm file."""

    def _records(self, source) -> Iterable[list]:
        import os
        import xml.etree.ElementTree as ET
        if isinstance(source, bytes):
            text = source.decode()
        elif isinstance(source, str) and not source.lstrip().startswith("<") \
                and os.path.exists(source):
            with open(source) as f:
                text = f.read()
        else:
            text = str(source)
        try:
            root = ET.fromstring(text)
        except ET.ParseError:
            yield _BAD_RECORD
            return
        nodes: dict[str, tuple[float, float]] = {}
        for el in root:
            if el.tag == "node":
                try:
                    nid = el.get("id")
                    lon, lat = float(el.get("lon")), float(el.get("lat"))
                except (TypeError, ValueError):
                    yield _BAD_RECORD
                    continue
                nodes[nid] = (lon, lat)
                tags = {t.get("k"): t.get("v") for t in el.findall("tag")}
                yield [tags, nid, "node", f"POINT ({lon!r} {lat!r})"]
        for el in root:
            if el.tag != "way":
                continue
            refs = [nd.get("ref") for nd in el.findall("nd")]
            pts = [nodes[r] for r in refs if r in nodes]
            if len(pts) < 2:
                yield _BAD_RECORD
                continue
            tags = {t.get("k"): t.get("v") for t in el.findall("tag")}
            if pts[0] == pts[-1] and len(pts) >= 4:
                wkt = "POLYGON (" + _ring_wkt(pts) + ")"
            else:
                wkt = "LINESTRING " + _ring_wkt(pts)
            yield [tags, el.get("id"), "way", wkt]
