"""GeoJSON geometry encoding (RFC 7946) for export surfaces.

The reference exports GeoJSON via GeoTools' FeatureJSON
(geomesa-tools/.../export/formats/); here geometries render directly
from the columnar model.
"""

from __future__ import annotations

import numpy as np

from .base import (Geometry, GeometryCollection, LineString, MultiLineString,
                   MultiPoint, MultiPolygon, Point, Polygon)

__all__ = ["to_geojson", "from_geojson"]


def _pos(c: np.ndarray) -> list:
    return [[float(x), float(y)] for x, y in np.asarray(c).reshape(-1, 2)]


def to_geojson(g: Geometry) -> dict:
    if isinstance(g, Point):
        return {"type": "Point", "coordinates": [float(g.x), float(g.y)]}
    if isinstance(g, LineString):
        return {"type": "LineString", "coordinates": _pos(g.coords)}
    if isinstance(g, Polygon):
        return {"type": "Polygon",
                "coordinates": [_pos(r) for r in g.coords_list()]}
    if isinstance(g, MultiPoint):
        return {"type": "MultiPoint",
                "coordinates": [to_geojson(p)["coordinates"] for p in g.parts]}
    if isinstance(g, MultiLineString):
        return {"type": "MultiLineString",
                "coordinates": [_pos(p.coords) for p in g.parts]}
    if isinstance(g, MultiPolygon):
        return {"type": "MultiPolygon",
                "coordinates": [[_pos(r) for r in p.coords_list()]
                                for p in g.parts]}
    if isinstance(g, GeometryCollection):
        return {"type": "GeometryCollection",
                "geometries": [to_geojson(p) for p in g.parts]}
    raise TypeError(f"cannot GeoJSON-encode {type(g).__name__}")


def from_geojson(obj: dict) -> Geometry:
    t = obj["type"]
    c = obj.get("coordinates")
    if t == "Point":
        return Point(c[0], c[1])
    if t == "LineString":
        return LineString(c)
    if t == "Polygon":
        return Polygon(c[0], c[1:])
    if t == "MultiPoint":
        return MultiPoint([Point(p[0], p[1]) for p in c])
    if t == "MultiLineString":
        return MultiLineString([LineString(l) for l in c])
    if t == "MultiPolygon":
        return MultiPolygon([Polygon(p[0], p[1:]) for p in c])
    if t == "GeometryCollection":
        return GeometryCollection([from_geojson(o)
                                   for o in obj["geometries"]])
    raise ValueError(f"unknown GeoJSON geometry type {t!r}")
