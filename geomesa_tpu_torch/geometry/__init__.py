"""The geometry model: envelopes, points, lines, polygons, their
multi-part forms and collections, with exact float64 host predicates
(``base``), the DE-9IM relate matrix and its named predicates
(``relate``), and WKT, WKB and GeoJSON encodings."""

from .base import (Envelope, Geometry, GeometryCollection, LineString,
                   MultiLineString, MultiPoint, MultiPolygon, Point, Polygon)
from .wkt import parse_wkt, to_wkt

__all__ = ["Envelope", "Geometry", "GeometryCollection", "LineString",
           "MultiLineString", "MultiPoint", "MultiPolygon", "Point",
           "Polygon", "parse_wkt", "to_wkt"]
