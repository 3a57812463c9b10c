"""Geometry model of point schemas: envelopes, points, polygons and
multipolygons with exact float64 host predicates, and their WKT."""

from .base import Envelope, Geometry, MultiPolygon, Point, Polygon
from .wkt import parse_wkt, to_wkt

__all__ = ["Envelope", "Geometry", "MultiPolygon", "Point", "Polygon",
           "parse_wkt", "to_wkt"]
