"""ST_* geometry function library.

The vectorized analog of geomesa-spark-sql's UDF set
(org/apache/spark/sql/SQLSpatialFunctions.scala:31-41 and the
accessor/constructor/cast/output/processing modules): each function
operates on scalars or numpy arrays of geometries/coordinates.

Scalar-geometry functions delegate to the geometry engine; the hot
point-column forms (st_contains over a PointColumn, st_distance
point-to-points) are vectorized numpy. ST_GeoHash and ST_GeomFromGeoHash
go through the port's geohash module.
"""

from __future__ import annotations

import math

import numpy as np

from ..geometry import (Envelope, Geometry, LineString, MultiLineString,
                        MultiPoint, MultiPolygon, Point, Polygon, parse_wkt,
                        to_wkt)
from ..geometry.base import _Multi, _point_segments_dist2

__all__ = [
    "st_contains", "st_covers", "st_crosses", "st_disjoint", "st_equals",
    "st_intersects", "st_overlaps", "st_touches", "st_within", "st_dwithin",
    "st_distance", "st_distance_sphere", "st_area", "st_length",
    "st_centroid", "st_envelope", "st_buffer_envelope", "st_convex_hull",
    "convex_hull_points",
    "st_closest_point", "st_translate", "st_point", "st_make_bbox",
    "st_geom_from_wkt", "st_as_text", "st_x", "st_y",
    "st_point_n", "st_exterior_ring", "st_num_points", "st_make_polygon",
    "st_relate", "st_relate_bool", "st_buffer", "st_buffer_point",
    "st_distance_spheroid", "st_length_spheroid",
    "st_antimeridian_safe_geom", "st_idl_safe_geom",
    "st_cast_to_point", "st_cast_to_linestring",
    "st_cast_to_polygon", "st_cast_to_geometry", "st_as_binary",
    "st_geom_from_wkb", "st_as_geojson", "st_geohash",
    "st_geom_from_geohash", "SQL_SCALARS",
    "contains_points", "distance_points",
]

EARTH_RADIUS_M = 6_371_008.8


# -- constructors / accessors ---------------------------------------------

def st_point(x: float, y: float) -> Point:
    return Point(x, y)


def st_make_bbox(xmin, ymin, xmax, ymax) -> Polygon:
    return Envelope(xmin, ymin, xmax, ymax).to_polygon()


def st_geom_from_wkt(wkt: str) -> Geometry:
    return parse_wkt(wkt)


def st_point_n(g: Geometry, n) -> Point | None:
    """N-th vertex of a LineString, 1-based (st_pointN); negative n
    counts from the end. None for other types or out of range — the
    reference returns null rather than raising."""
    if not isinstance(g, LineString):
        return None
    n = int(n)
    size = len(g.coords)
    if n < 0:
        n = size + n + 1
    if n < 1 or n > size:
        return None
    x, y = g.coords[n - 1]
    return Point(float(x), float(y))


def st_exterior_ring(g: Geometry) -> LineString | None:
    """Polygon shell as a (closed) LineString (st_exteriorRing); None
    for non-polygons."""
    if not isinstance(g, Polygon):
        return None
    return LineString(g.shell)


def st_num_points(g: Geometry) -> int:
    """Total vertex count over every ring/part (st_numPoints)."""
    if isinstance(g, Point):
        return 1
    return int(sum(len(c) for c in g.coords_list()))


def st_make_polygon(shell: LineString) -> Polygon | None:
    """Polygon from a LineString shell (st_makePolygon); None for
    other types or degenerate (< 3 point) rings — the reference
    returns null rather than raising."""
    if not isinstance(shell, LineString) or len(shell.coords) < 3:
        return None
    return Polygon(shell.coords)


def st_as_text(g: Geometry) -> str:
    return to_wkt(g)


def st_x(g: Point) -> float:
    return g.x


def st_y(g: Point) -> float:
    return g.y


def st_envelope(g: Geometry) -> Polygon:
    return g.envelope.to_polygon()


# -- predicates ------------------------------------------------------------

def st_contains(a: Geometry, b: Geometry) -> bool:
    return a.contains(b)


def st_covers(a: Geometry, b: Geometry) -> bool:
    return a.contains(b)  # boundary-inclusive contains == covers here


def st_within(a: Geometry, b: Geometry) -> bool:
    return b.contains(a)


def st_intersects(a: Geometry, b: Geometry) -> bool:
    return a.intersects(b)


def st_disjoint(a: Geometry, b: Geometry) -> bool:
    return not a.intersects(b)


def st_equals(a: Geometry, b: Geometry) -> bool:
    return a.envelope == b.envelope and a.contains(b) and b.contains(a)


def st_crosses(a: Geometry, b: Geometry) -> bool:
    from ..geometry.relate import crosses
    return crosses(a, b)


def st_overlaps(a: Geometry, b: Geometry) -> bool:
    from ..geometry.relate import overlaps
    return overlaps(a, b)


def st_touches(a: Geometry, b: Geometry) -> bool:
    from ..geometry.relate import touches
    return touches(a, b)


def st_relate(a: Geometry, b: Geometry) -> str:
    """The DE-9IM matrix string (SQLSpatialFunctions ST_Relate)."""
    from ..geometry.relate import relate
    return relate(a, b)


def st_relate_bool(a: Geometry, b: Geometry, pattern: str) -> bool:
    """DE-9IM pattern match (ST_RelateBool)."""
    from ..geometry.relate import relate, relate_matches
    return relate_matches(relate(a, b), pattern)


def st_dwithin(a: Geometry, b: Geometry, distance_deg: float) -> bool:
    return a.dwithin(b, distance_deg)


# -- measures --------------------------------------------------------------

def st_distance(a: Geometry, b: Geometry) -> float:
    return a.distance(b)


def st_distance_sphere(a: Point, b: Point) -> float:
    """Great-circle distance in meters (ST_DistanceSpheroid analog,
    haversine on the mean sphere)."""
    return float(haversine_m(a.x, a.y, b.x, b.y))


def haversine_m(x1, y1, x2, y2):
    """Vectorized haversine, meters."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, np.float64))
                              for v in (x1, y1, x2, y2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2)
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def st_area(g: Geometry) -> float:
    return g.area


def st_length(g: Geometry) -> float:
    return g.length


def st_centroid(g: Geometry) -> Point:
    return g.centroid


def st_buffer_envelope(g: Geometry, d: float) -> Polygon:
    """Envelope-expansion buffer (planning-grade; exact round buffers are
    not needed by any reference hot path)."""
    return g.envelope.buffer(d).to_polygon()


_buffer_envelope_warned = False


def st_buffer(g: Geometry, d: float, segments: int = 64) -> Polygon:
    """Planar buffer in degrees (JTS ST_Buffer semantics). Points get a
    true round buffer (n-gon circle in coordinate space); other
    geometries use the envelope expansion — a documented
    over-approximation (planning-grade; exact offset curves for
    lines/polygons are not on any reference hot path)."""
    if isinstance(g, Point):
        ang = np.linspace(0.0, 2.0 * math.pi, segments, endpoint=False)
        ring = np.column_stack([g.x + d * np.cos(ang),
                                g.y + d * np.sin(ang)])
        return Polygon(ring)
    global _buffer_envelope_warned
    if not _buffer_envelope_warned:
        _buffer_envelope_warned = True
        import warnings
        warnings.warn(
            "st_buffer of a non-point geometry returns an envelope"
            " expansion (bbox over-approximation), not an exact offset"
            " curve", stacklevel=2)
    return st_buffer_envelope(g, d)


def st_buffer_point(p: Point, meters: float, segments: int = 64) -> Polygon:
    """True round buffer of a point by a distance in METERS: a ring of
    geodesic destination points on the mean sphere (the reference's
    ST_BufferPoint uses GeoHashUtils' geodesic point buffer;
    SQLGeometryProcessingFunctions.scala). Accurate to the spherical
    approximation; exact circle in the metric, polygonal in degrees."""
    lat1 = math.radians(p.y)
    lon1 = math.radians(p.x)
    ang = meters / EARTH_RADIUS_M
    bearings = np.linspace(0.0, 2.0 * math.pi, segments, endpoint=False)
    lat2 = np.arcsin(np.sin(lat1) * np.cos(ang)
                     + np.cos(lat1) * np.sin(ang) * np.cos(bearings))
    lon2 = lon1 + np.arctan2(
        np.sin(bearings) * np.sin(ang) * np.cos(lat1),
        np.cos(ang) - np.sin(lat1) * np.sin(lat2))
    ring = np.column_stack([np.degrees(lon2), np.degrees(lat2)])
    return Polygon(ring)


# WGS84 spheroid
_WGS84_A = 6_378_137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_B = _WGS84_A * (1.0 - _WGS84_F)


def st_distance_spheroid(a: Point, b: Point) -> float:
    """Vincenty inverse distance on the WGS84 ellipsoid in meters
    (SQLGeometryProcessingFunctions ST_DistanceSpheroid). Falls back to
    haversine for near-antipodal pairs where the iteration diverges."""
    if a.x == b.x and a.y == b.y:
        return 0.0
    L = math.radians(b.x - a.x)
    u1 = math.atan((1 - _WGS84_F) * math.tan(math.radians(a.y)))
    u2 = math.atan((1 - _WGS84_F) * math.tan(math.radians(b.y)))
    su1, cu1 = math.sin(u1), math.cos(u1)
    su2, cu2 = math.sin(u2), math.cos(u2)
    lam = L
    for _ in range(200):
        sl, cl = math.sin(lam), math.cos(lam)
        s_sig = math.sqrt((cu2 * sl) ** 2
                          + (cu1 * su2 - su1 * cu2 * cl) ** 2)
        if s_sig == 0:
            return 0.0
        c_sig = su1 * su2 + cu1 * cu2 * cl
        sig = math.atan2(s_sig, c_sig)
        sin_alpha = cu1 * cu2 * sl / s_sig
        cos2_alpha = 1.0 - sin_alpha * sin_alpha
        cos_2sigm = (c_sig - 2 * su1 * su2 / cos2_alpha
                     if cos2_alpha != 0 else 0.0)
        C = _WGS84_F / 16 * cos2_alpha * (4 + _WGS84_F
                                          * (4 - 3 * cos2_alpha))
        lam_prev = lam
        lam = L + (1 - C) * _WGS84_F * sin_alpha * (
            sig + C * s_sig * (cos_2sigm
                               + C * c_sig * (-1 + 2 * cos_2sigm ** 2)))
        if abs(lam - lam_prev) < 1e-12:
            break
    else:
        return float(haversine_m(a.x, a.y, b.x, b.y))
    u_sq = cos2_alpha * (_WGS84_A ** 2 - _WGS84_B ** 2) / _WGS84_B ** 2
    A = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq
                                           * (320 - 175 * u_sq)))
    B = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    d_sig = B * s_sig * (cos_2sigm + B / 4 * (
        c_sig * (-1 + 2 * cos_2sigm ** 2)
        - B / 6 * cos_2sigm * (-3 + 4 * s_sig ** 2)
        * (-3 + 4 * cos_2sigm ** 2)))
    return float(_WGS84_B * A * (sig - d_sig))


# -- casts / outputs (SQLGeometricCastFunctions / OutputFunctions) ---------

def st_cast_to_point(g: Geometry) -> Point:
    if isinstance(g, Point):
        return g
    if isinstance(g, MultiPoint) and len(g.parts) == 1:
        return g.parts[0]
    raise TypeError(f"cannot cast {g.geom_type} to Point")


def st_cast_to_linestring(g: Geometry) -> LineString:
    if isinstance(g, LineString):
        return g
    from ..geometry import MultiLineString
    if isinstance(g, MultiLineString) and len(g.parts) == 1:
        return g.parts[0]
    raise TypeError(f"cannot cast {g.geom_type} to LineString")


def st_cast_to_polygon(g: Geometry) -> Polygon:
    if isinstance(g, Polygon):
        return g
    from ..geometry import MultiPolygon
    if isinstance(g, MultiPolygon) and len(g.parts) == 1:
        return g.parts[0]
    raise TypeError(f"cannot cast {g.geom_type} to Polygon")


def st_cast_to_geometry(g: Geometry) -> Geometry:
    return g


def st_as_binary(g: Geometry) -> bytes:
    from ..geometry.wkb import to_wkb
    return to_wkb(g)


def st_geom_from_wkb(data: bytes) -> Geometry:
    from ..geometry.wkb import from_wkb
    return from_wkb(data)


def st_as_geojson(g: Geometry) -> str:
    import json
    from ..geometry.geojson import to_geojson
    return json.dumps(to_geojson(g))


def st_length_spheroid(g: Geometry) -> float:
    """Geodesic length of a line geometry on the WGS84 spheroid in
    meters: Vincenty distance summed over consecutive vertices of every
    part (the reference's ST_LengthSpheroid)."""
    if isinstance(g, (Point, MultiPoint)):
        return 0.0
    total = 0.0
    for coords in g.coords_list():
        for i in range(len(coords) - 1):
            total += st_distance_spheroid(Point(*coords[i]),
                                          Point(*coords[i + 1]))
    return float(total)


def _clip_halfplane(ring: np.ndarray, east: bool) -> np.ndarray | None:
    """Sutherland-Hodgman clip of a closed ring against the vertical
    line x=180, keeping x>=180 (east=True) or x<=180 (east=False)."""
    pts = ring[:-1] if len(ring) > 1 and np.array_equal(ring[0], ring[-1]) \
        else ring

    def inside(p):
        return p[0] >= 180.0 if east else p[0] <= 180.0

    out: list = []
    for i in range(len(pts)):
        a, b = pts[i - 1], pts[i]
        ain, bin_ = inside(a), inside(b)
        if bin_:
            if not ain:
                out.append(_cross_at_180(a, b))
            out.append(b)
        elif ain:
            out.append(_cross_at_180(a, b))
    if len(out) < 3:
        return None
    return np.asarray(out, np.float64)


def _cross_at_180(a, b):
    t = (180.0 - a[0]) / (b[0] - a[0])
    return (180.0, a[1] + t * (b[1] - a[1]))


def _split_line_at_180(coords: np.ndarray) -> list[np.ndarray]:
    """Cut a linestring's coordinates wherever a segment crosses x=180,
    duplicating the crossing point into both pieces."""
    pieces: list[list] = [[coords[0]]]
    for i in range(1, len(coords)):
        a, b = coords[i - 1], coords[i]
        if (a[0] - 180.0) * (b[0] - 180.0) < 0:
            x = _cross_at_180(a, b)
            pieces[-1].append(x)
            pieces.append([x])
        pieces[-1].append(b)
    return [np.asarray(p, np.float64) for p in pieces if len(p) >= 2]


def st_antimeridian_safe_geom(g: Geometry) -> Geometry:
    """Split a geometry that extends past the antimeridian into parts
    that each live inside [-180, 180] (the reference's
    st_antimeridianSafeGeom). Input uses the continuous-longitude
    convention (a bbox spanning the dateline runs e.g. 170..190); the
    overflow east of x=180 is clipped off and translated by -360, so
    area/length are preserved and point-in-polygon tests work in the
    standard domain."""
    env = g.envelope
    if env.is_empty or env.xmax <= 180.0:
        return g
    if isinstance(g, Point):
        return Point(g.x - 360.0, g.y) if g.x > 180.0 else g
    if isinstance(g, _Multi):
        parts: list[Geometry] = []
        for p in g.parts:
            safe = st_antimeridian_safe_geom(p)
            parts.extend(safe.parts if isinstance(safe, _Multi) else [safe])
        return parts[0] if len(parts) == 1 else type(g)(parts)
    if isinstance(g, LineString):
        pieces = _split_line_at_180(g.coords)
        lines = [LineString(p - [360.0, 0.0] if p[:, 0].max() > 180.0 else p)
                 for p in pieces]
        return lines[0] if len(lines) == 1 else MultiLineString(lines)
    if isinstance(g, Polygon):
        polys: list[Polygon] = []
        for east in (False, True):
            shell = _clip_halfplane(g.shell, east)
            if shell is None:
                continue
            holes = [h for h in (_clip_halfplane(h, east) for h in g.holes)
                     if h is not None]
            if east:
                shell = shell - [360.0, 0.0]
                holes = [h - [360.0, 0.0] for h in holes]
            polys.append(Polygon(shell, holes))
        if not polys:
            return g
        return polys[0] if len(polys) == 1 else MultiPolygon(polys)
    return g


def st_idl_safe_geom(g: Geometry) -> Geometry:
    """The reference's st_idlSafeGeom — an exact alias of
    st_antimeridianSafeGeom (GeometryProcessingFunctions.scala registers
    both names over one implementation). Kept as a named function so
    the alias contract is testable: the two must stay bit-identical."""
    return st_antimeridian_safe_geom(g)


def st_geohash(g: Geometry, prec: int = 25) -> str:
    """Base-32 geohash of the geometry at ``prec`` BITS of precision
    (the reference's st_geoHash; GeoHash.scala:25 takes bit precision).
    Non-point geometries hash their centroid. The rendered string
    carries ceil(prec/5) characters — the 5-bit base-32 granularity."""
    from ..geohash import encode
    c = g if isinstance(g, Point) else g.centroid
    chars = max(1, -(-int(prec) // 5))
    return encode(float(c.x), float(c.y), chars)


def st_geom_from_geohash(gh: str, prec: int | None = None) -> Polygon:
    """The geohash cell's bbox polygon (the reference's
    st_geomFromGeoHash); ``prec`` (BITS) truncates to a coarser cell."""
    from ..geohash import decode_bbox
    xmin, ymin, xmax, ymax = decode_bbox(
        str(gh), None if prec is None else int(prec))
    return Envelope(xmin, ymin, xmax, ymax).to_polygon()


# SQL scalar registry: SELECT-list ST_* calls resolve here (uppercased
# SQL name -> python fn taking (geometry_value, *literal_args)); the
# SQLSpatialAccessorFunctions / CastFunctions / OutputFunctions /
# GeometryProcessingFunctions surface of the reference
SQL_SCALARS = {
    "ST_X": lambda g: float(g.x),
    "ST_Y": lambda g: float(g.y),
    "ST_AREA": lambda g: g.area,
    "ST_LENGTH": lambda g: g.length,
    "ST_CENTROID": lambda g: g.centroid,
    "ST_ENVELOPE": lambda g: st_envelope(g),
    "ST_GEOMETRYTYPE": lambda g: g.geom_type,
    "ST_ASTEXT": lambda g: st_as_text(g),
    "ST_ASBINARY": st_as_binary,
    "ST_ASGEOJSON": st_as_geojson,
    "ST_CASTTOPOINT": st_cast_to_point,
    "ST_CASTTOLINESTRING": st_cast_to_linestring,
    "ST_CASTTOPOLYGON": st_cast_to_polygon,
    "ST_CASTTOGEOMETRY": st_cast_to_geometry,
    "ST_BUFFER": lambda g, d: st_buffer(g, float(d)),
    "ST_BUFFERPOINT": lambda g, m: st_buffer_point(g, float(m)),
    "ST_CONVEXHULL": lambda g: st_convex_hull(g),
    "ST_TRANSLATE": lambda g, dx, dy: st_translate(g, float(dx),
                                                   float(dy)),
    "ST_DISTANCE": lambda g, other: st_distance(g, other),
    "ST_DISTANCESPHERE": lambda g, o: st_distance_sphere(g, o),
    "ST_DISTANCESPHEROID": lambda g, o: st_distance_spheroid(g, o),
    "ST_CLOSESTPOINT": lambda g, o: st_closest_point(g, o),
    "ST_RELATE": lambda g, o: st_relate(g, o),
    "ST_RELATEBOOL": lambda g, o, p: st_relate_bool(g, o, str(p)),
    "ST_LENGTHSPHEROID": st_length_spheroid,
    "ST_ANTIMERIDIANSAFEGEOM": st_antimeridian_safe_geom,
    "ST_IDLSAFEGEOM": st_idl_safe_geom,
    "ST_GEOHASH": lambda g, prec=25: st_geohash(g, int(prec)),
    "ST_GEOMFROMGEOHASH": lambda gh, prec=None: st_geom_from_geohash(
        gh, None if prec is None else int(prec)),
    "ST_POINTN": lambda g, n: st_point_n(g, int(n)),
    "ST_EXTERIORRING": st_exterior_ring,
    "ST_NUMPOINTS": st_num_points,
    # all-literal constructors: the parser passes '__const__' as the
    # column and the engine broadcasts the constructed value per row
    "ST_MAKEBBOX": lambda *args: st_make_bbox(*(float(a) for a in args)),
    "ST_MAKEPOLYGON": st_make_polygon,
}


def st_convex_hull(g: Geometry) -> Geometry:
    """Monotone-chain convex hull of all vertices."""
    return convex_hull_points(np.vstack(g.coords_list()))


def convex_hull_points(pts: np.ndarray) -> Geometry:
    """Monotone-chain convex hull of an (n, 2) coordinate array — the
    raw form the SQL ConvexHull aggregate pools group members into."""
    pts = np.unique(np.asarray(pts, np.float64), axis=0)
    if len(pts) == 1:
        return Point(*pts[0])
    if len(pts) == 2:
        return LineString(pts)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        out: list[np.ndarray] = []
        for p in points:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 3:
        return LineString(hull)
    return Polygon(hull)


def st_closest_point(a: Geometry, b: Point) -> Point:
    """Closest point on a to point b (per ring/part — no phantom
    segments bridging separate components)."""
    if isinstance(a, Point):
        return a
    best = None
    best_d2 = np.inf
    for coords in a.coords_list():
        if len(coords) < 2:
            if len(coords) == 1:
                d2 = (b.x - coords[0, 0]) ** 2 + (b.y - coords[0, 1]) ** 2
                if d2 < best_d2:
                    best_d2, best = d2, Point(*coords[0])
            continue
        x0, y0 = coords[:-1, 0], coords[:-1, 1]
        dx, dy = np.diff(coords[:, 0]), np.diff(coords[:, 1])
        len2 = dx * dx + dy * dy
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((b.x - x0) * dx + (b.y - y0) * dy) / len2
        t = np.where(len2 == 0, 0.0, np.clip(t, 0, 1))
        cx, cy = x0 + t * dx, y0 + t * dy
        d2 = (b.x - cx) ** 2 + (b.y - cy) ** 2
        i = int(np.argmin(d2))
        if d2[i] < best_d2:
            best_d2, best = float(d2[i]), Point(cx[i], cy[i])
    return best


def st_translate(g: Geometry, dx: float, dy: float) -> Geometry:
    import copy
    out = copy.deepcopy(g)

    def shift(geom):
        if isinstance(geom, Point):
            geom.x += dx
            geom.y += dy
        elif isinstance(geom, LineString):
            geom.coords = geom.coords + np.array([dx, dy])
        elif isinstance(geom, Polygon):
            geom.shell = geom.shell + np.array([dx, dy])
            geom.holes = [h + np.array([dx, dy]) for h in geom.holes]
        else:
            for p in geom.parts:
                shift(p)
    shift(out)
    return out


# -- vectorized column forms ----------------------------------------------

def contains_points(g: Geometry, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized geometry-contains-points (the ST_Contains hot form)."""
    if hasattr(g, "contains_points"):
        return g.contains_points(x, y)
    env = g.envelope
    out = (x >= env.xmin) & (x <= env.xmax) & (y >= env.ymin) & (y <= env.ymax)
    for i in np.flatnonzero(out):
        out[i] = g.contains(Point(x[i], y[i]))
    return out


def distance_points(g: Geometry, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized distance from geometry to each point (degrees).
    Each ring/part measures separately — vstacking them would create
    phantom bridging segments."""
    if isinstance(g, Point):
        return np.hypot(x - g.x, y - g.y)
    d2 = np.full(np.shape(np.asarray(x, np.float64)), np.inf)
    for coords in g.coords_list():
        if len(coords) == 0:
            continue
        if len(coords) == 1:
            d2 = np.minimum(d2, (x - coords[0, 0]) ** 2 + (y - coords[0, 1]) ** 2)
        else:
            d2 = np.minimum(d2, _point_segments_dist2(x, y, coords))
    d = np.sqrt(d2)
    if hasattr(g, "contains_points"):
        d = np.where(g.contains_points(x, y), 0.0, d)
    return d
