"""Numpy-backed geometry classes with exact float64 predicates.

A lean replacement for the slice of JTS the reference actually uses in
its hot paths (FilterHelper geometry extraction, residual predicate
evaluation, density/knn/tube processes): envelopes, point-in-polygon,
intersects/contains/within/disjoint, distance, centroid, area, length,
convex hull, simple buffering for DWithin.

Coordinates are (n, 2) float64 arrays. Polygons follow the shell+holes
model; no topology validation beyond ring closure (matching lenient JTS
usage in the reference).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["Envelope", "Geometry", "Point", "LineString", "Polygon",
           "MultiPoint", "MultiLineString", "MultiPolygon",
           "GeometryCollection", "WHOLE_WORLD"]


class Envelope:
    """Axis-aligned bounding box [xmin, xmax] x [ymin, ymax]."""

    __slots__ = ("xmin", "ymin", "xmax", "ymax")

    def __init__(self, xmin: float, ymin: float, xmax: float, ymax: float):
        self.xmin = float(xmin)
        self.ymin = float(ymin)
        self.xmax = float(xmax)
        self.ymax = float(ymax)

    @classmethod
    def empty(cls) -> "Envelope":
        return cls(np.inf, np.inf, -np.inf, -np.inf)

    @property
    def is_empty(self) -> bool:
        return self.xmin > self.xmax or self.ymin > self.ymax

    def expand(self, other: "Envelope") -> "Envelope":
        return Envelope(min(self.xmin, other.xmin), min(self.ymin, other.ymin),
                        max(self.xmax, other.xmax), max(self.ymax, other.ymax))

    def intersects(self, other: "Envelope") -> bool:
        return not (self.xmax < other.xmin or other.xmax < self.xmin
                    or self.ymax < other.ymin or other.ymax < self.ymin)

    def contains_env(self, other: "Envelope") -> bool:
        return (self.xmin <= other.xmin and self.xmax >= other.xmax
                and self.ymin <= other.ymin and self.ymax >= other.ymax)

    def contains_point(self, x: float, y: float) -> bool:
        return self.xmin <= x <= self.xmax and self.ymin <= y <= self.ymax

    def intersection(self, other: "Envelope") -> "Envelope":
        return Envelope(max(self.xmin, other.xmin), max(self.ymin, other.ymin),
                        min(self.xmax, other.xmax), min(self.ymax, other.ymax))

    def buffer(self, d: float) -> "Envelope":
        return Envelope(self.xmin - d, self.ymin - d, self.xmax + d, self.ymax + d)

    def to_polygon(self) -> "Polygon":
        return Polygon(np.array([[self.xmin, self.ymin], [self.xmax, self.ymin],
                                 [self.xmax, self.ymax], [self.xmin, self.ymax],
                                 [self.xmin, self.ymin]]))

    def as_tuple(self) -> tuple[float, float, float, float]:
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    def __eq__(self, o) -> bool:
        return (isinstance(o, Envelope) and self.as_tuple() == o.as_tuple())

    def __hash__(self) -> int:
        return hash(self.as_tuple())

    def __repr__(self) -> str:
        return f"Envelope({self.xmin}, {self.ymin}, {self.xmax}, {self.ymax})"


# -- low-level predicates (exact f64, vectorized) --------------------------

def _ring_contains(ring: np.ndarray, x, y):
    """Crossing-number point-in-ring test; boundary counts as inside.
    ring: (n, 2) closed; x/y scalars or arrays."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x0, y0 = ring[:-1, 0], ring[:-1, 1]
    x1, y1 = ring[1:, 0], ring[1:, 1]
    # boundary test: point on any segment
    on = _on_segment(x0, y0, x1, y1, x[..., None], y[..., None]).any(axis=-1)
    cond = (y0 > y[..., None]) != (y1 > y[..., None])
    with np.errstate(divide="ignore", invalid="ignore"):
        xcross = x0 + (y[..., None] - y0) * (x1 - x0) / (y1 - y0)
    inside = (cond & (x[..., None] < xcross)).sum(axis=-1) % 2 == 1
    return inside | on


def _on_segment(x0, y0, x1, y1, px, py):
    """True where (px,py) lies exactly on segment (x0,y0)-(x1,y1)."""
    cross = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    within_x = (np.minimum(x0, x1) <= px) & (px <= np.maximum(x0, x1))
    within_y = (np.minimum(y0, y1) <= py) & (py <= np.maximum(y0, y1))
    return (cross == 0) & within_x & within_y


def _segments_intersect(a0, a1, b0, b1) -> bool:
    """Exact segment-pair intersection (scalar, orientation-based)."""
    def orient(p, q, r):
        return np.sign((q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0]))
    o1, o2 = orient(a0, a1, b0), orient(a0, a1, b1)
    o3, o4 = orient(b0, b1, a0), orient(b0, b1, a1)
    if o1 != o2 and o3 != o4:
        return True
    def between(p, q, r):
        return (min(p[0], q[0]) <= r[0] <= max(p[0], q[0])
                and min(p[1], q[1]) <= r[1] <= max(p[1], q[1]))
    return ((o1 == 0 and between(a0, a1, b0)) or (o2 == 0 and between(a0, a1, b1))
            or (o3 == 0 and between(b0, b1, a0)) or (o4 == 0 and between(b0, b1, a1)))


def _segseg_any_intersection(ca: np.ndarray, cb: np.ndarray) -> bool:
    """Vectorized: does any segment of polyline ca intersect any of cb?"""
    if len(ca) < 2 or len(cb) < 2:
        return False
    a0 = ca[:-1][:, None, :]  # (na, 1, 2)
    a1 = ca[1:][:, None, :]
    b0 = cb[:-1][None, :, :]  # (1, nb, 2)
    b1 = cb[1:][None, :, :]

    def orient(p, q, r):
        return np.sign((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
                       - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))
    o1 = orient(a0, a1, b0)
    o2 = orient(a0, a1, b1)
    o3 = orient(b0, b1, a0)
    o4 = orient(b0, b1, a1)
    proper = (o1 != o2) & (o3 != o4)

    def between(p, q, r):
        return ((np.minimum(p[..., 0], q[..., 0]) <= r[..., 0])
                & (r[..., 0] <= np.maximum(p[..., 0], q[..., 0]))
                & (np.minimum(p[..., 1], q[..., 1]) <= r[..., 1])
                & (r[..., 1] <= np.maximum(p[..., 1], q[..., 1])))
    touch = (((o1 == 0) & between(a0, a1, b0)) | ((o2 == 0) & between(a0, a1, b1))
             | ((o3 == 0) & between(b0, b1, a0)) | ((o4 == 0) & between(b0, b1, a1)))
    return bool((proper | touch).any())


def _point_segments_dist2(px, py, coords: np.ndarray):
    """Min squared distance from point(s) to polyline segments."""
    x0, y0 = coords[:-1, 0], coords[:-1, 1]
    dx, dy = np.diff(coords[:, 0]), np.diff(coords[:, 1])
    len2 = dx * dx + dy * dy
    px = np.asarray(px, dtype=np.float64)[..., None]
    py = np.asarray(py, dtype=np.float64)[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((px - x0) * dx + (py - y0) * dy) / len2
    t = np.where(len2 == 0, 0.0, np.clip(t, 0.0, 1.0))
    cx, cy = x0 + t * dx, y0 + t * dy
    d2 = (px - cx) ** 2 + (py - cy) ** 2
    return d2.min(axis=-1)


# -- geometry classes ------------------------------------------------------

class Geometry:
    """Base geometry; subclasses hold numpy coordinate arrays."""

    geom_type: str = "Geometry"

    @property
    def envelope(self) -> Envelope:
        raise NotImplementedError

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    def coords_list(self) -> list[np.ndarray]:
        """All constituent coordinate arrays (for packed buffers)."""
        raise NotImplementedError

    # spatial predicates (exact, host f64)
    def intersects(self, other: "Geometry") -> bool:
        if not self.envelope.intersects(other.envelope):
            return False
        return _intersects(self, other)

    def disjoint(self, other: "Geometry") -> bool:
        return not self.intersects(other)

    def contains(self, other: "Geometry") -> bool:
        if not self.envelope.contains_env(other.envelope):
            return False
        return _contains(self, other)

    def within(self, other: "Geometry") -> bool:
        return other.contains(self)

    def distance(self, other: "Geometry") -> float:
        return _distance(self, other)

    def dwithin(self, other: "Geometry", d: float) -> bool:
        if not self.envelope.buffer(d).intersects(other.envelope):
            return False
        return self.distance(other) <= d

    @property
    def area(self) -> float:
        return 0.0

    @property
    def length(self) -> float:
        return 0.0

    @property
    def centroid(self) -> "Point":
        env = self.envelope
        return Point((env.xmin + env.xmax) / 2, (env.ymin + env.ymax) / 2)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Geometry) or self.geom_type != other.geom_type:
            return False
        a, b = self.coords_list(), other.coords_list()
        return (len(a) == len(b)
                and all(x.shape == y.shape and bool(np.all(x == y))
                        for x, y in zip(a, b)))

    def __hash__(self) -> int:
        return hash((self.geom_type,
                     tuple(tuple(map(tuple, c)) for c in self.coords_list())))

    def __repr__(self) -> str:
        from .wkt import to_wkt
        return to_wkt(self)


class Point(Geometry):
    geom_type = "Point"

    def __init__(self, x: float, y: float):
        self.x = float(x)
        self.y = float(y)

    @property
    def envelope(self) -> Envelope:
        return Envelope(self.x, self.y, self.x, self.y)

    @property
    def is_empty(self) -> bool:
        return np.isnan(self.x)

    def coords_list(self) -> list[np.ndarray]:
        return [np.array([[self.x, self.y]])]

    @property
    def centroid(self) -> "Point":
        return self


class LineString(Geometry):
    geom_type = "LineString"

    def __init__(self, coords):
        self.coords = np.asarray(coords, dtype=np.float64).reshape(-1, 2)

    @functools.cached_property
    def envelope(self) -> Envelope:
        # cached: coordinates are treated as immutable
        if len(self.coords) == 0:
            return Envelope.empty()
        return Envelope(self.coords[:, 0].min(), self.coords[:, 1].min(),
                        self.coords[:, 0].max(), self.coords[:, 1].max())

    @property
    def is_empty(self) -> bool:
        return len(self.coords) == 0

    def coords_list(self) -> list[np.ndarray]:
        return [self.coords]

    @property
    def length(self) -> float:
        if len(self.coords) < 2:
            return 0.0
        return float(np.sqrt((np.diff(self.coords, axis=0) ** 2).sum(axis=1)).sum())

    @property
    def centroid(self) -> Point:
        if len(self.coords) == 1:
            return Point(*self.coords[0])
        seg = np.diff(self.coords, axis=0)
        w = np.sqrt((seg ** 2).sum(axis=1))
        mid = (self.coords[:-1] + self.coords[1:]) / 2
        if w.sum() == 0:
            return Point(*self.coords.mean(axis=0))
        c = (mid * w[:, None]).sum(axis=0) / w.sum()
        return Point(*c)


class Polygon(Geometry):
    geom_type = "Polygon"

    def __init__(self, shell, holes=None):
        shell = np.asarray(shell, dtype=np.float64).reshape(-1, 2)
        if len(shell) > 0 and not np.array_equal(shell[0], shell[-1]):
            shell = np.vstack([shell, shell[:1]])  # close the ring
        self.shell = shell
        self.holes = [np.asarray(h, dtype=np.float64).reshape(-1, 2)
                      for h in (holes or [])]
        self.holes = [np.vstack([h, h[:1]]) if len(h) > 0
                      and not np.array_equal(h[0], h[-1]) else h
                      for h in self.holes]

    @functools.cached_property
    def envelope(self) -> Envelope:
        # cached: the shell is treated as immutable
        if len(self.shell) == 0:
            return Envelope.empty()
        return Envelope(self.shell[:, 0].min(), self.shell[:, 1].min(),
                        self.shell[:, 0].max(), self.shell[:, 1].max())

    @property
    def is_empty(self) -> bool:
        return len(self.shell) == 0

    def coords_list(self) -> list[np.ndarray]:
        return [self.shell] + self.holes

    def contains_points(self, x, y):
        """Vectorized point-in-polygon (boundary-inclusive)."""
        inside = _ring_contains(self.shell, x, y)
        for h in self.holes:
            on_boundary = _on_segment(h[:-1, 0], h[:-1, 1], h[1:, 0], h[1:, 1],
                                      np.asarray(x, np.float64)[..., None],
                                      np.asarray(y, np.float64)[..., None]).any(axis=-1)
            inside &= ~(_ring_contains(h, x, y) & ~on_boundary)
        return inside

    @property
    def area(self) -> float:
        def ring_area(r):
            if len(r) < 3:
                return 0.0
            x, y = r[:, 0], r[:, 1]
            return 0.5 * float(np.dot(x[:-1], y[1:]) - np.dot(x[1:], y[:-1]))
        a = abs(ring_area(self.shell))
        for h in self.holes:
            a -= abs(ring_area(h))
        return a

    @property
    def length(self) -> float:
        return float(sum(np.sqrt((np.diff(r, axis=0) ** 2).sum(axis=1)).sum()
                         for r in self.coords_list()))

    @property
    def centroid(self) -> Point:
        r = self.shell
        if len(r) < 4:
            return Point(*r[:max(len(r) - 1, 1)].mean(axis=0))
        x, y = r[:-1, 0], r[:-1, 1]
        x1, y1 = r[1:, 0], r[1:, 1]
        cross = x * y1 - x1 * y
        a = cross.sum() / 2.0
        if a == 0:
            return Point(*r[:-1].mean(axis=0))
        cx = ((x + x1) * cross).sum() / (6 * a)
        cy = ((y + y1) * cross).sum() / (6 * a)
        return Point(cx, cy)


class _Multi(Geometry):
    part_type: type = Geometry

    def __init__(self, parts):
        self.parts = list(parts)

    @functools.cached_property
    def envelope(self) -> Envelope:
        # cached: parts are treated as immutable
        env = Envelope.empty()
        for p in self.parts:
            env = env.expand(p.envelope)
        return env

    @property
    def is_empty(self) -> bool:
        return all(p.is_empty for p in self.parts)

    def coords_list(self) -> list[np.ndarray]:
        return [c for p in self.parts for c in p.coords_list()]

    @property
    def area(self) -> float:
        return float(sum(p.area for p in self.parts))

    @property
    def length(self) -> float:
        return float(sum(p.length for p in self.parts))


class MultiPoint(_Multi):
    geom_type = "MultiPoint"
    part_type = Point


class MultiLineString(_Multi):
    geom_type = "MultiLineString"
    part_type = LineString


class MultiPolygon(_Multi):
    geom_type = "MultiPolygon"
    part_type = Polygon

    def contains_points(self, x, y):
        out = np.zeros(np.shape(np.asarray(x)), dtype=bool)
        for p in self.parts:
            out |= p.contains_points(x, y)
        return out


class GeometryCollection(_Multi):
    geom_type = "GeometryCollection"


WHOLE_WORLD = Polygon(np.array([[-180.0, -90.0], [180.0, -90.0],
                                [180.0, 90.0], [-180.0, 90.0],
                                [-180.0, -90.0]]))


# -- dispatching binary predicates ----------------------------------------

def _parts_of(g: Geometry) -> list[Geometry]:
    """Recursively flatten Multi*/GeometryCollection to simple parts."""
    if isinstance(g, _Multi):
        return [s for p in g.parts for s in _parts_of(p)]
    return [g]


def _intersects(a: Geometry, b: Geometry) -> bool:
    for pa in _parts_of(a):
        for pb in _parts_of(b):
            if pa.envelope.intersects(pb.envelope) and _intersects_simple(pa, pb):
                return True
    return False


def _intersects_simple(a: Geometry, b: Geometry) -> bool:
    # order by complexity: Point < LineString < Polygon
    rank = {"Point": 0, "LineString": 1, "Polygon": 2}
    if rank.get(b.geom_type, 3) < rank.get(a.geom_type, 3):
        a, b = b, a
    if isinstance(a, Point):
        if isinstance(b, Point):
            return a.x == b.x and a.y == b.y
        if isinstance(b, LineString):
            return bool(_point_segments_dist2(a.x, a.y, b.coords) == 0)
        if isinstance(b, Polygon):
            return bool(b.contains_points(a.x, a.y))
    if isinstance(a, LineString):
        if isinstance(b, LineString):
            return _segseg_any_intersection(a.coords, b.coords)
        if isinstance(b, Polygon):
            if bool(b.contains_points(a.coords[:, 0], a.coords[:, 1]).any()):
                return True
            return any(_segseg_any_intersection(a.coords, r)
                       for r in b.coords_list())
    if isinstance(a, Polygon) and isinstance(b, Polygon):
        if bool(a.contains_points(b.shell[:, 0], b.shell[:, 1]).any()):
            return True
        if bool(b.contains_points(a.shell[:, 0], a.shell[:, 1]).any()):
            return True
        # all rings matter: a hole boundary of one can cross the other
        return any(_segseg_any_intersection(ra, rb)
                   for ra in a.coords_list() for rb in b.coords_list())
    raise TypeError(f"unsupported intersects: {a.geom_type}/{b.geom_type}")


def _contains(a: Geometry, b: Geometry) -> bool:
    """a contains b (boundary-inclusive 'covers' semantics for points;
    the residual-filter layer applies strict JTS contains where needed)."""
    if isinstance(a, (Polygon, MultiPolygon)):
        pts = np.vstack(b.coords_list())
        if not bool(a.contains_points(pts[:, 0], pts[:, 1]).all()):
            return False
        # vertices inside; for lines/polys also require no boundary crossing
        if isinstance(b, (Point, MultiPoint)):
            return True
        for ring in ([r for p in _parts_of(a) for r in p.coords_list()]):
            for cb in b.coords_list():
                if _segseg_any_intersection(ring, cb):
                    # touching is allowed only if all of b stays inside;
                    # approximate via midpoint sampling of b's segments
                    mids = (cb[:-1] + cb[1:]) / 2
                    if not bool(a.contains_points(mids[:, 0], mids[:, 1]).all()):
                        return False
        return True
    if isinstance(a, Point):
        return isinstance(b, Point) and a.x == b.x and a.y == b.y
    if isinstance(a, LineString):
        pts = np.vstack(b.coords_list())
        return bool((_point_segments_dist2(pts[:, 0], pts[:, 1], a.coords) == 0).all())
    if isinstance(a, _Multi):
        return all(any(pa.contains(pb) for pa in a.parts) for pb in _parts_of(b))
    raise TypeError(f"unsupported contains: {a.geom_type}/{b.geom_type}")


def _distance(a: Geometry, b: Geometry) -> float:
    if a.intersects(b):
        return 0.0
    best = np.inf
    for pa in _parts_of(a):
        for pb in _parts_of(b):
            best = min(best, _distance_simple(pa, pb))
    return float(best)


def _distance_simple(a: Geometry, b: Geometry) -> float:
    def as_coords(g):
        return np.vstack(g.coords_list())
    if isinstance(a, Point) and isinstance(b, Point):
        return float(np.hypot(a.x - b.x, a.y - b.y))
    if isinstance(a, Point):
        return float(np.sqrt(_point_segments_dist2(a.x, a.y, as_coords(b))))
    if isinstance(b, Point):
        return float(np.sqrt(_point_segments_dist2(b.x, b.y, as_coords(a))))
    ca, cb = as_coords(a), as_coords(b)
    d1 = np.sqrt(_point_segments_dist2(ca[:, 0], ca[:, 1], cb)).min()
    d2 = np.sqrt(_point_segments_dist2(cb[:, 0], cb[:, 1], ca)).min()
    return float(min(d1, d2))
