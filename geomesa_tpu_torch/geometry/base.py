"""Numpy-backed geometry classes with exact float64 predicates.

The slice of the geometry model that point schemas need: envelopes for
planning, points for the feature column, and polygons (shell + holes)
and multipolygons with a vectorized boundary-inclusive point-in-polygon
test for the exact INTERSECTS/WITHIN/DISJOINT residual, and the
polygon-polygon ``intersects`` that the planner's geometry extraction
uses. Coordinates are (n, 2) float64 arrays.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["Envelope", "Geometry", "Point", "Polygon", "MultiPolygon",
           "WHOLE_WORLD"]


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

    def intersection(self, other: "Envelope") -> "Envelope":
        return Envelope(max(self.xmin, other.xmin), max(self.ymin, other.ymin),
                        min(self.xmax, other.xmax), min(self.ymax, other.ymax))

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


def _ring_contains(ring: np.ndarray, x, y):
    """Crossing-number point-in-ring test; boundary counts as inside.
    ring: (n, 2) closed; x/y scalars or arrays."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x0, y0 = ring[:-1, 0], ring[:-1, 1]
    x1, y1 = ring[1:, 0], ring[1:, 1]
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
        raise NotImplementedError

    def intersects(self, other: "Geometry") -> bool:
        """Exact f64 intersection of two (multi)polygons."""
        if not self.envelope.intersects(other.envelope):
            return False
        return any(pa.envelope.intersects(pb.envelope)
                   and _polygons_intersect(pa, pb)
                   for pa in _parts_of(self) for pb in _parts_of(other))

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


class MultiPolygon(Geometry):
    geom_type = "MultiPolygon"

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

    def contains_points(self, x, y):
        out = np.zeros(np.shape(np.asarray(x)), dtype=bool)
        for p in self.parts:
            out |= p.contains_points(x, y)
        return out


def _parts_of(g: Geometry) -> list[Geometry]:
    return list(g.parts) if isinstance(g, MultiPolygon) else [g]


def _polygons_intersect(a: Geometry, b: Geometry) -> bool:
    if not (isinstance(a, Polygon) and isinstance(b, Polygon)):
        raise TypeError(f"unsupported intersects: {a.geom_type}/{b.geom_type}")
    if bool(a.contains_points(b.shell[:, 0], b.shell[:, 1]).any()):
        return True
    if bool(b.contains_points(a.shell[:, 0], a.shell[:, 1]).any()):
        return True
    # all rings matter: a hole boundary of one can cross the other
    return any(_segseg_any_intersection(ra, rb)
               for ra in a.coords_list() for rb in b.coords_list())


WHOLE_WORLD = Polygon(np.array([[-180.0, -90.0], [180.0, -90.0],
                                [180.0, 90.0], [-180.0, 90.0],
                                [-180.0, -90.0]]))
