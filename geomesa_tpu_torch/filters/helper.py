"""Filter analysis: extract index-consumable values from a Filter AST.

Mirrors FilterHelper (geomesa-filter/.../FilterHelper.scala):

- ``extract_geometries`` (:201): AND intersects extracted geometries,
  OR unions them; DWithin buffers by its distance in degrees
  (``dwithin_degrees``); geometries crossing the antimeridian split
  IDL-safe; results clip to the world.
- ``extract_intervals`` (:267): date bounds in epoch millis.
- ``extract_attribute_bounds`` (:318): typed bounds for one attribute,
  the attribute index's ranges.
- ``like_vocab_mask``: the one source of LIKE semantics, for the host
  evaluator and the device residual compiler alike.

Bounds carry inclusivity; ``FilterValues.disjoint`` marks provably-empty
extractions (e.g. ANDed non-overlapping boxes) so planners can return
empty plans without scanning.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import numpy as np

from ..geometry import Envelope, Geometry, Polygon
from ..geometry.base import WHOLE_WORLD, _Multi
from . import ast

__all__ = ["Bound", "Bounds", "FilterValues", "extract_geometries",
           "extract_intervals", "extract_attribute_bounds", "is_box",
           "coerce_literals",
           "like_vocab_mask", "to_millis", "distance_degrees",
           "dwithin_degrees", "METERS_MULTIPLIERS"]

# ECQL distance units -> meters (FilterHelper.visitDwithin:93-101)
METERS_MULTIPLIERS = {
    "meters": 1.0,
    "kilometers": 1000.0,
    "feet": 0.3048,
    "statute miles": 1609.347,
    "nautical miles": 1852.0,
}

_WGS84_A = 6378137.0
_WGS84_E2 = 0.00669437999014


def distance_degrees(geom: Geometry, meters: float) -> float:
    """Meters -> degrees: the widest eastward arc at the geometry's
    envelope corners (GeometryUtils.distanceDegrees, GeometryUtils.scala:25-39)."""
    env = geom.envelope
    best = 0.0
    for lat in (env.ymin, env.ymax):
        phi = math.radians(lat)
        # prime-vertical radius of curvature
        n = _WGS84_A / math.sqrt(1 - _WGS84_E2 * math.sin(phi) ** 2)
        circ = n * math.cos(phi)
        if circ <= 0:
            continue
        best = max(best, math.degrees(meters / circ))
    return best if best > 0 else math.degrees(meters / _WGS84_A)


def dwithin_degrees(geom: Geometry, distance: float, units: str) -> float:
    """DWithin distance -> planar degrees. ECQL units convert via
    meters (an unknown unit counts as meters); 'degrees' passes through
    (the Spark-SQL ST_DWithin semantics: CRS units)."""
    if units == "degrees":
        return float(distance)
    return distance_degrees(geom,
                            distance * METERS_MULTIPLIERS.get(units, 1.0))


def to_millis(v) -> int:
    """Interval/bound value -> epoch millis: ECQL quoted date strings
    arrive as raw strings (only bare datetime tokens parse in the lexer)."""
    if isinstance(v, str):
        return int(np.datetime64(v.strip().rstrip("Z").replace(" ", "T"),
                                 "ms").astype(np.int64))
    return int(v)


def like_vocab_mask(pattern: str, case_sensitive: bool,
                    vocab: np.ndarray) -> np.ndarray:
    """SQL LIKE pattern -> bool mask over a string vocab. The single
    source of LIKE semantics for the host evaluator and the device
    residual compiler (their parity is a correctness contract)."""
    pat = re.escape(pattern).replace("%", ".*").replace("_", ".")
    rx = re.compile(f"^{pat}$", 0 if case_sensitive else re.IGNORECASE)
    return np.array([bool(rx.match(s)) for s in vocab.astype(str)],
                    dtype=bool)


@dataclasses.dataclass(frozen=True)
class Bound:
    """One side of an interval; value None = unbounded."""
    value: Any
    inclusive: bool

    @staticmethod
    def unbounded() -> "Bound":
        return Bound(None, True)

    @property
    def is_bounded(self) -> bool:
        return self.value is not None


@dataclasses.dataclass(frozen=True)
class Bounds:
    lower: Bound
    upper: Bound

    @property
    def is_equality(self) -> bool:
        """One value, both ends inclusive (an attribute partition's
        name)."""
        return (self.lower.is_bounded and self.lower.value == self.upper.value
                and self.lower.inclusive and self.upper.inclusive)

    @property
    def is_bounded(self) -> bool:
        return self.lower.is_bounded or self.upper.is_bounded

    def intersection(self, other: "Bounds") -> "Bounds | None":
        lo = _lower_max(self.lower, other.lower)
        hi = _upper_min(self.upper, other.upper)
        if lo.is_bounded and hi.is_bounded:
            if lo.value > hi.value:
                return None
            if lo.value == hi.value and not (lo.inclusive and hi.inclusive):
                return None
        return Bounds(lo, hi)

    def union_if_overlapping(self, other: "Bounds") -> "Bounds | None":
        """Merge if the two intervals overlap or touch, else None."""
        if self._disjoint_from(other):
            return None
        return Bounds(_lower_min(self.lower, other.lower),
                      _upper_max(self.upper, other.upper))

    def _disjoint_from(self, other: "Bounds") -> bool:
        for a, b in ((self, other), (other, self)):
            if a.upper.is_bounded and b.lower.is_bounded:
                if a.upper.value < b.lower.value:
                    return True
                if (a.upper.value == b.lower.value
                        and not a.upper.inclusive and not b.lower.inclusive):
                    return True
        return False


# A lower bound of None means -inf; an upper bound of None means +inf.
# Intersections tighten (finite wins, inclusivity ANDs); unions loosen
# (unbounded wins, inclusivity ORs).

def _lower_max(a: Bound, b: Bound) -> Bound:
    if not a.is_bounded:
        return b
    if not b.is_bounded:
        return a
    if a.value != b.value:
        return a if a.value > b.value else b
    return Bound(a.value, a.inclusive and b.inclusive)


def _upper_min(a: Bound, b: Bound) -> Bound:
    if not a.is_bounded:
        return b
    if not b.is_bounded:
        return a
    if a.value != b.value:
        return a if a.value < b.value else b
    return Bound(a.value, a.inclusive and b.inclusive)


def _lower_min(a: Bound, b: Bound) -> Bound:
    if not a.is_bounded or not b.is_bounded:
        return Bound.unbounded()
    if a.value != b.value:
        return a if a.value < b.value else b
    return Bound(a.value, a.inclusive or b.inclusive)


def _upper_max(a: Bound, b: Bound) -> Bound:
    if not a.is_bounded or not b.is_bounded:
        return Bound.unbounded()
    if a.value != b.value:
        return a if a.value > b.value else b
    return Bound(a.value, a.inclusive or b.inclusive)


@dataclasses.dataclass
class FilterValues:
    """Extraction result: OR'd values + flags (FilterValues.scala)."""
    values: list
    precise: bool = True
    disjoint: bool = False

    @staticmethod
    def empty() -> "FilterValues":
        return FilterValues([])

    @staticmethod
    def make_disjoint() -> "FilterValues":
        return FilterValues([], disjoint=True)

    @property
    def is_empty(self) -> bool:
        return not self.values and not self.disjoint

    def __bool__(self) -> bool:
        return bool(self.values) or self.disjoint

    def __iter__(self):
        return iter(self.values)

    def __len__(self) -> int:
        return len(self.values)


# -- geometry extraction ---------------------------------------------------


def is_box(g: Geometry) -> bool:
    """An axis-aligned rectangle: a hole-free polygon whose closed
    5-vertex shell takes exactly two x and two y values."""
    if not isinstance(g, Polygon) or g.holes or len(g.shell) != 5:
        return False
    return (len(set(g.shell[:, 0].tolist())) == 2
            and len(set(g.shell[:, 1].tolist())) == 2)


def _split_idl(g: Geometry) -> list[Geometry]:
    """Split geometries whose longitudes run past +/-180 into wrapped
    parts (getInternationalDateLineSafeGeometry analog): the x interval
    is treated as an arc on the circle. Only envelope-level splitting is
    needed for planning; exact predicates run downstream."""
    env = g.envelope
    if env.xmin >= -180 and env.xmax <= 180:
        return [g]
    span = env.xmax - env.xmin
    if span >= 360:
        return [Envelope(-180.0, env.ymin, 180.0, env.ymax).to_polygon()]
    # rotate the start into [-180, 180)
    start = ((env.xmin + 180.0) % 360.0) - 180.0
    end = start + span
    if end <= 180:
        return [Envelope(start, env.ymin, end, env.ymax).to_polygon()]
    return [Envelope(start, env.ymin, 180.0, env.ymax).to_polygon(),
            Envelope(-180.0, env.ymin, end - 360.0, env.ymax).to_polygon()]


def _clip_world(g: Geometry) -> Geometry | None:
    env = g.envelope
    world = WHOLE_WORLD.envelope
    if world.contains_env(env):
        return g
    clipped = env.intersection(world)
    if clipped.is_empty:
        return None
    return clipped.to_polygon()


def _geom_intersection(a: Geometry, b: Geometry) -> Geometry | None:
    """AND-combination of two extracted geometries. Exact when either is
    an axis-aligned envelope box; otherwise conservatively the one with
    the smaller envelope, clipped to the other's envelope box (a
    superset of the true intersection: safe for planning, and the exact
    geometry residual keeps the result exact)."""
    if not a.envelope.intersects(b.envelope):
        return None
    ea, eb = a.envelope, b.envelope
    a_is_box, b_is_box = is_box(a), is_box(b)
    if a_is_box and b_is_box:
        e = ea.intersection(eb)
        return None if e.is_empty else e.to_polygon()
    if a_is_box:
        return b if ea.contains_env(eb) else eb.intersection(ea).to_polygon()
    if b_is_box:
        return a if eb.contains_env(ea) else ea.intersection(eb).to_polygon()
    if not a.intersects(b):
        return None
    # both complex: keep the smaller-envelope one (conservative)
    area_a = (ea.xmax - ea.xmin) * (ea.ymax - ea.ymin)
    area_b = (eb.xmax - eb.xmin) * (eb.ymax - eb.ymin)
    return a if area_a <= area_b else b


def extract_geometries(f: ast.Filter, attribute: str | None) -> FilterValues:
    """Extract query geometries for `attribute` (FilterHelper.scala:201)."""
    out = _extract_geoms(f, attribute)
    clipped = []
    for g in out.values:
        c = _clip_world(g)
        if c is not None:
            clipped.append(c)
    if out.values and not clipped:
        return FilterValues.make_disjoint()
    return FilterValues(clipped, out.precise, out.disjoint)


def _extract_geoms(f: ast.Filter, attribute: str | None) -> FilterValues:
    if isinstance(f, ast.Or):
        vals: list[Geometry] = []
        for c in f.children:
            child = _extract_geoms(c, attribute)
            if child.is_empty and not child.disjoint:
                # a child with no spatial constraint matches everywhere:
                # the OR extraction is unbounded
                return FilterValues.empty()
            vals.extend(child.values)
        if not vals:
            return FilterValues.make_disjoint()
        return FilterValues(vals)
    if isinstance(f, ast.And):
        children = [c for c in (
            _extract_geoms(c, attribute) for c in f.children)
            if not c.is_empty or c.disjoint]
        if not children:
            return FilterValues.empty()
        if any(c.disjoint for c in children):
            return FilterValues.make_disjoint()
        acc = children[0].values
        for c in children[1:]:
            new: list[Geometry] = []
            for a in acc:
                for b in c.values:
                    g = _geom_intersection(a, b)
                    if g is not None:
                        new.append(g)
            acc = new
            if not acc:
                return FilterValues.make_disjoint()
        return FilterValues(acc)
    if isinstance(f, ast.BBox):
        if attribute is not None and f.prop != attribute:
            return FilterValues.empty()
        box = Envelope(f.xmin, f.ymin, f.xmax, f.ymax).to_polygon()
        return FilterValues([p for g in _split_idl(box) for p in _flatten(g)])
    if isinstance(f, ast.DWithin):
        if attribute is not None and f.prop != attribute:
            return FilterValues.empty()
        deg = dwithin_degrees(f.geom, f.distance, f.units)
        buffered = f.geom.envelope.buffer(deg).to_polygon()
        return FilterValues([p for g in _split_idl(buffered)
                             for p in _flatten(g)])
    if isinstance(f, (ast.Intersects, ast.Contains, ast.Within,
                      ast.Overlaps, ast.Touches, ast.Crosses,
                      ast.GeomEquals)):
        # DISJOINT constrains nothing the index can range over
        if attribute is not None and f.prop != attribute:
            return FilterValues.empty()
        return FilterValues([p for g in _split_idl(f.geom)
                             for p in _flatten(g)])
    return FilterValues.empty()


def _flatten(g: Geometry) -> list[Geometry]:
    """A geometry collection's members, recursively; any other geometry
    as itself."""
    if isinstance(g, _Multi) and g.geom_type == "GeometryCollection":
        return [s for p in g.parts for s in _flatten(p)]
    return [g]


# -- attribute bounds ------------------------------------------------------


def extract_attribute_bounds(f: ast.Filter, attribute: str) -> FilterValues:
    """Typed bounds for one attribute (FilterHelper.scala:318)."""
    if isinstance(f, ast.Or):
        all_bounds: list[Bounds] = []
        for c in f.children:
            child = extract_attribute_bounds(c, attribute)
            if child.is_empty:
                return FilterValues.empty()  # unconstrained child
            all_bounds = _union(all_bounds, child.values)
        return FilterValues(all_bounds) if all_bounds else FilterValues.empty()
    if isinstance(f, ast.And):
        acc: list[Bounds] | None = None
        for c in f.children:
            child = extract_attribute_bounds(c, attribute)
            if child.disjoint:
                return FilterValues.make_disjoint()
            if child.is_empty:
                continue
            if acc is None:
                acc = list(child.values)
            else:
                new = []
                for a in acc:
                    for b in child.values:
                        i = a.intersection(b)
                        if i is not None:
                            new.append(i)
                if not new:
                    return FilterValues.make_disjoint()
                acc = new
        return FilterValues(acc) if acc else FilterValues.empty()
    if isinstance(f, ast.Compare) and f.prop == attribute:
        v = f.value
        if f.op == ast.CompareOp.EQ:
            return FilterValues([Bounds(Bound(v, True), Bound(v, True))])
        if f.op == ast.CompareOp.LT:
            return FilterValues([Bounds(Bound.unbounded(), Bound(v, False))])
        if f.op == ast.CompareOp.LE:
            return FilterValues([Bounds(Bound.unbounded(), Bound(v, True))])
        if f.op == ast.CompareOp.GT:
            return FilterValues([Bounds(Bound(v, False), Bound.unbounded())])
        if f.op == ast.CompareOp.GE:
            return FilterValues([Bounds(Bound(v, True), Bound.unbounded())])
        return FilterValues.empty()  # <> is not index-consumable
    if isinstance(f, ast.Between) and f.prop == attribute:
        return FilterValues([Bounds(Bound(f.lo, True), Bound(f.hi, True))])
    if isinstance(f, ast.InList) and f.prop == attribute:
        return FilterValues([Bounds(Bound(v, True), Bound(v, True))
                             for v in f.values])
    if isinstance(f, ast.During) and f.prop == attribute:
        return FilterValues([Bounds(Bound(f.start, False), Bound(f.end, False))])
    if isinstance(f, ast.Before) and f.prop == attribute:
        return FilterValues([Bounds(Bound.unbounded(), Bound(f.time, False))])
    if isinstance(f, ast.After) and f.prop == attribute:
        return FilterValues([Bounds(Bound(f.time, False), Bound.unbounded())])
    if isinstance(f, ast.TEquals) and f.prop == attribute:
        return FilterValues([Bounds(Bound(f.time, True), Bound(f.time, True))])
    if isinstance(f, ast.Like) and f.prop == attribute and f.case_sensitive:
        # prefix patterns are index-consumable: 'abc%' -> [abc, abd)
        pat = f.pattern
        i = min((pat.index(c) for c in "%_" if c in pat), default=len(pat))
        prefix = pat[:i]
        if prefix and pat[i:] in ("%", ""):
            hi = prefix[:-1] + chr(ord(prefix[-1]) + 1)
            return FilterValues([Bounds(Bound(prefix, True), Bound(hi, False))])
        return FilterValues.empty()
    return FilterValues.empty()


_INT_TYPES = frozenset({"Integer", "Long"})
_FLOAT_TYPES = frozenset({"Float", "Double"})


def _coerce(v, kind: str | None):
    """A quoted literal as the attribute's type: epoch millis for a Date,
    an int (else a float) for an Integer or Long, a float for a Float or
    Double. Anything else, and a string that does not parse, as it is."""
    if not isinstance(v, str):
        return v
    try:
        if kind == "Date":
            return to_millis(v)
        if kind in _INT_TYPES:
            try:
                return int(v)
            except ValueError:
                return float(v)
        if kind in _FLOAT_TYPES:
            return float(v)
    except ValueError:
        pass
    return v


def coerce_literals(f: ast.Filter, sft) -> ast.Filter:
    """The filter with each quoted compare and BETWEEN literal on a Date
    or numeric attribute of ``sft`` coerced to the attribute's type, so
    that one attribute bounded by a quoted and an unquoted literal under
    AND intersects as numbers (``val > '2' AND val < 8``). The JAX
    package raises TypeError there; this is a departure (ROADMAP.md
    section 3). IN lists keep their literals, as the reference's
    evaluator compares them."""
    kinds = {a.name: a.type.name for a in sft.attributes}

    def walk(g):
        if isinstance(g, (ast.And, ast.Or)):
            kids = tuple(walk(c) for c in g.children)
            if all(a is b for a, b in zip(kids, g.children)):
                return g
            return type(g)(kids)
        if isinstance(g, ast.Not):
            c = walk(g.child)
            return g if c is g.child else ast.Not(c)
        kind = kinds.get(getattr(g, "prop", None))
        if isinstance(g, ast.Compare):
            v = _coerce(g.value, kind)
            return g if v is g.value else dataclasses.replace(g, value=v)
        if isinstance(g, ast.Between):
            lo, hi = _coerce(g.lo, kind), _coerce(g.hi, kind)
            return (g if lo is g.lo and hi is g.hi
                    else dataclasses.replace(g, lo=lo, hi=hi))
        return g

    return walk(f)


def _union(acc: list[Bounds], more: list[Bounds]) -> list[Bounds]:
    out = list(acc)
    for b in more:
        merged = b
        keep = []
        for a in out:
            u = merged.union_if_overlapping(a)
            if u is None:
                keep.append(a)
            else:
                merged = u
        keep.append(merged)
        out = keep
    return out


def extract_intervals(f: ast.Filter, attribute: str) -> FilterValues:
    """Date intervals in epoch millis (FilterHelper.extractIntervals:267)."""
    return extract_attribute_bounds(f, attribute)
