"""Filter AST: the CQL/OpenGIS filter algebra.

Logical AND/OR/NOT, INCLUDE/EXCLUDE, feature-ID filters, comparisons,
BETWEEN, LIKE, IN and IS NULL on any attribute, BBOX, DWITHIN and the
spatial predicates INTERSECTS, WITHIN, DISJOINT, CONTAINS, TOUCHES,
CROSSES, OVERLAPS and EQUALS over any geometry literal, and the temporal
DURING/BEFORE/AFTER/TEQUALS. All nodes are immutable
dataclasses; geometry literals are geomesa_tpu_torch.geometry objects;
temporal literals are epoch millis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as _np

from ..geometry import Geometry

__all__ = ["Filter", "Include", "Exclude", "And", "Or", "Not", "FidFilter",
           "Compare", "CompareOp", "Between", "Like", "IsNull", "InList",
           "SpatialPredicate", "BBox", "Intersects", "Within", "Disjoint",
           "Contains", "Touches", "Crosses", "Overlaps", "GeomEquals",
           "DWithin", "During", "Before", "After", "TEquals", "walk",
           "props_of"]


class Filter:
    """Base class for all filter nodes."""

    def __and__(self, other: "Filter") -> "Filter":
        return And([self, other])

    def __or__(self, other: "Filter") -> "Filter":
        return Or([self, other])

    def __invert__(self) -> "Filter":
        return Not(self)


def _iso(millis: int) -> str:
    """Epoch millis -> ISO-8601 instant (re-parseable ECQL)."""
    return str(_np.datetime64(int(millis), "ms")) + "Z"


def walk(f: Filter):
    """Yield every node of a filter tree."""
    yield f
    for c in getattr(f, "children", ()) or ():
        yield from walk(c)
    child = getattr(f, "child", None)
    if child is not None:
        yield from walk(child)


def props_of(f: Filter) -> set:
    """Attribute names referenced anywhere in a filter tree."""
    return {p for node in walk(f)
            if (p := getattr(node, "prop", None))}


@dataclasses.dataclass(frozen=True)
class Include(Filter):
    """Matches everything (Filter.INCLUDE)."""
    def __str__(self) -> str:
        return "INCLUDE"


@dataclasses.dataclass(frozen=True)
class Exclude(Filter):
    """Matches nothing (Filter.EXCLUDE)."""
    def __str__(self) -> str:
        return "EXCLUDE"


@dataclasses.dataclass(frozen=True)
class And(Filter):
    children: tuple

    def __init__(self, children: Sequence[Filter]):
        flat: list[Filter] = []
        for c in children:
            if isinstance(c, And):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))

    def __str__(self) -> str:
        return "(" + " AND ".join(str(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Or(Filter):
    children: tuple

    def __init__(self, children: Sequence[Filter]):
        flat: list[Filter] = []
        for c in children:
            if isinstance(c, Or):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))

    def __str__(self) -> str:
        return "(" + " OR ".join(str(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Not(Filter):
    child: Filter

    def __str__(self) -> str:
        return f"NOT ({self.child})"


@dataclasses.dataclass(frozen=True)
class FidFilter(Filter):
    """Feature-ID filter (GeoTools Id filter)."""
    ids: tuple

    def __init__(self, ids):
        object.__setattr__(self, "ids", tuple(ids))

    def __str__(self) -> str:
        return "IN (" + ", ".join(f"'{i}'" for i in self.ids) + ")"


class CompareOp:
    EQ = "="
    NE = "<>"
    LT = "<"
    GT = ">"
    LE = "<="
    GE = ">="


@dataclasses.dataclass(frozen=True)
class Compare(Filter):
    op: str
    prop: str
    value: Any

    def __str__(self) -> str:
        v = f"'{self.value}'" if isinstance(self.value, str) else self.value
        return f"{self.prop} {self.op} {v}"


@dataclasses.dataclass(frozen=True)
class Between(Filter):
    prop: str
    lo: Any
    hi: Any

    def __str__(self) -> str:
        return f"{self.prop} BETWEEN {self.lo} AND {self.hi}"


@dataclasses.dataclass(frozen=True)
class Like(Filter):
    prop: str
    pattern: str        # SQL LIKE: % and _ wildcards
    case_sensitive: bool = True

    def __str__(self) -> str:
        op = "LIKE" if self.case_sensitive else "ILIKE"
        return f"{self.prop} {op} '{self.pattern}'"


@dataclasses.dataclass(frozen=True)
class IsNull(Filter):
    prop: str

    def __str__(self) -> str:
        return f"{self.prop} IS NULL"


@dataclasses.dataclass(frozen=True)
class InList(Filter):
    prop: str
    values: tuple

    def __init__(self, prop: str, values):
        object.__setattr__(self, "prop", prop)
        object.__setattr__(self, "values", tuple(values))

    def __str__(self) -> str:
        vals = ", ".join(f"'{v}'" if isinstance(v, str) else str(v)
                         for v in self.values)
        return f"{self.prop} IN ({vals})"


@dataclasses.dataclass(frozen=True)
class SpatialPredicate(Filter):
    prop: str
    geom: Geometry

    op_name = "?"

    def __str__(self) -> str:
        return f"{self.op_name}({self.prop}, {self.geom!r})"


class Intersects(SpatialPredicate):
    op_name = "INTERSECTS"


class Within(SpatialPredicate):
    op_name = "WITHIN"


class Disjoint(SpatialPredicate):
    op_name = "DISJOINT"


class Contains(SpatialPredicate):
    op_name = "CONTAINS"


class Touches(SpatialPredicate):
    op_name = "TOUCHES"


class Crosses(SpatialPredicate):
    op_name = "CROSSES"


class Overlaps(SpatialPredicate):
    op_name = "OVERLAPS"


class GeomEquals(SpatialPredicate):
    """EQUALS / ST_Equals: topological equality."""
    op_name = "EQUALS"


@dataclasses.dataclass(frozen=True)
class BBox(Filter):
    prop: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    def __str__(self) -> str:
        return (f"BBOX({self.prop}, {self.xmin}, {self.ymin}, "
                f"{self.xmax}, {self.ymax})")


@dataclasses.dataclass(frozen=True)
class DWithin(Filter):
    """DWITHIN(prop, geom, distance, units): within a distance in
    meters, kilometers, feet, statute or nautical miles (or degrees)."""
    prop: str
    geom: Geometry
    distance: float
    units: str = "meters"

    def __str__(self) -> str:
        return (f"DWITHIN({self.prop}, {self.geom!r}, "
                f"{self.distance}, {self.units})")


@dataclasses.dataclass(frozen=True)
class During(Filter):
    """dtg DURING start/end — both epoch millis, exclusive bounds per
    ECQL semantics."""
    prop: str
    start: int
    end: int

    def __str__(self) -> str:
        return (f"{self.prop} DURING "
                f"{_iso(self.start)}/{_iso(self.end)}")


@dataclasses.dataclass(frozen=True)
class Before(Filter):
    prop: str
    time: int

    def __str__(self) -> str:
        return f"{self.prop} BEFORE {_iso(self.time)}"


@dataclasses.dataclass(frozen=True)
class After(Filter):
    prop: str
    time: int

    def __str__(self) -> str:
        return f"{self.prop} AFTER {_iso(self.time)}"


@dataclasses.dataclass(frozen=True)
class TEquals(Filter):
    prop: str
    time: int

    def __str__(self) -> str:
        return f"{self.prop} TEQUALS {_iso(self.time)}"
