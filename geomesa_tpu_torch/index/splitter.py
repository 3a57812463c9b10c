"""FilterSplitter: decompose a filter into per-index strategy options.

Mirrors the reference's FilterSplitter (index/planning/FilterSplitter.scala:25)
for each index of a schema:

- z3/xz3:   spatial values on the default geometry AND bounded intervals
            on the default date (Z3IndexKeySpace.scala:63-119; xz3 is the
            extent schemas' counterpart)
- z2/xz2:   spatial values on the default geometry (Z2IndexKeySpace)
- attr:     bounds on an indexed attribute (AttributeIndex)
- id:       a FidFilter (RecordIndex/IdIndex)
- fullscan: anything (the in-memory fallback)
"""

from __future__ import annotations

from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import (extract_attribute_bounds, extract_geometries,
                              extract_intervals)
from .api import FilterStrategy

__all__ = ["split_filter", "spatial_part", "temporal_part"]


def _is_spatial(f: ast.Filter, geom: str) -> bool:
    return (isinstance(f, (ast.BBox, ast.DWithin, ast.SpatialPredicate))
            and f.prop == geom)


def _is_temporal(f: ast.Filter, dtg: str | None) -> bool:
    return (dtg is not None
            and isinstance(f, (ast.During, ast.Before, ast.After, ast.TEquals,
                               ast.Compare, ast.Between))
            and getattr(f, "prop", None) == dtg)


_ATTR_NODES = (ast.Compare, ast.Between, ast.InList, ast.Like, ast.During,
               ast.Before, ast.After, ast.TEquals)


def _partition(f: ast.Filter, pred) -> tuple[ast.Filter | None, ast.Filter | None]:
    """Split an AND tree into (matching, rest). Non-AND filters are all
    or nothing."""
    if isinstance(f, ast.Include):
        return None, None
    if pred(f):
        return f, None
    if isinstance(f, ast.And):
        hit = [c for c in f.children if pred(c)]
        rest = [c for c in f.children if not pred(c)]
        return _and_of(hit), _and_of(rest)
    return None, f


def _with_or(pred):
    """A homogeneous OR (every child matches pred) counts as matching,
    both at the top level and as a conjunct inside an AND."""
    def p(c):
        return pred(c) or (isinstance(c, ast.Or)
                           and all(pred(k) for k in c.children))
    return p


def spatial_part(f: ast.Filter, geom: str):
    return _partition(f, _with_or(lambda c: _is_spatial(c, geom)))


def temporal_part(f: ast.Filter, dtg: str | None):
    return _partition(f, _with_or(lambda c: _is_temporal(c, dtg)))


def _and_opt(a: ast.Filter | None, b: ast.Filter | None) -> ast.Filter | None:
    if a is None:
        return b
    if b is None:
        return a
    return ast.And([a, b])


def _and_of(fs: list[ast.Filter]) -> ast.Filter | None:
    return None if not fs else (fs[0] if len(fs) == 1 else ast.And(fs))


def split_filter(sft: SimpleFeatureType, f: ast.Filter,
                 indices: list[str]) -> list[FilterStrategy]:
    """All viable FilterStrategy options for the filter. An OR is a
    primary only when every child constrains the same dimension;
    otherwise only fullscan applies."""
    geom = sft.geom_field
    dtg = sft.dtg_field
    options: list[FilterStrategy] = []
    if isinstance(f, ast.Exclude):
        return [FilterStrategy("empty", None, None, cost=0)]
    for index in indices:
        if index in ("z3", "xz3") and geom is not None and dtg is not None:
            geoms = extract_geometries(f, geom)
            intervals = extract_intervals(f, dtg)
            if geoms.disjoint or intervals.disjoint:
                return [FilterStrategy("empty", None, None, cost=0)]
            # z3 needs a bounded time interval; unbounded falls through
            # to z2/fullscan
            bounded = bool(intervals) and all(
                b.lower.is_bounded and b.upper.is_bounded for b in intervals)
            if bounded:
                spatial, rest1 = spatial_part(f, geom)
                temporal, rest2 = temporal_part(rest1, dtg) if rest1 else (None, None)
                primary = _and_opt(spatial, temporal)
                if primary is not None:
                    options.append(FilterStrategy(index, primary, rest2))
        elif index in ("z2", "xz2") and geom is not None:
            geoms = extract_geometries(f, geom)
            if geoms.disjoint:
                return [FilterStrategy("empty", None, None, cost=0)]
            if geoms:
                spatial, rest = spatial_part(f, geom)
                if spatial is not None:
                    options.append(FilterStrategy(index, spatial, rest))
        elif index == "id":
            if isinstance(f, ast.FidFilter):
                options.append(FilterStrategy("id", f, None))
            elif isinstance(f, ast.And):
                fids = [c for c in f.children if isinstance(c, ast.FidFilter)]
                if fids:
                    # several fid filters AND together: intersect the sets
                    ids = set(fids[0].ids)
                    for extra in fids[1:]:
                        ids &= set(extra.ids)
                    rest = _and_of([c for c in f.children if c not in fids])
                    options.append(FilterStrategy(
                        "id", ast.FidFilter(sorted(ids)), rest))
        elif index.startswith("attr:"):
            attr = index.split(":", 1)[1]
            bounds = extract_attribute_bounds(f, attr)
            if bounds.disjoint:
                return [FilterStrategy("empty", None, None, cost=0)]
            if bounds and any(b.is_bounded for b in bounds):
                primary, rest = _partition(f, _with_or(
                    lambda c, attr=attr: (getattr(c, "prop", None) == attr
                                          and isinstance(c, _ATTR_NODES))))
                if primary is not None:
                    options.append(FilterStrategy(index, primary, rest))
    residual = None if isinstance(f, ast.Include) else f
    options.append(FilterStrategy("fullscan", None, residual))
    return options
