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

import numpy as np

from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import (extract_attribute_bounds, extract_geometries,
                              extract_intervals)
from .api import FilterStrategy

__all__ = ["split_filter", "spatial_part", "temporal_part",
           "prefix_histogram", "pick_split_prefix"]


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


#
# The reference's tablet splitter picks split points from the observed
# key distribution, not the keyspace midpoint (``getSplits`` over the
# curve). Same idea here: histogram a store's rows by their z-key
# prefix and split at the weighted median, so a hot range splits into
# halves of equal ROW count even when the keys are badly skewed.

def _batch_prefixes(sft, batch, prefix_bits: int) -> np.ndarray | None:
    """Z-key prefix per row (the same routing key the cluster
    partitioner derives): point coords directly, extent geometries by
    bbox centroid; None for a geometry-less schema (id-hash routed —
    no spatial key to histogram)."""
    from ..curves import zorder
    from ..curves.sfc import Z2SFC
    geom = sft.geom_field
    if geom is None or batch is None or not batch.n:
        return None
    col = batch.col(geom)
    if hasattr(col, "x"):                          # PointColumn
        x = np.asarray(col.x, np.float64)
        y = np.asarray(col.y, np.float64)
    else:                                          # GeometryColumn
        bounds = np.asarray(col.bounds, np.float64)
        x = (bounds[:, 0] + bounds[:, 2]) * 0.5
        y = (bounds[:, 1] + bounds[:, 3]) * 0.5
        bad = ~np.isfinite(x) | ~np.isfinite(y)
        x = np.where(bad, 0.0, x)
        y = np.where(bad, 0.0, y)
    z = np.asarray(Z2SFC().index(x, y, lenient=True)).astype(np.uint64)
    shift = np.uint64(2 * zorder.Z2_BITS - prefix_bits)
    return (z >> shift).astype(np.int64)


def prefix_histogram(store, type_name: str, prefix_lo: int,
                     prefix_hi: int, prefix_bits: int = 16) -> np.ndarray:
    """Row count per z prefix over ``[prefix_lo, prefix_hi)`` for one
    type — the key-density profile a reshard split point is chosen
    from (and the ``GET /rest/topology`` density summary)."""
    from .api import Query
    sft = store.get_schema(type_name)
    out = np.zeros(max(int(prefix_hi) - int(prefix_lo), 0),
                   dtype=np.int64)
    if not len(out):
        return out
    res = store.query(Query(type_name, "INCLUDE"))
    prefixes = _batch_prefixes(sft, res.batch, prefix_bits)
    if prefixes is None:
        return out
    in_range = prefixes[(prefixes >= prefix_lo) & (prefixes < prefix_hi)]
    if len(in_range):
        np.add.at(out, in_range - prefix_lo, 1)
    return out


def pick_split_prefix(counts: np.ndarray | None, prefix_lo: int,
                      prefix_hi: int) -> int:
    """The weighted-median split point for a density profile over
    ``[prefix_lo, prefix_hi)``: the smallest prefix with at least half
    the rows strictly below it, clamped inside the open interval so
    both sides stay non-empty. Falls back to the keyspace midpoint for
    an empty (or absent) profile."""
    mid = (int(prefix_lo) + int(prefix_hi)) // 2
    if counts is None:
        return mid
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total <= 0 or len(counts) != prefix_hi - prefix_lo:
        return mid
    cum = np.cumsum(counts)
    at = int(prefix_lo) + int(np.searchsorted(cum, total / 2.0)) + 1
    return int(min(max(at, prefix_lo + 1), prefix_hi - 1))
