"""Vectorized filter evaluation on the host: Filter AST x FeatureBatch ->
bool mask, in exact float64 / int64.

The exact reference evaluator: the oracle for the device kernels (the
residual kernel's f64 band rows, the point-in-polygon kernel's band
rows and the extent tristate's MAYBE rows are re-evaluated here) and
the engine for residuals on gathered candidates. String predicates run
on the (small) dictionary vocab, then map through the code array.
Spatial predicates on a point column are vectorized where the query
geometry has ``contains_points``; on an extent column, and for the
relate operators, an envelope prefilter picks the rows that the exact
per-geometry predicate (``geometry/base.py``, ``geometry/relate.py``)
then decides.
"""

from __future__ import annotations

import operator

import numpy as np

from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              GeometryColumn, NumericColumn, PointColumn,
                              StringColumn)
from ..geometry import Envelope, Point
from ..geometry import relate as _rel
from . import ast
from .helper import dwithin_degrees, like_vocab_mask, to_millis

__all__ = ["evaluate", "COMPARE_OPS"]


def evaluate(f: ast.Filter, b: FeatureBatch) -> np.ndarray:
    """Evaluate filter over a batch; returns bool[n]."""
    n = b.n
    if isinstance(f, ast.Include):
        return np.ones(n, dtype=bool)
    if isinstance(f, ast.Exclude):
        return np.zeros(n, dtype=bool)
    if isinstance(f, ast.And):
        out = np.ones(n, dtype=bool)
        for c in f.children:
            out &= evaluate(c, b)
        return out
    if isinstance(f, ast.Or):
        out = np.zeros(n, dtype=bool)
        for c in f.children:
            out |= evaluate(c, b)
        return out
    if isinstance(f, ast.Not):
        return ~evaluate(f.child, b)
    if isinstance(f, ast.FidFilter):
        return np.isin(b.ids.astype(str), np.asarray(f.ids, dtype=str))
    if isinstance(f, ast.Compare):
        return _compare(f.op, f.prop, f.value, b)
    if isinstance(f, ast.Between):
        return (_compare(ast.CompareOp.GE, f.prop, f.lo, b)
                & _compare(ast.CompareOp.LE, f.prop, f.hi, b))
    if isinstance(f, ast.Like):
        col = b.col(f.prop)
        if not isinstance(col, StringColumn):
            raise TypeError("LIKE requires a string attribute")
        return _through_codes(
            like_vocab_mask(f.pattern, f.case_sensitive, col.vocab), col)
    if isinstance(f, ast.IsNull):
        return ~b.col(f.prop).valid
    if isinstance(f, ast.InList):
        col = b.col(f.prop)
        if isinstance(col, StringColumn):
            codes = [col.code_of(str(v)) for v in f.values]
            codes = [c for c in codes if c >= 0]
            return np.isin(col.codes, codes) if codes else np.zeros(n, bool)
        return np.isin(_values(col), np.asarray(list(f.values))) & col.valid
    if isinstance(f, ast.BBox):
        return _bbox(f, b)
    if isinstance(f, ast.DWithin):
        return _dwithin(f, b)
    if isinstance(f, ast.SpatialPredicate):
        return _spatial(f, b)
    if isinstance(f, (ast.During, ast.Before, ast.After, ast.TEquals)):
        return _temporal(f, b)
    raise TypeError(f"cannot evaluate {type(f).__name__}")


def _geometry_col(b: FeatureBatch, prop: str):
    col = b.col(prop)
    if not isinstance(col, (PointColumn, GeometryColumn)):
        raise TypeError(f"{prop} is not a geometry column")
    return col


def _env_overlaps(bounds: np.ndarray, env: Envelope) -> np.ndarray:
    """Rows whose bounding box meets the envelope (False for NaN rows)."""
    return ((bounds[:, 0] <= env.xmax) & (bounds[:, 2] >= env.xmin)
            & (bounds[:, 1] <= env.ymax) & (bounds[:, 3] >= env.ymin))


def _in_env(col: PointColumn, env: Envelope) -> np.ndarray:
    return ((col.x >= env.xmin) & (col.x <= env.xmax) & (col.y >= env.ymin)
            & (col.y <= env.ymax) & col.valid)


def _bbox(f: ast.BBox, b: FeatureBatch) -> np.ndarray:
    col = _geometry_col(b, f.prop)
    env = Envelope(f.xmin, f.ymin, f.xmax, f.ymax)
    if isinstance(col, PointColumn):
        return _in_env(col, env)
    # envelope prefilter, then the exact intersection per candidate
    out = np.zeros(b.n, dtype=bool)
    box = env.to_polygon()
    for i in np.flatnonzero(_env_overlaps(col.bounds, env)):
        out[i] = col.geoms[i] is not None and box.intersects(col.geoms[i])
    return out


def _spatial(f: ast.SpatialPredicate, b: FeatureBatch) -> np.ndarray:
    col = _geometry_col(b, f.prop)
    g = f.geom
    out = np.zeros(b.n, dtype=bool)
    if isinstance(col, PointColumn):
        if hasattr(g, "contains_points"):
            if isinstance(f, (ast.Intersects, ast.Within)):
                return g.contains_points(col.x, col.y) & col.valid
            if isinstance(f, ast.Disjoint):
                return ~g.contains_points(col.x, col.y) & col.valid
        cand = _in_env(col, g.envelope)
        if isinstance(f, ast.Disjoint):
            out = col.valid.copy()
        for i in np.flatnonzero(cand):
            out[i] = _apply_pred(f, Point(col.x[i], col.y[i]), g)
        return out
    if isinstance(f, ast.Disjoint):
        cand = np.flatnonzero(col.valid)
    else:
        cand = np.flatnonzero(col.valid & _env_overlaps(col.bounds,
                                                        g.envelope))
    for i in cand:
        out[i] = _apply_pred(f, col.geoms[i], g)
    return out


def _apply_pred(f: ast.SpatialPredicate, feature_geom, query_geom) -> bool:
    if isinstance(f, ast.Intersects):
        return feature_geom.intersects(query_geom)
    if isinstance(f, ast.Disjoint):
        return not feature_geom.intersects(query_geom)
    if isinstance(f, ast.Contains):
        # ECQL CONTAINS(attr, g): the feature geometry contains g
        return feature_geom.contains(query_geom)
    if isinstance(f, ast.Within):
        return query_geom.contains(feature_geom)
    # the DE-9IM predicates (the envelope prefilter already rejected the
    # cheap negatives)
    if isinstance(f, ast.Touches):
        return _rel.touches(feature_geom, query_geom)
    if isinstance(f, ast.GeomEquals):
        return _rel.topo_equals(feature_geom, query_geom)
    if isinstance(f, ast.Crosses):
        return _rel.crosses(feature_geom, query_geom)
    if isinstance(f, ast.Overlaps):
        return _rel.overlaps(feature_geom, query_geom)
    raise TypeError(type(f).__name__)


def _dwithin(f: ast.DWithin, b: FeatureBatch) -> np.ndarray:
    deg = dwithin_degrees(f.geom, f.distance, f.units)
    col = _geometry_col(b, f.prop)
    if isinstance(col, PointColumn) and isinstance(f.geom, Point):
        dx = col.x - f.geom.x
        dy = col.y - f.geom.y
        return (dx * dx + dy * dy <= deg * deg) & col.valid
    env = f.geom.envelope.buffer(deg)
    out = np.zeros(b.n, dtype=bool)
    if isinstance(col, PointColumn):
        for i in np.flatnonzero(_in_env(col, env)):
            out[i] = Point(col.x[i], col.y[i]).dwithin(f.geom, deg)
    else:
        for i in np.flatnonzero(col.valid & _env_overlaps(col.bounds, env)):
            out[i] = col.geoms[i].dwithin(f.geom, deg)
    return out


def _values(col) -> np.ndarray:
    if isinstance(col, (NumericColumn, BoolColumn)):
        return col.values
    if isinstance(col, DateColumn):
        return col.millis
    raise TypeError(f"no raw values for {type(col).__name__}")


def _through_codes(vocab_ok: np.ndarray, col: StringColumn) -> np.ndarray:
    """Map a vocab-level mask through the codes; nulls are False."""
    ok = np.zeros(col.n, dtype=bool)
    valid = col.codes >= 0
    ok[valid] = vocab_ok[col.codes[valid]]
    return ok


# a compare operator as Python's operator on numpy operands (numpy's
# promotion rules decide mixed types)
COMPARE_OPS = {
    ast.CompareOp.EQ: operator.eq, ast.CompareOp.NE: operator.ne,
    ast.CompareOp.LT: operator.lt, ast.CompareOp.GT: operator.gt,
    ast.CompareOp.LE: operator.le, ast.CompareOp.GE: operator.ge,
}


def _compare(op: str, prop: str, v, b: FeatureBatch) -> np.ndarray:
    col = b.col(prop)
    if isinstance(col, StringColumn):
        return _through_codes(COMPARE_OPS[op](col.vocab.astype(str), str(v)), col)
    vals = _values(col)
    if isinstance(col, DateColumn) and isinstance(v, str):
        v = to_millis(v)
    return COMPARE_OPS[op](vals, v) & col.valid


def _temporal(f, b: FeatureBatch) -> np.ndarray:
    col = b.col(f.prop)
    if not isinstance(col, DateColumn):
        raise TypeError(f"{f.prop} is not a date column")
    ms = col.millis
    if isinstance(f, ast.During):
        return (ms > f.start) & (ms < f.end) & col.valid
    if isinstance(f, ast.Before):
        return (ms < f.time) & col.valid
    if isinstance(f, ast.After):
        return (ms > f.time) & col.valid
    return (ms == f.time) & col.valid
