"""Vectorized filter evaluation on the host: Filter AST x FeatureBatch ->
bool mask, in exact float64 / int64.

The exact reference evaluator of point schemas: the oracle for the
device kernels (the residual kernel's f64 band rows and the
point-in-polygon kernel's band rows are re-evaluated here) and the
engine for residuals on gathered candidates. String predicates run on
the (small) dictionary vocab, then map through the code array.
"""

from __future__ import annotations

import operator

import numpy as np

from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              NumericColumn, PointColumn, StringColumn)
from . import ast
from .helper import like_vocab_mask, to_millis

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
        col = _points(b, f.prop)
        return ((col.x >= f.xmin) & (col.x <= f.xmax)
                & (col.y >= f.ymin) & (col.y <= f.ymax) & col.valid)
    if isinstance(f, ast.SpatialPredicate):
        col = _points(b, f.prop)
        inside = f.geom.contains_points(col.x, col.y)
        if isinstance(f, ast.Disjoint):
            inside = ~inside
        return inside & col.valid
    if isinstance(f, (ast.During, ast.Before, ast.After, ast.TEquals)):
        return _temporal(f, b)
    raise TypeError(f"cannot evaluate {type(f).__name__}")


def _points(b: FeatureBatch, prop: str) -> PointColumn:
    col = b.col(prop)
    if not isinstance(col, PointColumn):
        raise TypeError(f"{prop} is not a point column")
    return col


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
