"""Device residual predicates: attribute filters compiled for the
residual kernel (the JAX package's scan/residual.py).

The reference evaluates residual CQL row by row inside server-side
iterators (KryoLazyFilterTransformIterator.scala:37) and, for Arrow
scans, rewrites string predicates against dictionary codes so that the
hot loop compares ints (ArrowFilterOptimizer.scala:36). Here attribute
predicates compile on the host into one postfix program that the
residual kernel (``kernels.residual_mask``, csrc/residual.cu) runs over
split device columns in one pass:

- float64 -> (f32 hi, f32 residual lo); compares are lexicographic on
             (hi, lo), and rows whose key equals the threshold's key
             (the band) are re-evaluated in float64 on the host;
- int64   -> (signed high word v >> 32, unsigned low word
             v & 0xFFFFFFFF): lexicographic compare is exact over the
             full int64 range;
- date    -> (day, millis-of-day), as in the z3 time axis;
- string  -> integer compares against code-space thresholds from the
             sorted vocab; IN/LIKE run over the vocab on the host and
             map through a table the kernel indexes by code;
- AND/OR/NOT -> logic on the kernel's bit stack.

Spatial and id predicates are not handled here: they are the primary
scan's job. ``is_compilable`` says whether a whole filter tree is in
this subset; callers evaluate the rest on the host with
``filters.evaluate``, so this layer never changes semantics.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              GeometryColumn, NumericColumn, PointColumn,
                              StringColumn)
from ..filters import ast
from ..filters.evaluate import COMPARE_OPS, evaluate
from ..filters.helper import like_vocab_mask, to_millis
from . import kernels
from .aggregations import geometry_centroids
from .kernels import Cmp, Op
from .zscan import MILLIS_PER_DAY

__all__ = ["DeviceColumns", "Program", "compile_program", "device_mask",
           "device_columns_from_numpy", "is_compilable"]

# the residual kernel's bit stack holds at most 64 levels
MAX_STACK = 64

_CMP = {ast.CompareOp.LT: Cmp.LT, ast.CompareOp.GT: Cmp.GT,
        ast.CompareOp.LE: Cmp.LE, ast.CompareOp.GE: Cmp.GE,
        ast.CompareOp.EQ: Cmp.EQ, ast.CompareOp.NE: Cmp.NE}


def _split_f64(v):
    """(f32 hi, f32 residual lo). ±inf splits as (±inf, 0): its residual
    inf - inf would be NaN, which no compare orders. A finite value past
    the f32 range keeps (±inf, ∓inf), which orders it below +inf (above
    -inf) and shares its key with every such value, so the band decides
    it in float64."""
    v = np.asarray(v, dtype=np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
    lo = np.where(np.isinf(v), np.float32(0), lo)
    return hi, lo


def _split_i64(v):
    """Exact full-range int64 split: (signed high word, unsigned low
    word); lexicographic compare on the pair equals int64 compare."""
    v = np.asarray(v, dtype=np.int64)
    return (v >> 32).astype(np.int32), (v & 0xFFFFFFFF).astype(np.uint32)


def _split_ms(v):
    v = np.asarray(v, dtype=np.int64)
    day = v // MILLIS_PER_DAY
    return (day.astype(np.int32),
            (v - day * MILLIS_PER_DAY).astype(np.int32))


class DeviceColumns:
    """Per-column device uploads of one feature batch.

    A column moves to the device once, on first use by a residual or a
    density grid, and serves every query until the batch changes (the
    store drops the whole cache on every write). Each entry is a dict
    with ``kind`` and the kernel's slot ``(a, b, valid)``: split columns
    (hi, lo int32 / f32, valid bool), booleans (values, None, valid),
    strings (codes, None, None), points (x, y f32 rounded to nearest,
    valid bool: the density kernel's coordinates; an extent geometry's
    bounding-box centre); f64 entries keep the host values for the
    band."""

    def __init__(self, batch: FeatureBatch, device):
        self._batch = batch
        self.device = torch.device(device)
        self._cache: dict[str, dict] = {}

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.require(a, None, ["C", "W"])).to(self.device)

    def get(self, name: str) -> dict:
        if name in self._cache:
            return self._cache[name]
        col = self._batch.col(name)
        if isinstance(col, NumericColumn):
            if col.values.dtype.kind == "f":
                hi, lo = _split_f64(col.values)
                dev = {"kind": "f64", "host": col.values}
            else:
                hi, lo = _split_i64(col.values)
                lo = lo.view(np.int32)   # unsigned bits; the kernel reads u32
                dev = {"kind": "i64"}
            dev["slot"] = (self._put(hi), self._put(lo), self._put(col.valid))
        elif isinstance(col, DateColumn):
            day, ms = _split_ms(col.millis)
            dev = {"kind": "date", "slot": (self._put(day), self._put(ms),
                                            self._put(col.valid))}
        elif isinstance(col, BoolColumn):
            dev = {"kind": "bool", "slot": (self._put(col.values), None,
                                            self._put(col.valid))}
        elif isinstance(col, StringColumn):
            dev = {"kind": "str", "slot": (self._put(col.codes), None, None)}
        elif isinstance(col, (PointColumn, GeometryColumn)):
            # an extent's point is its bounding-box centre
            cx, cy, valid = geometry_centroids(col)
            with np.errstate(over="ignore"):
                x, y = cx.astype(np.float32), cy.astype(np.float32)
            dev = {"kind": "point", "slot": (self._put(x), self._put(y),
                                             self._put(valid))}
        else:
            raise TypeError(f"no device column for {type(col).__name__}")
        self._cache[name] = dev
        return dev

    @property
    def nbytes(self) -> int:
        """Device bytes of the columns uploaded so far."""
        return sum(t.numel() * t.element_size()
                   for d in self._cache.values() for t in d["slot"]
                   if t is not None)


def device_columns_from_numpy(batch: FeatureBatch, columns: dict,
                              device) -> DeviceColumns:
    """DeviceColumns of ``batch`` from split columns fetched as numpy
    (e.g. the JAX package's DeviceColumns entries: ``kind`` with hi, lo
    and valid, or values and valid, or codes), copied to ``device`` as
    they are, so that both implementations read the same words."""
    cols = DeviceColumns(batch, device)
    for name, c in columns.items():
        kind = c["kind"]
        if kind == "str":
            slot = (cols._put(c["codes"]), None, None)
        elif kind == "bool":
            slot = (cols._put(c["values"]), None, cols._put(c["valid"]))
        else:
            lo = np.asarray(c["lo"])
            if kind == "i64":
                lo = lo.view(np.int32)   # unsigned bits, as get() keeps them
            slot = (cols._put(c["hi"]), cols._put(lo), cols._put(c["valid"]))
        cols._cache[name] = {"kind": kind, "slot": slot}
    return cols


_COMPILABLE_COLS = (NumericColumn, DateColumn, BoolColumn, StringColumn)


def is_compilable(f: ast.Filter, batch: FeatureBatch) -> bool:
    """True if the whole filter tree evaluates on the device."""
    if isinstance(f, (ast.Include, ast.Exclude)):
        return True
    if isinstance(f, (ast.And, ast.Or)):
        return all(is_compilable(c, batch) for c in f.children)
    if isinstance(f, ast.Not):
        return is_compilable(f.child, batch)
    if isinstance(f, (ast.Compare, ast.Between, ast.InList, ast.IsNull,
                      ast.During, ast.Before, ast.After, ast.TEquals)):
        return isinstance(batch.columns.get(f.prop), _COMPILABLE_COLS)
    if isinstance(f, ast.Like):
        return isinstance(batch.columns.get(f.prop), StringColumn)
    return False


@dataclasses.dataclass
class Program:
    """A compiled residual: (L, 4) int32 instructions {op, slot, a, b},
    (T, 2) int32 thresholds, the uint8 vocab tables, the column names of
    the slots, the stack it needs, and whether an f64 leaf (and so a
    band) is in it."""
    code: np.ndarray
    consts: np.ndarray
    table: np.ndarray
    slots: list
    stack: int
    has_band: bool

    def run(self, cols: DeviceColumns, n: int) -> torch.Tensor:
        """The residual kernel's uint8[n] over ``cols`` (its plain
        version on CPU columns); the program itself stays on the host."""
        return kernels.residual_mask(
            torch.from_numpy(self.code), torch.from_numpy(self.consts),
            torch.from_numpy(self.table),
            [cols.get(name)["slot"] for name in self.slots], n, cols.device)


class _Compiler:
    def __init__(self, batch: FeatureBatch, cols: DeviceColumns):
        self.batch = batch
        self.cols = cols
        self.slots: dict[str, int] = {}
        self.consts: list[tuple[int, int]] = []
        self.table: list[np.ndarray] = []
        self.table_len = 0
        self.has_band = False

    def slot(self, name: str) -> int:
        return self.slots.setdefault(name, len(self.slots))

    def const(self, hi, lo) -> int:
        self.consts.append((int(hi), int(lo)))
        return len(self.consts) - 1

    def vocab(self, name: str, ok: np.ndarray) -> list:
        off = self.table_len
        self.table.append(ok.astype(np.uint8))
        self.table_len += len(ok)
        return [(Op.VOCAB, self.slot(name), off, len(ok))]

    # a node compiles to (instructions, stack it needs); children of AND
    # and OR go deepest first (Sethi-Ullman), so the stack stays shallow
    def node(self, f: ast.Filter):
        if isinstance(f, ast.Include):
            return [(Op.TRUE, 0, 0, 0)], 1
        if isinstance(f, ast.Exclude):
            return [(Op.FALSE, 0, 0, 0)], 1
        if isinstance(f, (ast.And, ast.Or)):
            return self.fold(Op.AND if isinstance(f, ast.And) else Op.OR,
                             [self.node(c) for c in f.children])
        if isinstance(f, ast.Not):
            code, need = self.node(f.child)
            return code + [(Op.NOT, 0, 0, 0)], need
        code = self.leaf(f)
        # a compound leaf (BETWEEN, DURING, numeric IN) needs two bits
        return code, 1 if len(code) == 1 else 2

    def both(self, op: int, *leaves: list) -> list:
        """One compound leaf: ``op`` over leaves of one push each."""
        return self.fold(op, [(c, 1) for c in leaves])[0]

    @staticmethod
    def fold(op: int, parts):
        parts = sorted(parts, key=lambda p: -p[1])
        code = list(parts[0][0])
        need = parts[0][1]
        for c, k in parts[1:]:
            code += c + [(op, 0, 0, 0)]
            need = max(need, k + 1)
        return code, need

    def leaf(self, f: ast.Filter) -> list:
        n = ast.CompareOp
        if isinstance(f, ast.IsNull):
            self.cols.get(f.prop)
            return [(Op.ISNULL, self.slot(f.prop), 0, 0)]
        if isinstance(f, ast.Compare):
            return self.compare(f.op, f.prop, f.value)
        if isinstance(f, ast.Between):
            return self.both(Op.AND, self.compare(n.GE, f.prop, f.lo),
                             self.compare(n.LE, f.prop, f.hi))
        if isinstance(f, ast.During):
            return self.both(Op.AND, self.compare(n.GT, f.prop, f.start),
                             self.compare(n.LT, f.prop, f.end))
        if isinstance(f, ast.Before):
            return self.compare(n.LT, f.prop, f.time)
        if isinstance(f, ast.After):
            return self.compare(n.GT, f.prop, f.time)
        if isinstance(f, ast.TEquals):
            return self.compare(n.EQ, f.prop, f.time)
        if isinstance(f, ast.Like):
            col = self.batch.col(f.prop)
            return self.vocab(f.prop, like_vocab_mask(
                f.pattern, f.case_sensitive, col.vocab))
        if isinstance(f, ast.InList):
            col = self.batch.col(f.prop)
            if isinstance(col, StringColumn):
                return self.vocab(f.prop, np.isin(
                    col.vocab.astype(str),
                    np.asarray([str(v) for v in f.values], dtype=str)))
            # numeric IN: an OR of exact equality compares
            return self.both(Op.OR, *(self.compare(n.EQ, f.prop, v)
                                      for v in f.values))
        raise TypeError(f"not device-compilable: {type(f).__name__}")

    def compare(self, op: str, prop: str, value) -> list:
        col = self.batch.col(prop)
        kind = self.cols.get(prop)["kind"]
        s = self.slot(prop)
        if kind == "str":
            return [self.compare_str(op, str(value), col, s)]
        if kind == "bool":
            # promote like numpy: True == 1, False == 0; a fractional
            # literal compares as a number. The verdicts for the values
            # 0 and 1 make a two-entry truth table.
            v = int(value) if isinstance(value, bool) else value
            r = COMPARE_OPS[op](np.array([0, 1], dtype=np.int32), v)
            return [(Op.BOOL, s, int(r[0]) | int(r[1]) << 1, 0)]
        if kind in ("date", "i64"):
            if kind == "date" and isinstance(value, str):
                op2, iv, const = op, to_millis(value), None
            else:
                op2, iv, const = _int_cmp_const(op, value)
            if const is not None:
                return [(Op.VALID, s, 0, 0) if const else (Op.FALSE, 0, 0, 0)]
            if kind == "date":
                vh, vl = _split_ms(iv)
                return [(Op.PAIR_DATE, s, self.const(vh, vl), _CMP[op2])]
            vh, vl = _split_i64(iv)
            return [(Op.PAIR_I64, s,
                     self.const(vh, np.asarray(vl).view(np.int32)),
                     _CMP[op2])]
        vh, vl = _split_f64(float(value))
        self.has_band = True
        return [(Op.PAIR_F64, s,
                 self.const(np.asarray(vh).view(np.int32),
                            np.asarray(vl).view(np.int32)), _CMP[op])]

    @staticmethod
    def compare_str(op: str, v: str, col: StringColumn, s: int):
        """String compares as integer compares in code space: codes
        index a sorted vocab, so lexicographic thresholds are vocab
        positions."""
        vocab = col.vocab.astype(str)
        n = ast.CompareOp
        if op == n.EQ:
            return (Op.STR_EQ, s, col.code_of(v), 0)
        if op == n.NE:
            return (Op.STR_NE, s, col.code_of(v), 0)
        side = "left" if op in (n.LT, n.GE) else "right"
        t = int(np.searchsorted(vocab, v, side=side))
        return (Op.STR_LT if op in (n.LT, n.LE) else Op.STR_GE, s, t, 0)



def _int_cmp_const(op: str, v):
    """Rewrite a compare against a possibly-fractional literal into an
    exact integer compare: (op', int_value, const), where const
    (True/False) decides the whole predicate. `x < 30.5` becomes
    `x <= 30`; `x = 30.5` is constant False, as numpy promotion has it."""
    if not isinstance(v, float) or v.is_integer():
        op2, iv = op, int(v)
    else:
        if op == ast.CompareOp.EQ:
            return None, None, False
        if op == ast.CompareOp.NE:
            return None, None, True
        if op in (ast.CompareOp.LT, ast.CompareOp.LE):
            op2, iv = ast.CompareOp.LE, math.floor(v)
        else:
            op2, iv = ast.CompareOp.GE, math.floor(v) + 1
    # literals beyond int64 are constants against any int64 column
    if iv > 2**63 - 1 or iv < -(2**63):
        above = iv > 0
        if op2 == ast.CompareOp.EQ:
            return None, None, False
        if op2 == ast.CompareOp.NE:
            return None, None, True
        if op2 in (ast.CompareOp.LT, ast.CompareOp.LE):
            return None, None, above
        return None, None, not above
    return op2, iv, None


def compile_program(f: ast.Filter, batch: FeatureBatch,
                    cols: DeviceColumns) -> Program:
    """The residual program of a compilable filter tree; every threshold
    comes from the JAX package's host rules (``_split_*``,
    ``_int_cmp_const``, vocab searches, ``like_vocab_mask``,
    ``np.isin``)."""
    comp = _Compiler(batch, cols)
    code, need = comp.node(f)
    if need > MAX_STACK:
        raise ValueError(f"the residual program needs a stack of {need}; "
                         f"the kernel holds {MAX_STACK}")
    table = (np.concatenate(comp.table) if comp.table
             else np.zeros(1, dtype=np.uint8))
    consts = (np.asarray(comp.consts, dtype=np.int32)
              if comp.consts else np.zeros((1, 2), dtype=np.int32))
    return Program(np.asarray(code, dtype=np.int32).reshape(-1, 4), consts,
                   table, sorted(comp.slots, key=comp.slots.get), need,
                   comp.has_band)


def device_mask(f: ast.Filter, batch: FeatureBatch,
                cols: DeviceColumns) -> np.ndarray:
    """A compilable filter tree over the batch: host bool[n]. One launch
    of the residual kernel, then the band rows (an f64 leaf's key equal
    to its threshold's) re-evaluated with the whole filter in float64,
    which equals the JAX package's per-leaf patch, since the host
    evaluator and the device agree on every other leaf."""
    prog = compile_program(f, batch, cols)
    out = prog.run(cols, batch.n).cpu().numpy()
    mask = (out & 1).astype(bool)
    if prog.has_band:
        bidx = np.flatnonzero(out & 2)
        if len(bidx):
            mask[bidx] = evaluate(f, batch.take(bidx))
    return mask
