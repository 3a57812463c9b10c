"""Columnar converter execution: transform whole column arrays at once.

The scalar path in ``converter.process`` evaluates every compiled
closure once per record into Python lists — fine for correctness, far
too slow for the ingest firehose. This module is the second backend
over the same expression AST (``dsl.parse_expression``): each node
evaluates to a whole numpy column plus a per-row error mask, so a bad
record is masked out and counted instead of aborting the batch, and the
hot conversions (numeric casts, date parses, point assembly, arithmetic)
run as single numpy operations over the chunk.

Execution contract (mirrors one scalar ``process`` iteration, chunked):

- every node returns ``(values, err)`` — values is an ndarray of length
  n (object or typed) or an ``_XY`` packed point pair; ``err`` marks
  rows whose evaluation raised in the scalar semantics
- typed fast paths are *optimistic*: a bulk ``astype`` is attempted
  first, and only a chunk containing an unparseable cell falls back to
  the per-row loop that isolates exactly the failing rows
- ``try``/``withDefault`` merge per-row between expr and fallback
  columns; a row errs only where the scalar evaluation would raise
- validator rejection is evaluated columnar for the registry validators
  (has-geo / has-dtg / bounds-geo / index / none)

The scalar path stays the oracle: ``geomesa.ingest.vectorized=false``
kills this path entirely, and ``geomesa.ingest.verify=true`` runs both
and asserts id-for-id equivalence per chunk.
"""

from __future__ import annotations

import io
import re
from itertools import zip_longest
from typing import Any

import numpy as np

from ..features.batch import FeatureBatch
from ..geometry import Point
from ..utils.properties import SystemProperty
from .dsl import _CASTS, _FUNCTIONS, EvaluationContext

try:  # the repo's WAL already rides on Arrow; ingest reuses it for CSV
    import pyarrow as pa
    from pyarrow import compute as pc
    from pyarrow import csv as pacsv
except Exception:  # pragma: no cover — arrow-less fallback stays live
    pa = None
    pc = None
    pacsv = None

__all__ = ["process_columnar", "process_columns", "INGEST_BATCH_ROWS",
           "INGEST_VECTORIZED", "INGEST_VERIFY", "INGEST_ARROW_CSV",
           "INGEST_ARROW_JSON"]

INGEST_BATCH_ROWS = SystemProperty("geomesa.ingest.batch.rows", "65536")
INGEST_VECTORIZED = SystemProperty("geomesa.ingest.vectorized", "true")
INGEST_VERIFY = SystemProperty("geomesa.ingest.verify", "false")
INGEST_ARROW_CSV = SystemProperty("geomesa.ingest.arrow.csv", "true")
INGEST_ARROW_JSON = SystemProperty("geomesa.ingest.arrow.json", "true")

# pads ragged delimited rows in the chunk transpose; a column reference
# that lands on the pad errs that row (the scalar path's IndexError)
_MISSING = object()


class _ArrowCol:
    """A string column still living in Arrow. The hot conversions
    (float/timestamp casts, element-wise join) run on ``arr`` in C++
    with the GIL released; ``objs()`` materializes Python strings once,
    lazily, for everything else."""

    __slots__ = ("arr", "_obj")

    def __init__(self, arr):
        self.arr = arr
        self._obj = None

    def __len__(self) -> int:
        return len(self.arr)

    def objs(self) -> np.ndarray:
        if self._obj is None:
            self._obj = np.asarray(
                self.arr.to_numpy(zero_copy_only=False), dtype=object)
        return self._obj


def parse_csv_arrow(joined: str, delimiter: str):
    """One quote-free CSV chunk -> Arrow string columns, or None when
    Arrow is unavailable or the chunk isn't rectangular (ragged rows
    raise inside read_csv; the caller's split path isolates them
    row-for-row). Column types are pinned to string so transforms — not
    the reader — decide every conversion, exactly like the scalar
    path."""
    if pacsv is None or not INGEST_ARROW_CSV.as_bool():
        return None
    nl = joined.find("\n")
    first = joined[:nl] if nl >= 0 else joined
    w = first.count(delimiter) + 1
    names = [f"c{i}" for i in range(1, w + 1)]
    try:
        table = pacsv.read_csv(
            io.BytesIO(joined.encode("utf-8")),
            read_options=pacsv.ReadOptions(column_names=names),
            parse_options=pacsv.ParseOptions(delimiter=delimiter,
                                             quote_char=False),
            convert_options=pacsv.ConvertOptions(
                column_types={nm: pa.string() for nm in names}))
    except Exception:
        return None
    n = table.num_rows
    if n == 0:
        return None
    cols: list[Any] = [np.full(n, "", dtype=object)]
    for i in range(w):
        cols.append(_ArrowCol(table.column(i).combine_chunks()))
    return cols, n, False, 0


def parse_json_arrow(joined: str, paths: list[str]):
    """One block of JSON-lines -> converter columns, or None when Arrow
    (or its json module) is unavailable, the block fails to parse
    (malformed line, mixed field types), or a declared path needs
    semantics ``read_json`` can't give (list indexing). Declared paths
    resolve through Arrow struct columns in C; string results stay in
    Arrow (``_ArrowCol``) for the C cast paths, everything else
    materializes to python objects so null/err semantics match the
    scalar ``_resolve`` exactly (missing field -> None column)."""
    if pa is None or not INGEST_ARROW_JSON.as_bool():
        return None
    norm = [p.replace("$.", "").split(".") for p in paths]
    if any(part.isdigit() for parts in norm for part in parts):
        return None  # list-index path: scalar traversal only
    try:
        from pyarrow import json as pajson
    except Exception:  # pragma: no cover — arrow build without json
        return None
    try:
        table = pajson.read_json(io.BytesIO(joined.encode("utf-8")))
    except Exception:
        return None
    n = table.num_rows
    if n == 0:
        return None
    # $0 (the parsed record) is never materialized here; converters
    # whose transforms read it stay on the record path
    cols: list[Any] = [np.full(n, None, dtype=object)]
    for parts in norm:
        try:
            arr = table.column(parts[0]).combine_chunks()
            for part in parts[1:]:
                arr = pc.struct_field(arr, part)
        except (KeyError, pa.ArrowInvalid, pa.ArrowTypeError,
                TypeError):
            # absent field / non-struct traversal: the scalar resolve
            # yields None for every row
            cols.append(np.full(n, None, dtype=object))
            continue
        if pa.types.is_string(arr.type) or pa.types.is_large_string(
                arr.type):
            cols.append(_ArrowCol(arr))
        else:
            vals = np.empty(n, dtype=object)
            vals[:] = arr.to_pylist()
            cols.append(vals)
    return cols, n, False, 0


class _XY:
    """Packed point column: x/y float arrays instead of Point objects.

    This is the vectorized ``point(x, y)`` result — it flows straight
    into ``FeatureBatch.from_dict``'s (x_array, y_array) fast path
    without ever materializing per-row Point objects.
    """

    __slots__ = ("x", "y")

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = x
        self.y = y

    def materialize(self) -> np.ndarray:
        out = np.empty(len(self.x), dtype=object)
        for i in range(len(self.x)):
            out[i] = Point(float(self.x[i]), float(self.y[i]))
        return out


def _as_object(vals) -> np.ndarray:
    if isinstance(vals, _XY):
        return vals.materialize()
    if isinstance(vals, _ArrowCol):
        return vals.objs()
    if vals.dtype == object:
        return vals
    return vals.astype(object)


def _to_float(vals, err: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Column float(v): bulk cast, per-row fallback on a dirty chunk."""
    if isinstance(vals, _XY):
        return np.zeros(len(vals.x)), np.ones(len(vals.x), dtype=bool)
    if isinstance(vals, _ArrowCol):
        try:  # C++ parse, no Python string materialization
            f = pc.cast(vals.arr, pa.float64()).to_numpy(
                zero_copy_only=False)
            return np.asarray(f, dtype=np.float64), err
        except Exception:
            vals = vals.objs()
    if vals.dtype == np.float64:
        return vals, err
    if vals.dtype.kind in "if" or vals.dtype == bool:
        return vals.astype(np.float64), err
    try:
        return np.asarray(vals, dtype=np.float64), err
    except (TypeError, ValueError):
        pass
    n = len(vals)
    out = np.zeros(n)
    err = err.copy()
    for i in range(n):
        if err[i]:
            continue
        try:
            out[i] = float(vals[i])
        except (TypeError, ValueError):
            err[i] = True
    return out, err


def _cast_int(vals, err):
    f, err = _to_float(vals, err)
    # scalar int(float(v)) raises on nan/inf; astype would wrap silently
    bad = ~np.isfinite(f)
    if bad.any():
        err = err | bad
        f = np.where(bad, 0.0, f)
    return f.astype(np.int64), err


def _cast_string(vals, err):
    if isinstance(vals, _XY):
        vals = vals.materialize()
    if isinstance(vals, _ArrowCol):
        return vals.objs(), err
    if vals.dtype.kind == "U":  # already strings (np.str_ IS str)
        return vals, err
    if vals.dtype != object:
        vals = vals.astype(object)
    return np.array([str(v) for v in vals], dtype=object), err


def _cast_bool(vals, err):
    fn = _CASTS["boolean"]
    vals = _as_object(vals)
    return np.array([fn(v) for v in vals], dtype=bool), err


def _parse_dates_bulk(vals, err):
    """isoDate / datetime: one bulk datetime64 parse, per-row fallback."""
    if isinstance(vals, _ArrowCol):
        try:  # trim + ISO parse stay in C; Z must go (zone-naive cast)
            trimmed = pc.utf8_rtrim(pc.utf8_trim_whitespace(vals.arr), "Z")
            ms = pc.cast(pc.cast(trimmed, pa.timestamp("ms")), pa.int64())
            return (np.asarray(ms.to_numpy(zero_copy_only=False),
                               dtype=np.int64), err)
        except Exception:
            pass
    vals = _as_object(vals)
    n = len(vals)
    try:
        cleaned = [str(v).strip().rstrip("Z") for v in vals]
        return (np.array(cleaned, dtype="datetime64[ms]").astype(np.int64),
                err)
    except (TypeError, ValueError):
        pass
    out = np.zeros(n, dtype=np.int64)
    err = err.copy()
    for i in range(n):
        if err[i]:
            continue
        try:
            out[i] = int(np.datetime64(str(vals[i]).strip().rstrip("Z"),
                                       "ms").astype(np.int64))
        except (TypeError, ValueError):
            err[i] = True
    return out, err


def _merge(err_a, vals_a, vals_b):
    """Rows of b where err_a, else a (the try/withDefault select)."""
    if isinstance(vals_a, _XY) and isinstance(vals_b, _XY):
        return _XY(np.where(err_a, vals_b.x, vals_a.x),
                   np.where(err_a, vals_b.y, vals_a.y))
    a, b = _as_object(vals_a), _as_object(vals_b)
    return np.where(err_a, b, a)


class _Evaluator:
    """One chunk's evaluation state: input columns + computed fields."""

    def __init__(self, cols: list[np.ndarray], n: int, ragged: bool):
        self.cols = cols
        self.n = n
        self.ragged = ragged
        self.fields: dict[str, tuple[Any, np.ndarray]] = {}
        self._zero_err = np.zeros(n, dtype=bool)

    def eval(self, node: tuple) -> tuple[Any, np.ndarray]:
        kind = node[0]
        if kind == "col":
            idx = node[1]
            if idx >= len(self.cols):
                return (np.full(self.n, None, dtype=object),
                        np.ones(self.n, dtype=bool))
            vals = self.cols[idx]
            if self.ragged:
                err = np.fromiter((v is _MISSING for v in vals), dtype=bool,
                                  count=self.n)
                if err.any():
                    return vals, err
            return vals, self._zero_err
        if kind == "field":
            got = self.fields.get(node[1])
            if got is None:
                # scalar raises per record: every row fails
                return (np.full(self.n, None, dtype=object),
                        np.ones(self.n, dtype=bool))
            return got
        if kind == "lit":
            v = node[1]
            if isinstance(v, float):
                return np.full(self.n, v), self._zero_err
            if isinstance(v, int) and not isinstance(v, bool):
                return np.full(self.n, v, dtype=np.int64), self._zero_err
            return np.full(self.n, v, dtype=object), self._zero_err
        if kind == "relit":
            return np.full(self.n, node[1], dtype=object), self._zero_err
        if kind == "recast":
            return self._apply_rowwise(lambda v: re.compile(str(v)),
                                       [node[1]])
        if kind == "cast":
            name = node[1]
            vals, err = self.eval(node[2])
            if name in ("int", "integer", "long"):
                return _cast_int(vals, err)
            if name in ("float", "double"):
                return _to_float(vals, err)
            if name == "string":
                return _cast_string(vals, err)
            if name == "boolean":
                return _cast_bool(vals, err)
            return self._apply_rowwise(_CASTS[name], [node[2]])
        if kind == "try":
            vals, err = self.eval(node[1])
            if not err.any():
                return vals, err
            fvals, ferr = self.eval(node[2])
            return _merge(err, vals, fvals), err & ferr
        if kind == "withdefault":
            vals, err = self.eval(node[1])
            need = self._null_or_empty(vals) & ~err
            if not need.any():
                return vals, err
            dvals, derr = self.eval(node[2])
            return _merge(need, vals, dvals), err | (need & derr)
        return self._eval_fn(node[1], node[2])

    def _null_or_empty(self, vals) -> np.ndarray:
        if isinstance(vals, _XY):
            return self._zero_err
        if isinstance(vals, _ArrowCol):
            return np.asarray(
                pc.equal(vals.arr, "").to_numpy(zero_copy_only=False),
                dtype=bool)
        if vals.dtype.kind == "U":
            return np.asarray(vals == "")
        if vals.dtype != object:
            return self._zero_err
        return np.fromiter((v is None or v == "" for v in vals),
                           dtype=bool, count=self.n)

    def _eval_fn(self, name: str, arg_nodes: list) -> tuple[Any, np.ndarray]:
        if name == "point" and len(arg_nodes) == 2:
            xv, xe = self.eval(arg_nodes[0])
            yv, ye = self.eval(arg_nodes[1])
            x, xe = _to_float(xv, xe)
            y, ye = _to_float(yv, ye)
            return _XY(x, y), xe | ye
        if name in ("concat", "concatenate") and arg_nodes:
            # str() never raises: join without the per-row try machinery
            cols, err = [], self._zero_err
            for a in arg_nodes:
                v, e = self.eval(a)
                cols.append(v)
                err = err | e
            if any(isinstance(v, _ArrowCol) for v in cols):
                try:
                    # stay in Arrow: lits broadcast as scalars, "" separator
                    parts = []
                    for a, v in zip(arg_nodes, cols):
                        if isinstance(v, _ArrowCol):
                            parts.append(v.arr)
                        elif a[0] in ("lit", "relit"):
                            parts.append(str(a[1]))
                        else:
                            parts.append(pa.array(
                                [str(x) for x in _as_object(v)],
                                type=pa.string()))
                    return (_ArrowCol(
                        pc.binary_join_element_wise(*parts, "")), err)
                except Exception:
                    pass
            try:
                # fixed-width string concat is a single C op per arg;
                # np.asarray(..., "U") applies str() like the scalar join
                us = [v if isinstance(v, _ArrowCol) or (
                          not isinstance(v, _XY) and v.dtype.kind == "U")
                      else np.asarray(_as_object(v), dtype="U")
                      for v in cols]
                us = [np.asarray(v.objs(), dtype="U")
                      if isinstance(v, _ArrowCol) else v for v in us]
                out = us[0]
                for u in us[1:]:
                    out = np.char.add(out, u)
                return out, err
            except (TypeError, ValueError):
                objs = [_as_object(v) for v in cols]
                out = np.empty(self.n, dtype=object)
                out[:] = ["".join(map(str, t)) for t in zip(*objs)]
                return out, err
        if name in ("isoDate", "datetime") and len(arg_nodes) == 1:
            vals, err = self.eval(arg_nodes[0])
            return _parse_dates_bulk(vals, err)
        if name in ("add", "subtract", "multiply", "divide", "mean",
                    "min", "max") and arg_nodes:
            cols, err = [], self._zero_err
            for a in arg_nodes:
                v, e = self.eval(a)
                v, e = _to_float(v, e)
                cols.append(v)
                err = err | e
            stacked = np.stack(cols)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = {"add": lambda s: s.sum(axis=0),
                       "subtract": lambda s: s[0] - s[1:].sum(axis=0),
                       "multiply": lambda s: s.prod(axis=0),
                       "divide": lambda s: _divide_reduce(s),
                       "mean": lambda s: s.mean(axis=0),
                       "min": lambda s: s.min(axis=0),
                       "max": lambda s: s.max(axis=0)}[name](stacked)
            return out, err
        return self._apply_rowwise(_FUNCTIONS[name], arg_nodes)

    def _apply_rowwise(self, fn, arg_nodes: list) -> tuple[Any, np.ndarray]:
        """Generic fallback: scalar registry function per surviving row."""
        cols, err = [], self._zero_err
        for a in arg_nodes:
            v, e = self.eval(a)
            cols.append(_as_object(v))
            err = err | e
        out = np.full(self.n, None, dtype=object)
        err = err.copy()
        if not arg_nodes:
            for i in range(self.n):
                try:
                    out[i] = fn()
                except Exception:
                    err[i] = True
            return out, err
        for i in range(self.n):
            if err[i]:
                continue
            try:
                out[i] = fn(*(c[i] for c in cols))
            except Exception:
                err[i] = True
        return out, err


def _divide_reduce(s: np.ndarray) -> np.ndarray:
    out = s[0].copy()
    for i in range(1, len(s)):
        out = out / s[i]
    return out


def _transpose(records: list[list]) -> tuple[list[np.ndarray], bool]:
    """Row lists -> object column arrays, padded where rows are ragged."""
    widths = {len(r) for r in records}
    ragged = len(widths) > 1
    cols = [np.array(c, dtype=object)
            for c in zip_longest(*records, fillvalue=_MISSING)]
    return cols, ragged


def _vector_validators(names, sft, values: dict, alive: np.ndarray,
                       n: int) -> np.ndarray:
    """Columnar registry validators; True marks a rejected row."""
    rejected = np.zeros(n, dtype=bool)
    geom, dtg = sft.geom_field, sft.dtg_field

    def _null_mask(col) -> np.ndarray:
        if isinstance(col, _XY):
            return np.zeros(n, dtype=bool)  # a Point object is never None
        col = _as_object(col)
        return np.fromiter((v is None for v in col), dtype=bool, count=n)

    def _oob_mask(col) -> np.ndarray:
        if isinstance(col, _XY):
            with np.errstate(invalid="ignore"):
                ok = ((col.x >= -180.0) & (col.x <= 180.0)
                      & (col.y >= -90.0) & (col.y <= 90.0))
            return ~ok
        col = _as_object(col)
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            g = col[i]
            if g is None or not alive[i] or rejected[i]:
                continue
            e = g.envelope
            if not (-180.0 <= e.xmin <= e.xmax <= 180.0
                    and -90.0 <= e.ymin <= e.ymax <= 90.0):
                out[i] = True
        return out

    for name in names:
        checks = ([name] if name != "index"
                  else ["has-geo", "has-dtg", "bounds-geo"])
        for c in checks:
            if c == "has-geo":
                rejected |= (np.ones(n, dtype=bool) if geom is None
                             else _null_mask(values[geom]))
            elif c == "has-dtg":
                rejected |= (np.ones(n, dtype=bool) if dtg is None
                             else _null_mask(values[dtg]))
            elif c == "bounds-geo" and geom is not None:
                rejected |= _oob_mask(values[geom])
    return rejected & alive


def process_columnar(converter, records: list[list],
                     ctx: EvaluationContext) -> FeatureBatch:
    """One chunk of ``_records`` output -> FeatureBatch, columnar.

    Counts exactly what the scalar loop would: every record bumps
    ``line``, masked/invalid rows bump ``failure``, emitted rows bump
    ``success``.
    """
    from .converter import _BAD_RECORD

    good = [r for r in records if r is not _BAD_RECORD]
    n_bad = len(records) - len(good)
    if not good:
        ctx.line += len(records)
        ctx.failure += n_bad
        return FeatureBatch.from_dict(
            converter.sft, [],
            {a.name: [] for a in converter.sft.attributes})
    cols, ragged = _transpose(good)
    return process_columns(converter, cols, len(good), ragged, n_bad, ctx)


def process_columns(converter, cols: list[np.ndarray], n: int,
                    ragged: bool, n_bad: int,
                    ctx: EvaluationContext) -> FeatureBatch:
    """Column arrays -> FeatureBatch (the core the chunk sources feed:
    ``_transpose`` of a record chunk, or a format's
    ``iter_column_chunks`` columnar parse)."""
    sft = converter.sft
    ctx.line += n + n_bad
    ev = _Evaluator(cols, n, ragged)
    dead = np.zeros(n, dtype=bool)
    for name, node in converter.ordered_asts:
        vals, err = ev.eval(node)
        ev.fields[name] = (vals, err)
        dead |= err
    id_vals, id_err = ev.eval(converter.id_ast)
    dead |= id_err
    # a field declared but never computed (not possible today) or an SFT
    # attr missing from fields errs every row, like the scalar KeyError
    values: dict[str, Any] = {}
    for a in sft.attributes:
        got = ev.fields.get(a.name)
        if got is None:
            dead[:] = True
            values[a.name] = np.full(n, None, dtype=object)
        else:
            values[a.name] = got[0]

    alive = ~dead
    if converter.validator_names:
        rejected = _vector_validators(converter.validator_names, sft,
                                      values, alive, n)
        alive = alive & ~rejected

    keep = np.flatnonzero(alive)
    if isinstance(id_vals, _ArrowCol):
        ids = id_vals.objs()[keep]  # already python str objects
    elif not isinstance(id_vals, _XY) and id_vals.dtype.kind == "U":
        ids = id_vals[keep]  # np.str_ IS str: no per-row re-wrap
    else:
        id_obj = _as_object(id_vals)
        ids = [str(id_obj[i]) for i in keep]
    out: dict[str, Any] = {}
    for a in sft.attributes:
        v = values[a.name]
        if isinstance(v, _XY) and a.type.name == "Point":
            out[a.name] = (v.x[keep], v.y[keep])
        elif isinstance(v, _XY):
            out[a.name] = v.materialize()[keep]
        elif isinstance(v, _ArrowCol):
            if a.type.name in ("String", "UUID"):
                # hand the Arrow array straight to StringColumn: its
                # dictionary-encode beats materializing 1 python str/row
                out[a.name] = (v.arr if len(keep) == n
                               else v.arr.take(keep))
            else:
                out[a.name] = v.objs()[keep]
        else:
            out[a.name] = v[keep]
    ctx.failure += n_bad + int(n - len(keep))
    ctx.success += len(keep)
    return FeatureBatch.from_dict(sft, ids, out)
