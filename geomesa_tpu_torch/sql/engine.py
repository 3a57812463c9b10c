"""SQL execution: pushdown into the planner + device spatial joins.

Mirrors the reference's two catalyst rules
(geomesa-spark/geomesa-spark-sql/src/main/scala/org/apache/spark/sql/
SQLRules.scala):

- STContainsRule (:99): spatial/attribute predicates in WHERE are
  rewritten to Filter AST at parse time and handed to the store's
  planner as a Query — the same cost-based index selection the ECQL
  path gets, so `SELECT ... WHERE ST_Contains(...)` and the equivalent
  ECQL text produce identical plans and identical feature IDs.
- SpatialJoinStrategy (:270): `JOIN b ON ST_DWithin/ST_Contains/
  ST_Intersects` routes to the join kernels on the store's device
  (analytics/join.py) instead of a nested-loop evaluation, with
  single-side WHERE conjuncts pushed below the join
  (GeoMesaJoinRelation.buildScan:312-360). A join side that covers a
  whole point table hands the kernels the store's resident device
  columns, so no coordinates upload per statement.

Aggregates (COUNT/MIN/MAX/SUM/AVG) reduce over the query result
columns on the host, as numpy segment reduces; ORDER BY / LIMIT push
into Query.sort_by / max_features.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..features.batch import (FeatureBatch, GeometryColumn, PointColumn)
from ..filters import ast
from ..index.api import Query
from .parser import SelectItem, SqlJoin, SqlSelect, parse_sql

# |a| x |b| above which a spatial join with two large sides routes
# through grid partitioning instead of the direct tiled kernel, and
# the minimum small-side size for the route (module globals so tests
# can exercise the branch at test scale)
_PARTITION_PAIR_BUDGET = 2e11
_PARTITION_MIN_SIDE = 50_000

__all__ = ["SqlEngine", "SqlResult"]


@dataclasses.dataclass
class SqlResult:
    """Columnar result table.

    ``plan`` is the EXPLAIN surface: what was pushed down, which legs
    ran, what merged where (or why execution stayed local). ``complete``
    / ``missing_groups`` / ``missing_z_ranges`` carry the cluster
    partial-results contract when the store allows partial answers."""
    names: list[str]
    columns: dict[str, np.ndarray]
    plan: dict | None = None
    complete: bool = True
    missing_groups: list = dataclasses.field(default_factory=list)
    missing_z_ranges: list = dataclasses.field(default_factory=list)

    @property
    def n(self) -> int:
        return 0 if not self.names else len(self.columns[self.names[0]])

    def rows(self) -> Iterator[tuple]:
        cols = [self.columns[n] for n in self.names]
        for i in range(self.n):
            yield tuple(c[i] for c in cols)

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]


def _strip_qualifier(f: ast.Filter, alias: str) -> ast.Filter:
    """Rewrite 'alias.col' props to 'col' for single-table execution."""
    def fix(name: str) -> str:
        if "." in name:
            q, col = name.split(".", 1)
            if q != alias:
                raise ValueError(f"unknown table qualifier {q!r}")
            return col
        return name
    return _map_props(f, fix)


def _map_props(f: ast.Filter, fix) -> ast.Filter:
    if isinstance(f, (ast.And, ast.Or)):
        return type(f)([_map_props(c, fix) for c in f.children])
    if isinstance(f, ast.Not):
        return ast.Not(_map_props(f.child, fix))
    if hasattr(f, "prop"):
        # every Filter node (incl. SpatialPredicate subclasses, which
        # inherit the parent's dataclass fields) is a dataclass
        return dataclasses.replace(f, prop=fix(f.prop))
    return f


def _qualifier_of(f: ast.Filter) -> set[str]:
    """Table qualifiers referenced by the filter (empty = unqualified)."""
    out: set[str] = set()
    for node in ast.walk(f):
        prop = getattr(node, "prop", None)
        if prop and "." in prop:
            out.add(prop.split(".", 1)[0])
        elif prop:
            out.add("")
    return out


def _null_truth(f: ast.Filter):
    """Three-valued truth of a filter over an all-NULL row (SQL
    semantics for a LEFT join's NULL-extended side): True / False /
    None (UNKNOWN — excluded by WHERE)."""
    if isinstance(f, ast.IsNull):
        return True
    if isinstance(f, ast.Include):
        return True
    if isinstance(f, ast.Exclude):
        return False
    if isinstance(f, ast.Not):
        v = _null_truth(f.child)
        return None if v is None else not v
    if isinstance(f, ast.And):
        vals = [_null_truth(c) for c in f.children]
        if any(v is False for v in vals):
            return False
        return None if any(v is None for v in vals) else True
    if isinstance(f, ast.Or):
        vals = [_null_truth(c) for c in f.children]
        if any(v is True for v in vals):
            return True
        return None if any(v is None for v in vals) else False
    return None  # comparisons / LIKE / IN / spatial on NULL: UNKNOWN


def _factorize(col) -> tuple[np.ndarray, None]:
    """Column -> non-negative int64 dictionary codes; nulls form their
    own group (SQL GROUP BY collates NULLs together). Code 0 is the
    null group."""
    from ..features.batch import (BoolColumn, DateColumn, NumericColumn,
                                  StringColumn)
    valid = np.asarray(col.valid)
    n = len(valid)
    if isinstance(col, StringColumn):
        return col.codes.astype(np.int64) + 1, None  # -1 nulls -> 0
    if isinstance(col, BoolColumn):
        codes = np.where(valid, col.values.astype(np.int64) + 1, 0)
        return codes, None
    vals = getattr(col, "values", None)
    if vals is None:
        vals = getattr(col, "millis", None)
    if vals is None:
        raise ValueError(f"cannot GROUP BY column {col.name!r}")
    vals = np.asarray(vals)
    codes = np.zeros(n, dtype=np.int64)
    if valid.any():
        _, inv = np.unique(vals[valid], return_inverse=True)
        codes[valid] = inv.astype(np.int64) + 1
    return codes, None


def _order_limit(out: SqlResult, order: str | None, desc: bool,
                 limit: int | None) -> SqlResult:
    """Post-aggregation ORDER BY / LIMIT over result columns (grouped
    queries sort their OUTPUT, not the source rows)."""
    if order is not None:
        if order not in out.columns:
            raise ValueError(f"ORDER BY column {order!r} is not in the "
                             f"select list")
        vals = out.columns[order]
        idx = sorted(range(out.n),
                     key=lambda i: (vals[i] is None, vals[i]),
                     reverse=desc)
        out = SqlResult(out.names, {k: v[idx]
                                    for k, v in out.columns.items()})
    if limit is not None and out.n > limit:
        out = SqlResult(out.names, {k: v[:limit]
                                    for k, v in out.columns.items()})
    return out


def _centroids(batch: FeatureBatch, geom_field: str):
    col = batch.col(geom_field)
    if isinstance(col, PointColumn):
        return col.x, col.y
    b = col.bounds
    return (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2


def _col_floats(col):
    """Numeric view of a column (values or millis), or None."""
    vals = getattr(col, "values", None)
    if vals is None:
        vals = getattr(col, "millis", None)
    if vals is not None and vals.dtype.kind == "b":
        vals = vals.astype(np.float64)
    return None if vals is None else np.asarray(vals, np.float64)


def _gather(col, idx):
    """(valid, floats|None, col, idx) for rows `idx` of `col`; idx may
    hold -1 for a LEFT join's NULL-extended rows (never valid). With
    idx None the view covers the column directly."""
    if idx is None:
        idx = np.arange(col.n, dtype=np.int64)
    safe = np.where(idx < 0, 0, idx)
    valid = np.asarray(col.valid)[safe] & (idx >= 0)
    floats = _col_floats(col)
    return valid, (None if floats is None else floats[safe]), col, idx


def _group_hull(col, idx, ginv, ng):
    """Per-group convex hull (the reference's ConvexHull UDAF,
    geomesa-spark-sql/.../udaf/ConvexHull.scala): pool every group
    member's vertices, monotone-chain hull per group. NULL for empty
    groups."""
    from ..analytics.st_functions import convex_hull_points
    if idx is None:
        idx = np.arange(col.n, dtype=np.int64)
    safe = np.where(idx < 0, 0, idx)
    valid = np.asarray(col.valid)[safe] & (idx >= 0)
    out = np.empty(ng, dtype=object)
    out[:] = None
    # one argsort gives every group's member rows as a contiguous
    # segment — O(n log n) total, not an O(n) mask per group
    vrows = np.flatnonzero(valid)
    order = vrows[np.argsort(ginv[vrows], kind="stable")]
    gsorted = ginv[order]
    grid = np.arange(ng)
    starts = np.searchsorted(gsorted, grid)
    ends = np.searchsorted(gsorted, grid, side="right")
    if isinstance(col, PointColumn):
        xs, ys = col.x[safe], col.y[safe]
        for g in range(ng):
            rows = order[starts[g]:ends[g]]
            if len(rows):
                out[g] = convex_hull_points(
                    np.stack([xs[rows], ys[rows]], axis=1))
        return out
    for g in range(ng):
        rows = order[starts[g]:ends[g]]
        if not len(rows):
            continue
        coords = [np.vstack(col.value(int(safe[i])).coords_list())
                  for i in rows]
        out[g] = convex_hull_points(np.vstack(coords))
    return out


def _group_extent(col, idx, ginv, ng):
    """Per-group bounding envelope (ST_Extent): vectorized min/max
    folds over point coordinates or geometry bounds, one box polygon
    per group, NULL for empty groups. An envelope fold is associative,
    which is what lets the cluster tier merge per-shard extents
    exactly."""
    from ..geometry.base import Envelope
    if idx is None:
        idx = np.arange(col.n, dtype=np.int64)
    safe = np.where(idx < 0, 0, idx)
    valid = np.asarray(col.valid)[safe] & (idx >= 0)
    if isinstance(col, PointColumn):
        x, y = np.asarray(col.x, np.float64)[safe], \
            np.asarray(col.y, np.float64)[safe]
        bx = np.stack([x, y, x, y], axis=1)
    else:
        bx = np.asarray(col.bounds, np.float64)[safe]
    out = np.empty(ng, dtype=object)
    out[:] = None
    if not valid.any():
        return out
    g = ginv[valid]
    vb = bx[valid]
    # segment reduce: one argsort (releases the GIL — shard legs fold
    # their extents concurrently) + reduceat per bound, instead of the
    # scalar-looped ufunc.at
    order = np.argsort(g, kind="stable")
    gsorted = g[order]
    vb = vb[order]
    starts = np.flatnonzero(np.diff(gsorted, prepend=gsorted[0] - 1))
    present = gsorted[starts]
    lo = np.minimum.reduceat(vb[:, :2], starts, axis=0)
    hi = np.maximum.reduceat(vb[:, 2:], starts, axis=0)
    for i, gi in enumerate(present):
        out[gi] = Envelope(lo[i, 0], lo[i, 1],
                           hi[i, 0], hi[i, 1]).to_polygon()
    return out


def _equi_pairs(acol, bcol) -> np.ndarray:
    """(a_row, b_row) match pairs of an equi-join ON a.col = b.col:
    unify both sides' value domains (dictionary codes for strings),
    then a sorted-merge emits each code's cross product — no hash
    table, no per-row Python. NULL never equals NULL (SQL)."""
    from ..features.batch import StringColumn
    from ..index.zkeys import multi_arange
    a_is_str = isinstance(acol, StringColumn)
    b_is_str = isinstance(bcol, StringColumn)
    if a_is_str != b_is_str:
        raise ValueError("equi-join column types do not match")
    if a_is_str:
        # the columns are already dictionary-encoded with sorted
        # vocabs: intersect the vocabs (tiny) and remap codes — no
        # per-row string materialization
        common, ca, cb = np.intersect1d(acol.vocab.astype(str),
                                        bcol.vocab.astype(str),
                                        assume_unique=True,
                                        return_indices=True)
        if not len(common):
            return np.empty((0, 2), dtype=np.int64)
        amap = np.full(len(acol.vocab), -1, dtype=np.int64)
        amap[ca] = np.arange(len(common))
        bmap = np.full(len(bcol.vocab), -1, dtype=np.int64)
        bmap[cb] = np.arange(len(common))
        ac_all = np.where(acol.codes >= 0, amap[acol.codes], -1)
        bc_all = np.where(bcol.codes >= 0, bmap[bcol.codes], -1)
        a_rows = np.flatnonzero(ac_all >= 0)
        b_rows = np.flatnonzero(bc_all >= 0)
        if not len(a_rows) or not len(b_rows):
            return np.empty((0, 2), dtype=np.int64)
        ac, bc = ac_all[a_rows], bc_all[b_rows]
        a_keep = np.ones(len(a_rows), dtype=bool)
        b_keep = np.ones(len(b_rows), dtype=bool)
    else:
        af, bf = _col_floats(acol), _col_floats(bcol)
        if af is None or bf is None:
            raise ValueError("equi-join needs comparable column types")
        a_rows = np.flatnonzero(np.asarray(acol.valid))
        b_rows = np.flatnonzero(np.asarray(bcol.valid))
        if not len(a_rows) or not len(b_rows):
            return np.empty((0, 2), dtype=np.int64)
        ua, ainv = np.unique(af[a_rows], return_inverse=True)
        ub, binv = np.unique(bf[b_rows], return_inverse=True)
        common, ca, cb = np.intersect1d(ua, ub, assume_unique=True,
                                        return_indices=True)
        if not len(common):
            return np.empty((0, 2), dtype=np.int64)
        amap = np.full(len(ua), -1, dtype=np.int64)
        amap[ca] = np.arange(len(common))
        bmap = np.full(len(ub), -1, dtype=np.int64)
        bmap[cb] = np.arange(len(common))
        ac, bc = amap[ainv], bmap[binv]
        a_keep, b_keep = ac >= 0, bc >= 0
    ao = np.argsort(ac[a_keep], kind="stable")
    a_sorted, acodes = a_rows[a_keep][ao], ac[a_keep][ao]
    bo = np.argsort(bc[b_keep], kind="stable")
    b_sorted, bcodes = b_rows[b_keep][bo], bc[b_keep][bo]
    grid = np.arange(len(common))
    bstart = np.searchsorted(bcodes, grid)
    bend = np.searchsorted(bcodes, grid, side="right")
    s, e = bstart[acodes], bend[acodes]
    a_side = np.repeat(a_sorted, e - s)
    b_side = b_sorted[multi_arange(s, e)]
    return np.stack([a_side, b_side], axis=1).astype(np.int64)


def _factorize_gathered(col, idx):
    """_factorize over an index-gathered view (NULL-extended rows join
    the null group 0)."""
    from ..features.batch import StringColumn
    if idx is None:
        idx = np.arange(col.n, dtype=np.int64)
    safe = np.where(idx < 0, 0, idx)
    if isinstance(col, StringColumn):
        codes = col.codes[safe].astype(np.int64) + 1
        codes[idx < 0] = 0
        return codes
    valid = np.asarray(col.valid)[safe] & (idx >= 0)
    floats = _col_floats(col)
    if floats is None:
        raise ValueError(f"cannot GROUP BY column {col.name!r}")
    vals = floats[safe]
    codes = np.zeros(len(idx), dtype=np.int64)
    if valid.any():
        _, inv = np.unique(vals[valid], return_inverse=True)
        codes[valid] = inv.astype(np.int64) + 1
    return codes


class SqlEngine:
    """Executes SELECTs against one datastore's feature types. The joins
    run on the store's device (``store.device``; a store without one
    means CUDA)."""

    def __init__(self, store):
        self.store = store
        self.device = getattr(store, "device", None)

    def query(self, text: str) -> SqlResult:
        sel = parse_sql(text)
        reason = None
        cluster = self._cluster_store()
        if cluster is not None:
            from .distributed import try_distributed
            out, reason = try_distributed(self, cluster, sel, text)
            if out is not None:
                return out
        self.__dict__.pop("_join_order_note", None)
        res = self._join_query(sel) if sel.joins else \
            self._single_table(sel)
        if res.plan is None:
            res.plan = {"mode": ("cluster-materialize"
                                 if cluster is not None else "local"),
                        "distributed": False}
            if reason:
                res.plan["fallback_reason"] = str(reason)
                cost = getattr(reason, "cost", None)
                if cost:
                    res.plan["cost"] = cost
            note = self.__dict__.pop("_join_order_note", None)
            if note:
                res.plan["join_order"] = note
        return res

    def _cluster_store(self):
        """The store as a ClusterDataStore, or None — the gate for the
        distributed planner."""
        from ..cluster.coordinator import ClusterDataStore
        return self.store if isinstance(self.store, ClusterDataStore) \
            else None

    # -- single table ------------------------------------------------------

    def _single_table(self, sel: SqlSelect) -> SqlResult:
        if sel.having and sel.group_by is None:
            raise ValueError("HAVING requires GROUP BY")
        where = (_strip_qualifier(sel.where, sel.alias)
                 if sel.where is not None else ast.Include())
        # scalar ST_* calls are per-row projections, not aggregates
        aggs = [i for i in sel.items if i.agg and i.agg != "st"]
        plain = [i for i in sel.items if not i.agg or i.agg == "st"]
        order = sel.order_by
        if order and "." in order:
            order = order.split(".", 1)[1]
        if sel.group_by is not None:
            keys = [k.split(".", 1)[1] if "." in k else k
                    for k in sel.group_by]
            for it in plain:
                name = it.expr.split(".")[-1]
                if name not in keys:
                    raise ValueError(f"column {it.expr!r} must appear in "
                                     f"GROUP BY or an aggregate")
            res = self.store.query(Query(sel.table, where))
            out = self._grouped(sel.items, keys, res.batch,
                                having=sel.having)
            # output names may keep the qualifier ('g.name'): accept
            # the raw ORDER BY target when the stripped one is absent
            if sel.order_by is not None and order not in out.columns \
                    and sel.order_by in out.columns:
                order = sel.order_by
            return _order_limit(out, order, sel.order_desc, sel.limit)
        if aggs and plain:
            raise ValueError("cannot mix aggregates and plain columns "
                             "without GROUP BY")
        q = Query(sel.table, where,
                  sort_by=None if aggs else order,
                  sort_desc=sel.order_desc,
                  max_features=None if aggs else sel.limit)
        res = self.store.query(q)
        if aggs:
            return self._aggregate(aggs, res.batch, res.n)
        return self._project(plain, res.batch, res.ids, sel.alias)

    @staticmethod
    def _reduce_item(it: SelectItem, ginv, ng: int, col, idx):
        """One aggregate over grouped rows (vectorized segment reduces:
        bincount / min.at / max.at; hull pooling for convex_hull). idx
        indirects into col (None = direct); -1 rows are NULL."""
        if it.agg not in ("count", "sum", "avg", "min", "max",
                          "convex_hull", "extent"):
            raise ValueError(f"not an aggregate: {it.name} (HAVING "
                             f"terms must aggregate or be group keys)")
        if it.agg == "count" and it.expr == "*":
            return np.bincount(ginv, minlength=ng).astype(np.int64)
        if it.agg == "convex_hull":
            return _group_hull(col, idx, ginv, ng)
        if it.agg == "extent":
            return _group_extent(col, idx, ginv, ng)
        valid, vals, _, _ = _gather(col, idx)
        if it.agg == "count":
            return np.bincount(ginv, weights=valid.astype(np.float64),
                               minlength=ng).astype(np.int64)
        if vals is None:
            raise ValueError(f"cannot aggregate column {it.expr}")
        nvalid = np.bincount(ginv, weights=valid.astype(np.float64),
                             minlength=ng)
        if it.agg in ("sum", "avg"):
            s = np.bincount(ginv, weights=np.where(valid, vals, 0.0),
                            minlength=ng)
            out = s if it.agg == "sum" else \
                np.divide(s, nvalid, out=np.zeros(ng), where=nvalid > 0)
        else:
            fill = np.inf if it.agg == "min" else -np.inf
            out = np.full(ng, fill)
            op = np.minimum if it.agg == "min" else np.maximum
            vr = np.flatnonzero(valid)
            if len(vr):
                # segment reduce via one argsort (releases the GIL, so
                # concurrent shard legs overlap) + reduceat, instead of
                # the scalar-looped ufunc.at
                order = vr[np.argsort(ginv[vr], kind="stable")]
                gs = ginv[order]
                starts = np.flatnonzero(
                    np.diff(gs, prepend=gs[0] - 1))
                out[gs[starts]] = op.reduceat(vals[order], starts)
        # SQL semantics: a group with no non-null values yields NULL
        res = np.empty(ng, dtype=object)
        for g in range(ng):
            res[g] = None if nvalid[g] == 0 else out[g]
        return res

    @staticmethod
    def _apply_having(out: SqlResult, having, compute) -> SqlResult:
        """Filter grouped output rows by the HAVING conjuncts. Each
        condition's aggregate reuses a select-list column when present,
        else `compute(item)` evaluates it over the same groups."""
        if not having:
            return out
        keep = np.ones(out.n, dtype=bool)
        for cond in having:
            if cond.item.name in out.columns:
                vals = out.columns[cond.item.name]
            else:
                vals = compute(cond.item)
            v = np.asarray(vals, dtype=object)
            ok = np.zeros(len(v), dtype=bool)
            for i, x in enumerate(v):
                if x is None:
                    continue
                ok[i] = {"=": x == cond.value,
                         "<>": x != cond.value,
                         "<": x < cond.value, ">": x > cond.value,
                         "<=": x <= cond.value,
                         ">=": x >= cond.value}[cond.op]
            keep &= ok
        return SqlResult(out.names,
                         {k: c[keep] for k, c in out.columns.items()})

    def _grouped(self, items: list[SelectItem], keys: list[str],
                 batch, having=None) -> SqlResult:
        """Grouped aggregation (GeoMesaSparkSQL.scala:212 grouped
        relations): factorize the key columns into dictionary codes,
        combine into one group id, and run vectorized segment reduces
        per aggregate — the columnar analog of a per-group shuffle."""
        names = [it.name for it in items]
        if batch is None or batch.n == 0:
            return SqlResult(names, {n: np.empty(0, object)
                                     for n in names})
        n = batch.n
        gid = np.zeros(n, dtype=np.int64)
        bound = 1
        for k in keys:
            codes, _ = _factorize(batch.col(k))
            cmax = int(codes.max()) + 1
            if bound > (1 << 60) // max(cmax, 1):
                # re-compact so multi-key composites never overflow
                _, gid = np.unique(gid, return_inverse=True)
                bound = int(gid.max()) + 1
            gid = gid * cmax + codes
            bound *= cmax
        if bound <= max(4 * n, 1 << 20):
            # small code domain: O(n) bincount compaction instead of
            # the O(n log n) argsort inside np.unique
            counts = np.bincount(gid, minlength=bound)
            present = np.flatnonzero(counts)
            remap = np.empty(bound, np.int64)
            remap[present] = np.arange(len(present), dtype=np.int64)
            ginv = remap[gid]
            member = np.empty(bound, np.int64)
            member[gid] = np.arange(n, dtype=np.int64)
            rep = member[present]   # any member row represents its group
            ng = len(present)
        else:
            uniq, rep, ginv = np.unique(gid, return_index=True,
                                        return_inverse=True)
            ng = len(uniq)

        def col_of(it):
            return batch.col(it.expr.split(".")[-1]) \
                if it.expr != "*" else None

        def key_values(it):
            col = col_of(it)
            return np.array([col.value(int(i)) for i in rep],
                            dtype=object)

        cols: dict[str, np.ndarray] = {}
        for it in items:
            if not it.agg:
                cols[it.name] = key_values(it)
                continue
            cols[it.name] = self._reduce_item(it, ginv, ng,
                                              col_of(it), None)

        def compute(it):
            if not it.agg and it.expr.split(".")[-1] in keys:
                return key_values(it)  # HAVING on a group key
            return self._reduce_item(it, ginv, ng, col_of(it), None)

        return self._apply_having(SqlResult(names, cols), having,
                                  compute)

    def _aggregate(self, items: list[SelectItem], batch, n: int) -> SqlResult:
        names, cols = [], {}
        for it in items:
            name = it.name
            names.append(name)
            if it.agg == "count" and it.expr == "*":
                cols[name] = np.array([n], dtype=np.int64)
                continue
            if it.agg in ("convex_hull", "extent"):
                if batch is None or n == 0:
                    cols[name] = np.array([None], dtype=object)
                else:
                    fn = _group_hull if it.agg == "convex_hull" \
                        else _group_extent
                    cols[name] = fn(
                        batch.col(it.expr.split(".")[-1]), None,
                        np.zeros(n, dtype=np.int64), 1)
                continue
            col = batch.col(it.expr.split(".")[-1]) if batch else None
            if it.agg == "count":
                # COUNT(col) skips nulls (SQL semantics)
                cols[name] = np.array(
                    [0 if col is None else int(col.valid.sum())],
                    dtype=np.int64)
                continue
            if col is None or n == 0:
                cols[name] = np.array([None], dtype=object)
                continue
            vals = getattr(col, "values", None)
            if vals is None:
                vals = getattr(col, "millis", None)
            if vals is None:
                raise ValueError(f"cannot aggregate column {it.expr}")
            vals = vals[col.valid]
            fn = {"min": np.min, "max": np.max, "sum": np.sum,
                  "avg": np.mean}[it.agg]
            cols[name] = np.array([fn(vals) if len(vals) else None])
        return SqlResult(names, cols)

    def _project(self, items: list[SelectItem], batch, ids,
                 alias: str) -> SqlResult:
        if batch is None:
            return SqlResult(["__fid__"], {"__fid__": np.empty(0, object)})
        names: list[str] = []
        cols: dict[str, np.ndarray] = {}

        def add(name: str, arr):
            names.append(name)
            cols[name] = arr

        star = any(i.expr == "*" for i in items)
        if star:
            add("__fid__", ids)
            for a in batch.sft.attributes:
                c = batch.col(a.name)
                add(a.name, np.array([c.value(i) for i in range(c.n)],
                                     dtype=object))
            return SqlResult(names, cols)
        for it in items:
            col_name = it.expr.split(".")[-1] if "." in it.expr else it.expr
            if col_name in ("__fid__", "id"):
                add(it.name, ids)
                continue
            if it.agg == "st" and col_name == "__const__":
                # all-literal constructor: one evaluation, broadcast
                from ..analytics.st_functions import SQL_SCALARS
                v = SQL_SCALARS[it.fn](*it.args)
                arr = np.empty(batch.n, dtype=object)
                arr.fill(v)
                add(it.name, arr)
                continue
            c = batch.col(col_name)
            vals = np.array([c.value(i) for i in range(c.n)],
                            dtype=object)
            if it.agg == "st":
                from ..analytics.st_functions import SQL_SCALARS
                fn = SQL_SCALARS[it.fn]
                vals = np.array([None if v is None else fn(v, *it.args)
                                 for v in vals], dtype=object)
            add(it.name, vals)
        return SqlResult(names, cols)

    # -- joins -------------------------------------------------------------

    def _join_query(self, sel: SqlSelect) -> SqlResult:
        if sel.having and sel.group_by is None:
            raise ValueError("HAVING requires GROUP BY")
        return self._join_query_inner(sel)

    def _join_query_inner(self, sel: SqlSelect) -> SqlResult:
        """Chained spatial joins (GeoMesaJoinRelation.buildScan analog,
        SQLRules.scala:270-360): each JOIN anchors to one preceding
        alias, runs a device join kernel, and expands the result rows;
        LEFT joins NULL-extend unmatched anchor rows. Single-side WHERE
        conjuncts push below the join — except conjuncts on a LEFT
        join's right side, which SQL applies AFTER NULL extension, so
        they evaluate post-join under three-valued logic."""
        aliases = [sel.alias] + [j.alias for j in sel.joins]
        if len(set(aliases)) != len(aliases):
            raise ValueError("duplicate table aliases in join")
        tables = {sel.alias: sel.table}
        for j in sel.joins:
            tables[j.alias] = j.table
        outer_aliases = {j.alias for j in sel.joins if j.outer}

        side_f: dict[str, list[ast.Filter]] = {a: [] for a in aliases}
        deferred: list[tuple[str, ast.Filter]] = []
        if sel.where is not None:
            conjuncts = (list(sel.where.children)
                         if isinstance(sel.where, ast.And) else [sel.where])
            for c in conjuncts:
                quals = _qualifier_of(c)
                if len(quals) != 1 or "" in quals:
                    raise ValueError("WHERE conjuncts must reference "
                                     "exactly one aliased table")
                a = next(iter(quals))
                if a not in side_f:
                    raise ValueError(f"unknown table qualifier {a!r} "
                                     f"(tables: {aliases})")
                if a in outer_aliases:
                    deferred.append((a, _strip_qualifier(c, a)))
                else:
                    side_f[a].append(_strip_qualifier(c, a))

        results = {}
        for a in aliases:
            fs = side_f[a]
            f = (ast.And(fs) if len(fs) > 1 else fs[0]) if fs \
                else ast.Include()
            results[a] = self.store.query(Query(tables[a], f))

        # COUNT(*)-only inner join: reduce on device, no pair arrays.
        # Only a well-formed ON (one side the joined alias, the other
        # the FROM alias) takes the shortcut — anything irregular falls
        # through to the pair path, which raises the proper errors.
        if (len(sel.joins) == 1 and not sel.joins[0].outer
                and not deferred and sel.group_by is None
                and sel.having is None and sel.joins[0].kind != "eq"
                and len(sel.items) == 1 and sel.items[0].agg == "count"
                and sel.items[0].expr == "*"):
            j = sel.joins[0]
            a_alias, a_col = j.left_prop.split(".", 1)
            b_alias, b_col = j.right_prop.split(".", 1)
            if {a_alias, b_alias} == {sel.alias, j.alias} \
                    and a_alias != b_alias:
                total = self._join_count(
                    j, results[a_alias], a_col, results[b_alias], b_col,
                    a_table=tables.get(a_alias), b_table=tables.get(b_alias))
                name = sel.items[0].name
                return SqlResult([name], {name: np.array([total])})

        # cost-based join ordering: greedy smallest-estimated-side
        # first over inner multi-join trees (estimates from the stats
        # sketches; bails to statement order when any side is cold or
        # the tree shape is irregular). Outer joins keep statement
        # order — NULL extension is order-sensitive.
        joins = list(sel.joins)
        if len(joins) >= 2 and not outer_aliases:
            from .planner import reorder_joins
            joins, note = reorder_joins(self.store, sel.alias, joins,
                                        tables, side_f)
            if note:
                self._join_order_note = note

        rows: dict[str, np.ndarray] = {
            sel.alias: np.arange(results[sel.alias].n, dtype=np.int64)}
        for j in joins:
            rows = self._apply_join(j, results, rows, tables)
        for a, f in deferred:
            keep = self._post_join_mask(f, results[a], rows[a])
            rows = {k: v[keep] for k, v in rows.items()}
        if sel.group_by is not None:
            out = self._grouped_join(sel, results, rows)
            order = sel.order_by
            if order is not None and order not in out.columns \
                    and order.split(".")[-1] in out.columns:
                order = order.split(".")[-1]
            return _order_limit(out, order, sel.order_desc, sel.limit)
        return self._project_join(sel, results, rows)

    def _grouped_join(self, sel: SqlSelect, results,
                      rows: dict[str, np.ndarray]) -> SqlResult:
        """GROUP BY over joined rows: factorize the (gathered) key
        columns, one composite group id per joined row, then the same
        vectorized segment reduces the single-table path uses. LEFT
        joins' NULL-extended rows land in the null group for keys on
        the outer side and contribute nothing to column aggregates."""
        names = [it.name for it in sel.items]
        nrows = len(next(iter(rows.values()))) if rows else 0
        keys = list(sel.group_by)
        for it in sel.items:
            # QUALIFIED comparison: a bare-name match would let the
            # same-named column of a different table through (its
            # per-group value is not constant)
            if not it.agg and it.expr not in keys:
                raise ValueError(f"column {it.expr!r} must appear in "
                                 f"GROUP BY or an aggregate")
        if nrows == 0:
            return SqlResult(names, {n: np.empty(0, object)
                                     for n in names})

        def split(q: str):
            if "." not in q:
                raise ValueError(f"join columns must be qualified: {q}")
            a, c = q.split(".", 1)
            if a not in rows:
                raise ValueError(f"unknown table qualifier {a!r} "
                                 f"(tables: {list(rows)})")
            return a, c

        def col_idx(it: SelectItem):
            if it.expr == "*":
                return None, None
            a, c = split(it.expr)
            if c in ("__fid__", "id"):
                if it.agg not in (None, "count"):
                    raise ValueError(f"cannot {it.agg} feature ids")
                from ..features.batch import NumericColumn
                nb = results[a].n
                return NumericColumn("__fid__", np.zeros(nb),
                                     np.ones(nb, dtype=bool)), rows[a]
            return results[a].batch.col(c), rows[a]

        gid = np.zeros(nrows, dtype=np.int64)
        for k in keys:
            a, c = split(k)
            if c in ("__fid__", "id"):
                codes = rows[a] + 1     # one group per feature; NULL=0
            else:
                codes = _factorize_gathered(results[a].batch.col(c),
                                            rows[a])
            gid = gid * (int(codes.max()) + 1) + codes
            _, gid = np.unique(gid, return_inverse=True)
        uniq, rep, ginv = np.unique(gid, return_index=True,
                                    return_inverse=True)
        ng = len(uniq)

        def key_values(it):
            a, c = split(it.expr)
            rep_idx = rows[a][rep]
            if c in ("__fid__", "id"):
                vals = [None if i < 0 else results[a].ids[int(i)]
                        for i in rep_idx]
            else:
                col = results[a].batch.col(c)
                vals = [None if i < 0 else col.value(int(i))
                        for i in rep_idx]
            return np.array(vals, dtype=object)

        cols: dict[str, np.ndarray] = {}
        for it in sel.items:
            if not it.agg:
                cols[it.name] = key_values(it)
                continue
            cols[it.name] = self._reduce_item(it, ginv, ng, *col_idx(it))

        def compute(it):
            if not it.agg and it.expr in keys:
                return key_values(it)  # HAVING on a group key
            return self._reduce_item(it, ginv, ng, *col_idx(it))

        return self._apply_having(SqlResult(names, cols), sel.having,
                                  compute)

    def _apply_join(self, join: SqlJoin, results,
                    rows: dict[str, np.ndarray],
                    tables: dict[str, str] | None = None
                    ) -> dict[str, np.ndarray]:
        """Expand the current result rows by one join: match the new
        table against its anchor alias, repeat matched rows, and (for
        LEFT joins) keep unmatched anchor rows with a -1 (NULL) index."""
        a_alias, a_col = join.left_prop.split(".", 1)   # first ON arg
        b_alias, b_col = join.right_prop.split(".", 1)  # second ON arg
        new = join.alias
        if a_alias == new and b_alias in rows:
            anchor = b_alias
            flip = True    # pairs arrive (new, anchor)
        elif b_alias == new and a_alias in rows:
            anchor = a_alias
            flip = False   # pairs arrive (anchor, new)
        else:
            raise ValueError(
                f"ON must reference {new!r} and one preceding table")
        if a_alias not in results or b_alias not in results:
            raise ValueError("ON predicate must reference joined tables")
        pairs = self._join_pairs(
            join, results[a_alias], a_col, results[b_alias], b_col,
            a_table=(tables or {}).get(a_alias),
            b_table=(tables or {}).get(b_alias))
        if flip and len(pairs):
            pairs = pairs[:, ::-1]

        from ..index.zkeys import multi_arange
        order = np.argsort(pairs[:, 0], kind="stable") if len(pairs) \
            else np.empty(0, np.int64)
        pa = pairs[order, 0] if len(pairs) else np.empty(0, np.int64)
        pb = pairs[order, 1] if len(pairs) else np.empty(0, np.int64)
        a_idx = rows[anchor]
        starts = np.searchsorted(pa, a_idx, side="left")
        ends = np.searchsorted(pa, a_idx, side="right")
        cnt = ends - starts
        cnt[a_idx < 0] = 0  # NULL-extended anchors match nothing
        out_cnt = np.maximum(cnt, 1) if join.outer else cnt
        rep = np.repeat(np.arange(len(a_idx), dtype=np.int64), out_cnt)
        total = int(out_cnt.sum())
        new_idx = np.full(total, -1, dtype=np.int64)
        off = np.cumsum(out_cnt) - out_cnt
        has = cnt > 0
        if has.any():
            dest = multi_arange(off[has], off[has] + cnt[has])
            src = multi_arange(starts[has], ends[has])
            new_idx[dest] = pb[src]
        out = {k: v[rep] for k, v in rows.items()}
        out[new] = new_idx
        return out

    def _device_xy(self, table: str | None, res, col: str):
        """The store's resident device coordinate columns (its scan
        data's f32 ``xhi``/``yhi``, capacity-padded) for a query result
        that covers the FULL table in row order — lets the join kernels
        skip re-uploading coordinates (at 10M+ rows the host->device
        transfer costs more than the scan) and reuse the x-sort cached
        on those columns. Returns None when the result is a subset or
        the store has no resident point scan data."""
        from ..store.memory import InMemoryDataStore
        ds = self.store
        if table is None or not isinstance(ds, InMemoryDataStore):
            return None
        try:
            st = ds._state(table)
        except KeyError:
            return None
        if res.n != st.n or not st.sft.is_points:
            return None
        if col != st.sft.geom_field:
            return None  # scan_data holds the DEFAULT geometry only
        st.ensure_index()
        sd = st.scan_data
        if sd is None:
            return None
        return sd.xhi, sd.yhi

    def _join_count(self, join: SqlJoin, a_res, a_col: str,
                    b_res, b_col: str, a_table: str | None = None,
                    b_table: str | None = None) -> int:
        """Total match count for one inner join WITHOUT materializing
        pairs: the count-reduce form of the device kernels
        (``dwithin_counts``, ``contains_counts``), fed the store's
        resident coordinates when the point side covers a full table
        (SELECT COUNT(*) FROM a JOIN b ON ... never pulls an (n, k)
        matrix to the host)."""
        if (a_res.n == 0 or b_res.n == 0
                or a_res.batch is None or b_res.batch is None):
            return 0
        from ..analytics.join import contains_join, dwithin_join
        if join.kind == "dwithin":
            ax, ay = _centroids(a_res.batch, a_col)
            bx, by = _centroids(b_res.batch, b_col)
            counts, _ = dwithin_join(
                ax, ay, bx, by, join.distance, counts_only=True,
                device_xy=self._device_xy(a_table, a_res, a_col),
                device=self.device)
        else:
            acol = a_res.batch.col(a_col)
            if not isinstance(acol, GeometryColumn):
                raise ValueError("contains join needs a polygon column "
                                 "as the first ON argument")
            bx, by = _centroids(b_res.batch, b_col)
            counts, _ = contains_join(
                acol.geoms, bx, by, counts_only=True,
                device_xy=self._device_xy(b_table, b_res, b_col),
                device=self.device)
        return int(counts.sum())

    def _join_pairs(self, join: SqlJoin, a_res, a_col: str,
                    b_res, b_col: str, a_table: str | None = None,
                    b_table: str | None = None) -> np.ndarray:
        """(a_row, b_row) match pairs in ON-argument order, from the
        device join kernels (analytics/join.py)."""
        if (a_res.n == 0 or b_res.n == 0
                or a_res.batch is None or b_res.batch is None):
            return np.empty((0, 2), dtype=np.int64)
        from ..analytics.join import contains_join, dwithin_join
        if join.kind == "eq":
            pairs = _equi_pairs(a_res.batch.col(a_col),
                                b_res.batch.col(b_col))
        elif join.kind == "dwithin":
            ax, ay = _centroids(a_res.batch, a_col)
            bx, by = _centroids(b_res.batch, b_col)
            # two LARGE sides: route through grid/quadtree spatial
            # partitioning (SpatialJoinStrategy -> zipPartitions,
            # SQLRules.scala:270, GeoMesaSparkSQL.scala:312-360) — the
            # direct kernel's work is O(|a| x |b|) and stops scaling
            # once both sides are big; per-cell joins bound it to
            # near-matching pairs
            if (len(ax) * len(bx) > _PARTITION_PAIR_BUDGET
                    and min(len(ax), len(bx)) > _PARTITION_MIN_SIDE):
                from ..analytics.partitioning import \
                    partitioned_dwithin_join
                pairs = partitioned_dwithin_join(ax, ay, bx, by,
                                                 join.distance,
                                                 device=self.device)
            else:
                _, pairs = dwithin_join(
                    ax, ay, bx, by, join.distance,
                    device_xy=self._device_xy(a_table, a_res, a_col),
                    device=self.device)
            # dwithin_join pairs are (a_idx, b_idx)
        else:
            # ST_Contains(a, b): a (polygons) contains b (points)
            acol = a_res.batch.col(a_col)
            if not isinstance(acol, GeometryColumn):
                raise ValueError("contains join needs a polygon column "
                                 "as the first ON argument")
            bx, by = _centroids(b_res.batch, b_col)
            _, pairs = contains_join(
                acol.geoms, bx, by,
                device_xy=self._device_xy(b_table, b_res, b_col),
                device=self.device)
            # contains_join pairs are (point_idx, poly_idx) = (b, a)
            if len(pairs):
                pairs = pairs[:, ::-1]
        if not len(pairs):
            return np.empty((0, 2), dtype=np.int64)
        return pairs

    def _post_join_mask(self, f: ast.Filter, res,
                        idx: np.ndarray) -> np.ndarray:
        """WHERE conjunct on a LEFT join's right side, applied after
        NULL extension: matched rows evaluate normally, NULL-extended
        rows take the conjunct's three-valued truth on an all-NULL row
        (only IS NULL-style predicates survive)."""
        from ..filters.evaluate import evaluate
        keep = np.zeros(len(idx), dtype=bool)
        matched = idx >= 0
        if matched.any() and res.batch is not None:
            row_ok = np.asarray(evaluate(f, res.batch), dtype=bool)
            keep[matched] = row_ok[idx[matched]]
        keep[~matched] = _null_truth(f) is True
        return keep

    def _project_join(self, sel: SqlSelect, results,
                      rows: dict[str, np.ndarray]) -> SqlResult:
        # scalar ST_* calls project per-row, like plain columns
        aggs = [i for i in sel.items if i.agg and i.agg != "st"]
        nrows = len(next(iter(rows.values()))) if rows else 0
        if aggs:
            if any(not i.agg or i.agg == "st" for i in sel.items):
                raise ValueError("cannot mix aggregates and plain "
                                 "columns without GROUP BY")
            # one implicit group over every joined row: the same
            # segment reduces the grouped path uses (COUNT/SUM/MIN/
            # MAX/AVG/convex_hull, NULL-extended rows skipped)
            cols = {}
            ginv = np.zeros(nrows, dtype=np.int64)
            for it in aggs:
                if it.expr == "*":
                    cols[it.name] = np.array([nrows])
                    continue
                if "." not in it.expr:
                    raise ValueError(
                        f"join columns must be qualified: {it.expr}")
                q, col = it.expr.split(".", 1)
                if q not in rows:
                    raise ValueError(f"unknown table qualifier {q!r}")
                idx = rows[q]
                if col in ("__fid__", "id"):
                    if it.agg != "count":
                        raise ValueError(f"cannot {it.agg} feature ids")
                    cols[it.name] = np.array([int((idx >= 0).sum())])
                    continue
                c = results[q].batch.col(col)
                cols[it.name] = self._reduce_item(it, ginv, 1, c, idx)
            return SqlResult([it.name for it in aggs], cols)
        names, cols = [], {}

        def add(name, arr):
            names.append(name)
            cols[name] = arr

        star = any(i.expr == "*" for i in sel.items)
        items = sel.items
        if star:
            items = [SelectItem(f"{a}.__fid__") for a in rows]
        for it in items:
            if "." not in it.expr:
                raise ValueError(f"join columns must be qualified: {it.expr}")
            q, col = it.expr.split(".", 1)
            if q not in rows:
                raise ValueError(f"unknown table qualifier {q!r} "
                                 f"(tables: {list(rows)})")
            res, idx = results[q], rows[q]
            out = np.empty(len(idx), dtype=object)
            m = idx >= 0
            if col in ("__fid__", "id"):
                out[m] = res.ids[idx[m]]
            else:
                c = res.batch.col(col)
                out[m] = [c.value(int(i)) for i in idx[m]]
            if it.agg == "st":
                from ..analytics.st_functions import SQL_SCALARS
                fn = SQL_SCALARS[it.fn]
                out = np.array([None if v is None else fn(v, *it.args)
                                for v in out], dtype=object)
            add(it.name if it.alias else it.expr, out)
        result = SqlResult(names, cols)
        order = sel.order_by
        return _order_limit(result, order, sel.order_desc, sel.limit)
