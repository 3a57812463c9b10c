"""Per-group partial-aggregate state for materialized views.

A view compiles a single-table GROUP BY aggregate statement (the distributed
SQL legs' mergeable shapes: COUNT/SUM/MIN/MAX natively, AVG as sum+count,
ST_ConvexHull/ST_Extent as geometry folds) into per-group accumulators
that fold each write-path delta in O(delta rows), with a retraction
story for deletes.

The correctness contract is *bit identity*: at any LSN the finalized
view equals re-running the statement from scratch with ``SqlEngine``
at that LSN — same values, same dtypes, same group order. That drives
several non-obvious choices:

- SUM/AVG accumulate in one ``np.float64`` per group, adding deltas in
  row order. ``np.bincount(ginv, weights=...)`` — the engine's reduce —
  is itself a sequential row-order accumulation per group, so the fold
  and the from-scratch reduce perform the *identical* sequence of
  float64 additions (invalid rows contribute the same ``+0.0``).
  Any deletion of a summed row marks the group dirty instead of
  subtracting: float subtraction does not invert the addition order.
- MIN/MAX keep bounded runner-up reservoirs: the K smallest (resp.
  largest) live ``(value, fid)`` pairs. Inserts and most deletes stay
  O(log K); only when a reservoir drains while valid rows remain does
  the group fall back to a targeted recompute (counted as a
  retraction fallback).
- Dirty groups replay with a *single-group* store query (WHERE AND
  key equality). Store scan strategies return row indices in table
  order, so the replayed reduce sees rows in the same order as a full
  re-execution — bit-identical by construction.
- Group keys follow the engine's factorize order: None first, values
  ascending, NaN last (``np.unique`` collapses NaNs). NaN float keys
  are normalized to a singleton sentinel so they can live in a dict.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..features.batch import PointColumn
from ..filters import ast
from ..geometry.base import Envelope
from ..index.api import Query
from ..sql.distributed import _plan_partials
from ..sql.engine import (SqlEngine, SqlResult, _col_floats, _order_limit,
                          _strip_qualifier)
from ..sql.parser import SelectItem, SqlSelect, parse_sql

__all__ = ["ViewState", "compile_view"]


class _NanKey:
    """Singleton stand-in for a NaN group-key float: hashable and
    equal to itself (dict key), and orders AFTER every real value —
    where ``np.unique`` places NaN."""

    def __lt__(self, other):
        return False

    def __gt__(self, other):
        return not isinstance(other, _NanKey)

    def __repr__(self):
        return "NaN"


_NAN_KEY = _NanKey()


def _norm_key(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return _NAN_KEY
    return v


def _denorm_key(v):
    return float("nan") if v is _NAN_KEY else v


def _sort_key(kt):
    return tuple((x is None, x) for x in kt)


class _NanKeyReplay(Exception):
    """A dirty group keyed by NaN cannot be re-queried with an exact
    Compare (NaN never equals) — the caller rebuilds the whole view."""


# -- slot specs --------------------------------------------------------------

class _SlotSpec:
    """One maintained accumulator: a numeric column's (cnt, nan, sum,
    reservoirs), a convex-hull fold, or an extent fold. Slots are
    deduped by (kind, column) so ``avg(x), max(x)`` share state."""

    __slots__ = ("kind", "col", "need_sum", "need_low", "need_high")

    def __init__(self, kind: str, col: str):
        self.kind = kind            # 'num' | 'hull' | 'extent'
        self.col = col
        self.need_sum = False
        self.need_low = False
        self.need_high = False


class _NumState:
    __slots__ = ("cnt", "nan", "sum", "int_ok", "absum", "low", "high",
                 "low_full", "high_full")

    def __init__(self):
        self.cnt = 0                # valid rows (NaN-valued included)
        self.nan = 0                # valid rows whose value is NaN
        self.sum = np.float64(0.0)
        # while every folded value is an exact-integer float and the
        # magnitude bound keeps all prefix sums < 2^53, the accumulator
        # is exact — retraction can SUBTRACT and stay bit-identical to
        # a from-scratch re-sum. Otherwise a retraction replays.
        self.int_ok = True
        self.absum = 0.0            # sum of |values|: prefix-sum bound
        # ascending (value, fid) lists; `full` means the list covers
        # EVERY live non-NaN value, so trims are loss-recorded. None
        # means drained (group is dirty).
        self.low: list | None = []
        self.high: list | None = []
        self.low_full = True
        self.high_full = True


class _GeoState:
    __slots__ = ("cnt", "geom", "lo", "hi")

    def __init__(self):
        self.cnt = 0                # valid geometry rows
        self.geom = None            # cached hull geometry
        self.lo = None              # extent mins (2,) float64
        self.hi = None              # extent maxs (2,) float64


class _Group:
    __slots__ = ("key", "nrows", "slots", "dirty", "row")

    def __init__(self, key: tuple, slots: list[_SlotSpec]):
        self.key = key
        self.nrows = 0
        self.slots = [(_NumState() if s.kind == "num" else _GeoState())
                      for s in slots]
        self.dirty = False
        self.row = None             # cached finalized values


# -- compile ------------------------------------------------------------------


def compile_view(sft, sql: str) -> "ViewState":
    """Parse + validate a statement into a ``ViewState``. Unsupported
    shapes refuse with a typed ``ValueError`` (parser errors are
    ``SqlError``, itself a ``ValueError``) so surfaces can map them to
    user errors, never shard/server failures."""
    sel = parse_sql(sql)
    if sel.joins:
        raise ValueError("materialized views support single-table "
                         "statements only (no JOIN)")
    if sel.group_by is None:
        raise ValueError(
            "materialized views require GROUP BY: ungrouped aggregates "
            "reduce pairwise and cannot be folded bit-identically")
    plan = _plan_partials(sel, qualified=False)
    if plan is None:
        raise ValueError(
            "statement has no mergeable aggregate form (COUNT/SUM/MIN/"
            "MAX/AVG/ST_ConvexHull/ST_Extent over one table)")
    _, _, comps, keys = plan
    # the same hidden-HAVING extension _plan_partials folded into comps
    ext: list[SelectItem] = list(sel.items)
    sel_names = {it.name for it in sel.items}
    for cond in (sel.having or []):
        if cond.item.agg and cond.item.name not in sel_names:
            ext.append(cond.item)
    by_name = {a.name: a for a in sft.attributes}
    for k in keys:
        if k not in by_name:
            raise ValueError(f"unknown column {k!r} in "
                             f"{sft.type_name!r}")
        if by_name[k].is_geometry:
            raise ValueError(f"cannot GROUP BY geometry column {k!r}")
    slots: list[_SlotSpec] = []
    slot_idx: dict[tuple, int] = {}

    def slot_for(kind: str, col: str) -> int:
        key = (kind, col)
        if key not in slot_idx:
            slot_idx[key] = len(slots)
            slots.append(_SlotSpec(kind, col))
        return slot_idx[key]

    for comp, it in zip(comps, ext):
        if comp["kind"] == "key":
            comp["slot"] = -1
            continue
        col = it.expr.split(".")[-1]
        if col != "*":
            if col not in by_name:
                raise ValueError(f"unknown column {col!r} in "
                                 f"{sft.type_name!r}")
            geo = by_name[col].is_geometry
            if comp["kind"] in ("hull", "extent") and not geo:
                raise ValueError(f"{comp['kind']} requires a geometry "
                                 f"column, got {col!r}")
            if comp["kind"] in ("sum", "avg", "min", "max") and (
                    geo or by_name[col].type.name in
                    ("String", "Bytes", "List", "Map")):
                raise ValueError(f"cannot aggregate column {col!r} "
                                 f"with {comp['kind']}")
        if comp["kind"] == "count" and col == "*":
            comp["slot"] = -1
            continue
        if comp["kind"] in ("count", "sum", "avg", "min", "max"):
            i = slot_for("num", col)
            if comp["kind"] in ("sum", "avg"):
                slots[i].need_sum = True
            elif comp["kind"] == "min":
                slots[i].need_low = True
            elif comp["kind"] == "max":
                slots[i].need_high = True
        else:
            i = slot_for(comp["kind"], col)
        comp["slot"] = i
    order = sel.order_by
    if order is not None:
        stripped = order.split(".", 1)[1] if "." in order else order
        if stripped not in sel_names and order not in sel_names:
            raise ValueError(f"ORDER BY column {order!r} is not in "
                             f"the select list")
    where = (_strip_qualifier(sel.where, sel.alias)
             if sel.where is not None else ast.Include())
    return ViewState(sel, sql, where, keys, comps, slots)


# -- state --------------------------------------------------------------------


class ViewState:
    def __init__(self, sel: SqlSelect, sql: str, where: ast.Filter,
                 keys: list[str], comps: list[dict],
                 slots: list[_SlotSpec], reservoir_k: int = 8):
        self.sel = sel
        self.sql = sql
        self.table = sel.table
        self.where = where
        self.keys = keys
        self.comps = comps
        self.slots = slots
        self.reservoir_k = max(1, int(reservoir_k))
        self.groups: dict[tuple, _Group] = {}

    # -- full (re)build -----------------------------------------------------

    def build(self, store) -> None:
        """Vectorized from-scratch build: one filtered scan, the
        engine's own factorize/segment-reduce shapes."""
        res = store.query(Query(self.table, self.where))
        batch, ids, n = res.batch, res.ids, res.n
        self.groups = {}
        if batch is None or n == 0:
            return
        ginv, rep, ng = self._group_ids(batch, n)
        nrows = np.bincount(ginv, minlength=ng)
        key_cols = [batch.col(k) for k in self.keys]
        kts = [tuple(_norm_key(c.value(int(rep[g]))) for c in key_cols)
               for g in range(ng)]
        groups = [_Group(kts[g], self.slots) for g in range(ng)]
        for g in range(ng):
            groups[g].nrows = int(nrows[g])
        for si, spec in enumerate(self.slots):
            self._build_slot(spec, si, batch, ids, ginv, ng, groups)
        self.groups = {g.key: g for g in groups}

    def _group_ids(self, batch, n):
        """Composite group ids, mirroring ``SqlEngine._grouped``."""
        from ..sql.engine import _factorize
        gid = np.zeros(n, dtype=np.int64)
        bound = 1
        for k in self.keys:
            codes, _ = _factorize(batch.col(k))
            cmax = int(codes.max()) + 1
            if bound > (1 << 60) // max(cmax, 1):
                _, gid = np.unique(gid, return_inverse=True)
                bound = int(gid.max()) + 1
            gid = gid * cmax + codes
            bound *= cmax
        uniq, rep, ginv = np.unique(gid, return_index=True,
                                    return_inverse=True)
        return ginv, rep, len(uniq)

    def _build_slot(self, spec, si, batch, ids, ginv, ng, groups):
        col = batch.col(spec.col)
        valid = np.asarray(col.valid)
        cnt = np.bincount(ginv, weights=valid.astype(np.float64),
                          minlength=ng).astype(np.int64)
        if spec.kind == "hull":
            from ..sql.engine import _group_hull
            hulls = _group_hull(col, None, ginv, ng)
            for g in range(ng):
                st = groups[g].slots[si]
                st.cnt = int(cnt[g])
                st.geom = hulls[g]
            return
        if spec.kind == "extent":
            lo, hi = _extent_bounds(col, valid, ginv, ng)
            for g in range(ng):
                st = groups[g].slots[si]
                st.cnt = int(cnt[g])
                if lo[g] is not None:
                    st.lo, st.hi = lo[g], hi[g]
            return
        floats = _col_floats(col)
        isnan = (np.zeros(len(valid), bool) if floats is None
                 else np.isnan(floats))
        nan = np.bincount(ginv, weights=(valid & isnan).astype(np.float64),
                          minlength=ng).astype(np.int64)
        if spec.need_sum:
            # identical call to the engine's SUM reduce: same row-order
            # float64 accumulation, invalid rows add +0.0
            w = np.where(valid, floats, 0.0)
            s = np.bincount(ginv, weights=w, minlength=ng)
            nonint = valid & (isnan | (floats != np.floor(
                np.where(isnan, 0.0, floats))))
            n_nonint = np.bincount(ginv, weights=nonint.astype(
                np.float64), minlength=ng)
            absum = np.bincount(ginv, weights=np.abs(w), minlength=ng)
        K = self.reservoir_k
        if spec.need_low or spec.need_high:
            vr = np.flatnonzero(valid & ~isnan)
            order = vr[np.lexsort((vr, floats[vr], ginv[vr]))]
            gs = ginv[order]
            grid = np.arange(ng)
            starts = np.searchsorted(gs, grid)
            ends = np.searchsorted(gs, grid, side="right")
        for g in range(ng):
            st = groups[g].slots[si]
            st.cnt = int(cnt[g])
            st.nan = int(nan[g])
            if spec.need_sum:
                st.sum = np.float64(s[g])
                st.absum = float(absum[g])
                st.int_ok = (n_nonint[g] == 0
                             and st.absum <= float(1 << 53))
            if spec.need_low or spec.need_high:
                seg = order[starts[g]:ends[g]]
                full = len(seg) <= K
                if spec.need_low:
                    st.low = [(float(floats[i]), str(ids[i]))
                              for i in seg[:K]]
                    st.low_full = full
                if spec.need_high:
                    st.high = [(float(floats[i]), str(ids[i]))
                               for i in seg[len(seg) - K:]
                               ] if len(seg) > K else \
                        [(float(floats[i]), str(ids[i])) for i in seg]
                    st.high_full = full

    # -- incremental folds ----------------------------------------------------

    def _slot_views(self, batch):
        views = []
        for spec in self.slots:
            col = batch.col(spec.col)
            valid = np.asarray(col.valid)
            if spec.kind == "num":
                floats = _col_floats(col)
                views.append((valid, floats, col))
            elif spec.kind == "extent":
                if isinstance(col, PointColumn):
                    x = np.asarray(col.x, np.float64)
                    y = np.asarray(col.y, np.float64)
                    b = np.stack([x, y, x, y], axis=1)
                else:
                    b = np.asarray(col.bounds, np.float64)
                views.append((valid, b, col))
            else:
                views.append((valid, None, col))
        return views

    def fold_insert(self, batch, ids, rows) -> set:
        """Fold `rows` (WHERE-matching indices of a freshly-written
        batch, in batch order — i.e. table order) into group state."""
        key_cols = [batch.col(k) for k in self.keys]
        views = self._slot_views(batch)
        changed: set = set()
        for i in rows:
            i = int(i)
            kt = tuple(_norm_key(c.value(i)) for c in key_cols)
            g = self.groups.get(kt)
            if g is None:
                g = self.groups[kt] = _Group(kt, self.slots)
            g.nrows += 1
            g.row = None
            changed.add(kt)
            if g.dirty:
                continue            # replay will recompute the slots
            for si, spec in enumerate(self.slots):
                self._insert_row(spec, g.slots[si], views[si], i,
                                 str(ids[i]))
        return changed

    def _insert_row(self, spec, st, view, i, fid):
        valid, data, col = view
        if spec.kind == "num":
            w = np.float64(data[i]) if (data is not None and valid[i]) \
                else np.float64(0.0)
            if spec.need_sum:
                st.sum = st.sum + w     # same op bincount performs
                if st.int_ok:
                    fw = float(w)
                    if fw != fw or fw != np.floor(fw):
                        st.int_ok = False
                    else:
                        st.absum += abs(fw)
                        if st.absum > float(1 << 53):
                            st.int_ok = False
            if not valid[i]:
                return
            st.cnt += 1
            if data is None:
                return
            v = float(data[i])
            if v != v:
                st.nan += 1
                return
            K = self.reservoir_k
            if spec.need_low and st.low is not None:
                # invariant: everything outside `low` >= max(low)
                if st.low_full or not st.low or v < st.low[-1][0]:
                    bisect.insort(st.low, (v, fid))
                    if len(st.low) > K:
                        st.low.pop()
                        st.low_full = False
            if spec.need_high and st.high is not None:
                if st.high_full or not st.high or v > st.high[0][0]:
                    bisect.insort(st.high, (v, fid))
                    if len(st.high) > K:
                        st.high.pop(0)
                        st.high_full = False
            return
        if not valid[i]:
            return
        st.cnt += 1
        if spec.kind == "extent":
            b = data[i]
            if st.lo is None:
                st.lo = b[:2].copy()
                st.hi = b[2:].copy()
            else:
                # same sequential fold reduceat performs in row order
                st.lo = np.minimum(st.lo, b[:2])
                st.hi = np.maximum(st.hi, b[2:])
            return
        # hull: hull-of-hulls is exact — the fold's vertex set has the
        # same convex hull as the full point set
        from ..analytics.st_functions import convex_hull_points
        if isinstance(col, PointColumn):
            pts = np.array([[float(col.x[i]), float(col.y[i])]])
        else:
            pts = np.vstack(col.value(i).coords_list())
        if st.geom is not None:
            pts = np.vstack([np.vstack(st.geom.coords_list()), pts])
        st.geom = convex_hull_points(pts)

    def fold_delete(self, batch, ids, rows):
        """Retract `rows` (WHERE-matching pre-image rows captured
        before the delete applied). Returns (changed keys, removed
        keys, reservoir fallbacks)."""
        key_cols = [batch.col(k) for k in self.keys]
        views = self._slot_views(batch)
        changed: set = set()
        removed: set = set()
        fallbacks = 0
        for i in rows:
            i = int(i)
            kt = tuple(_norm_key(c.value(i)) for c in key_cols)
            g = self.groups.get(kt)
            if g is None:
                continue            # defensive: state never saw the row
            g.nrows -= 1
            g.row = None
            if g.nrows <= 0:
                del self.groups[kt]
                removed.add(kt)
                changed.discard(kt)
                continue
            changed.add(kt)
            if g.dirty:
                continue
            for si, spec in enumerate(self.slots):
                fallbacks += self._retract_row(spec, g, g.slots[si],
                                               views[si], i, str(ids[i]))
        return changed, removed, fallbacks

    def _retract_row(self, spec, g, st, view, i, fid) -> int:
        valid, data, col = view
        if spec.kind == "num":
            if spec.need_sum:
                if not st.int_ok:
                    # float addition is not invertible in sequence
                    # order — a non-integral sum replays on retraction
                    g.dirty = True
                    return 0
                w = float(data[i]) if (data is not None and valid[i]) \
                    else 0.0
                st.sum = st.sum - np.float64(w)   # exact: integer sum
                st.absum -= abs(w)
            if not valid[i]:
                return 0
            st.cnt -= 1
            if data is None:
                return 0
            v = float(data[i])
            if v != v:
                st.nan -= 1
                return 0
            fb = 0
            if spec.need_low and st.low is not None:
                fb += self._reservoir_remove(g, st, "low", v, fid)
            if spec.need_high and st.high is not None and not g.dirty:
                fb += self._reservoir_remove(g, st, "high", v, fid)
            return fb
        if not valid[i]:
            return 0
        st.cnt -= 1
        if st.cnt > 0:
            g.dirty = True          # hull/extent folds cannot retract
        else:
            st.geom = None
            st.lo = st.hi = None
        return 0

    def _reservoir_remove(self, g, st, side, v, fid) -> int:
        res = getattr(st, side)
        full = getattr(st, side + "_full")
        entry = (v, fid)
        j = bisect.bisect_left(res, entry)
        if j < len(res) and res[j] == entry:
            res.pop(j)
        else:
            boundary_ok = (not res) or (
                v >= res[-1][0] if side == "low" else v <= res[0][0])
            if full or not boundary_ok:
                # a value the reservoir should have covered is missing:
                # state can no longer prove the extreme — replay
                g.dirty = True
                setattr(st, side, None)
                return 1
            return 0                # trimmed-away region: no-op
        if not res and not full and st.cnt - st.nan > 0:
            # drained: runner-ups exhausted while values remain
            g.dirty = True
            setattr(st, side, None)
            return 1
        return 0

    # -- replay (dirty groups) -------------------------------------------------

    def _replay(self, store, g) -> bool:
        """Recompute one group with a targeted store query. Scan
        strategies return table-order rows, so the single-group reduce
        is bit-identical to the group's slice of a full re-execution."""
        flt: list = []
        if not isinstance(self.where, ast.Include):
            flt.append(self.where)
        for k, v in zip(self.keys, g.key):
            if v is None:
                flt.append(ast.IsNull(k))
            elif v is _NAN_KEY:
                raise _NanKeyReplay()
            else:
                flt.append(ast.Compare("=", k, v))
        f = (ast.And(flt) if len(flt) > 1
             else (flt[0] if flt else ast.Include()))
        res = store.query(Query(self.table, f))
        n = res.n
        if n == 0 or res.batch is None:
            return False
        fresh = _Group(g.key, self.slots)
        fresh.nrows = n
        ginv = np.zeros(n, dtype=np.int64)
        for si, spec in enumerate(self.slots):
            self._build_slot(spec, si, res.batch, res.ids, ginv, 1,
                             [fresh])
        g.nrows = n
        g.slots = fresh.slots
        g.dirty = False
        g.row = None
        return True

    def ensure_clean(self, store) -> int:
        """Replay every dirty group; returns the number of replays
        (a full rebuild counts as one)."""
        replays = 0
        for kt in [kt for kt, g in self.groups.items() if g.dirty]:
            g = self.groups.get(kt)
            if g is None or not g.dirty:
                continue
            try:
                if not self._replay(store, g):
                    del self.groups[kt]
            except _NanKeyReplay:
                self.build(store)
                return replays + 1
            replays += 1
        return replays

    # -- finalize ----------------------------------------------------------------

    def _comp_value(self, g, comp):
        kind = comp["kind"]
        if kind == "key":
            return _denorm_key(g.key[comp["key"]])
        st = g.slots[comp["slot"]] if comp["slot"] >= 0 else None
        if kind == "count":
            return np.int64(g.nrows if st is None else st.cnt)
        if kind == "sum":
            return None if st.cnt == 0 else np.float64(st.sum)
        if kind == "avg":
            return None if st.cnt == 0 else \
                np.float64(st.sum) / np.float64(st.cnt)
        if kind == "min":
            if st.cnt == 0:
                return None
            if st.nan:
                return np.float64(np.nan)
            return np.float64(st.low[0][0])
        if kind == "max":
            if st.cnt == 0:
                return None
            if st.nan:
                return np.float64(np.nan)
            return np.float64(st.high[-1][0])
        if kind == "hull":
            return None if st.cnt == 0 else st.geom
        # extent
        if st.cnt == 0 or st.lo is None:
            return None
        return Envelope(st.lo[0], st.lo[1],
                        st.hi[0], st.hi[1]).to_polygon()

    def group_row(self, g) -> dict:
        """Finalized {output name: value} for one (clean) group."""
        if g.row is None:
            g.row = {c["name"]: self._comp_value(g, c)
                     for c in self.comps}
        return g.row

    def result(self, store) -> SqlResult:
        """Finalize to the exact single-node SqlEngine output: sorted
        group order, HAVING, hidden-column drop, ORDER BY/LIMIT."""
        self.ensure_clean(store)
        names_all = [c["name"] for c in self.comps]
        kts = sorted(self.groups, key=_sort_key)
        if not kts:
            cols_all = {n: np.empty(0, object) for n in names_all}
        else:
            cols_all = {}
            for c in self.comps:
                vals = [self._comp_value(self.groups[kt], c)
                        for kt in kts]
                if c["kind"] == "count":
                    cols_all[c["name"]] = np.array(vals, dtype=np.int64)
                else:
                    arr = np.empty(len(vals), dtype=object)
                    for i, v in enumerate(vals):
                        arr[i] = v
                    cols_all[c["name"]] = arr
        out_all = SqlResult(names_all, cols_all)

        def compute(it):
            e = it.expr.split(".")[-1]
            if not it.agg and e in self.keys:
                j = self.keys.index(e)
                return np.array([_denorm_key(kt[j]) for kt in kts],
                                dtype=object)
            raise ValueError(f"not an aggregate: {it.name} (HAVING "
                             f"terms must aggregate or be group keys)")

        out_all = SqlEngine._apply_having(out_all, self.sel.having,
                                          compute)
        sel_names = [it.name for it in self.sel.items]
        out = SqlResult(sel_names,
                        {n: out_all.columns[n] for n in sel_names})
        order = self.sel.order_by
        if order and "." in order:
            order = order.split(".", 1)[1]
        if self.sel.order_by is not None and order not in out.columns \
                and self.sel.order_by in out.columns:
            order = self.sel.order_by
        return _order_limit(out, order, self.sel.order_desc,
                            self.sel.limit)

    # -- durable blob --------------------------------------------------------------

    def to_blob(self) -> dict:
        """JSON-safe snapshot. Floats travel as ``float.hex()`` (bit
        exact), geometries as WKT (repr floats round-trip losslessly).
        Callers replay dirty groups first — only clean state is saved."""
        groups = []
        for kt in sorted(self.groups, key=_sort_key):
            g = self.groups[kt]
            gb = {"key": [_enc_key(v) for v in kt], "n": int(g.nrows),
                  "slots": []}
            for spec, st in zip(self.slots, g.slots):
                if spec.kind == "num":
                    gb["slots"].append({
                        "cnt": int(st.cnt), "nan": int(st.nan),
                        "sum": float(st.sum).hex(),
                        "iok": bool(st.int_ok),
                        "ab": float(st.absum).hex(),
                        "low": _enc_res(st.low), "lf": bool(st.low_full),
                        "high": _enc_res(st.high),
                        "hf": bool(st.high_full)})
                elif spec.kind == "hull":
                    from ..geometry import to_wkt
                    gb["slots"].append({
                        "cnt": int(st.cnt),
                        "wkt": None if st.geom is None
                        else to_wkt(st.geom)})
                else:
                    gb["slots"].append({
                        "cnt": int(st.cnt),
                        "lo": None if st.lo is None
                        else [v.hex() for v in st.lo.tolist()],
                        "hi": None if st.hi is None
                        else [v.hex() for v in st.hi.tolist()]})
            groups.append(gb)
        return {"groups": groups}

    def from_blob(self, blob: dict) -> None:
        from ..geometry import parse_wkt
        self.groups = {}
        for gb in blob["groups"]:
            kt = tuple(_dec_key(v) for v in gb["key"])
            g = _Group(kt, self.slots)
            g.nrows = int(gb["n"])
            for spec, st, sb in zip(self.slots, g.slots, gb["slots"]):
                st.cnt = int(sb["cnt"])
                if spec.kind == "num":
                    st.nan = int(sb["nan"])
                    st.sum = np.float64(float.fromhex(sb["sum"]))
                    st.int_ok = bool(sb["iok"])
                    st.absum = float.fromhex(sb["ab"])
                    st.low = _dec_res(sb["low"])
                    st.low_full = bool(sb["lf"])
                    st.high = _dec_res(sb["high"])
                    st.high_full = bool(sb["hf"])
                elif spec.kind == "hull":
                    st.geom = (None if sb["wkt"] is None
                               else parse_wkt(sb["wkt"]))
                else:
                    if sb["lo"] is not None:
                        st.lo = np.array(
                            [float.fromhex(v) for v in sb["lo"]],
                            dtype=np.float64)
                        st.hi = np.array(
                            [float.fromhex(v) for v in sb["hi"]],
                            dtype=np.float64)
            self.groups[kt] = g


def _extent_bounds(col, valid, ginv, ng):
    """Per-group (lo, hi) float64 bound folds, the reduceat shape
    ``_group_extent`` uses (kept as arrays for incremental folding)."""
    if isinstance(col, PointColumn):
        x = np.asarray(col.x, np.float64)
        y = np.asarray(col.y, np.float64)
        bx = np.stack([x, y, x, y], axis=1)
    else:
        bx = np.asarray(col.bounds, np.float64)
    lo_out: list = [None] * ng
    hi_out: list = [None] * ng
    if not valid.any():
        return lo_out, hi_out
    g = ginv[valid]
    vb = bx[valid]
    order = np.argsort(g, kind="stable")
    gs = g[order]
    vb = vb[order]
    starts = np.flatnonzero(np.diff(gs, prepend=gs[0] - 1))
    present = gs[starts]
    lo = np.minimum.reduceat(vb[:, :2], starts, axis=0)
    hi = np.maximum.reduceat(vb[:, 2:], starts, axis=0)
    for i, gi in enumerate(present):
        lo_out[gi] = lo[i].copy()
        hi_out[gi] = hi[i].copy()
    return lo_out, hi_out


def _enc_key(v):
    if v is _NAN_KEY:
        return {"nan": True}
    if isinstance(v, float):
        return {"f": v.hex()}
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return {"v": v}
    raise ValueError(f"unsupported group key {v!r}")


def _dec_key(b):
    if "nan" in b:
        return _NAN_KEY
    if "f" in b:
        return float.fromhex(b["f"])
    return b["v"]


def _enc_res(res):
    return None if res is None else [[float(v).hex(), fid]
                                     for v, fid in res]


def _dec_res(blob):
    return None if blob is None else \
        [(float.fromhex(v), fid) for v, fid in blob]
