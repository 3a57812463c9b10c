"""Distributed SQL over the cluster plane: partial-aggregate pushdown
and broadcast spatial joins.

The reference serves SQL through Spark executors running next to the
data (geomesa-spark-sql partitions relations over the store's splits);
this module is that shape over a cluster store:

- **Partial aggregates**: COUNT/SUM/MIN/MAX/AVG (avg decomposed into
  sum+count), convex-hull unions and ST_Extent envelope folds are all
  associative, so each shard group reduces its own rows to a tiny
  per-group partial (`partial_aggregate`) and the coordinator merges
  partials by group key (`merge_partial_legs`). The coordinator's peak
  materialization is bounded by the number of groups x distinct keys —
  never by matching rows.
- **Broadcast joins**: when one join side fits under
  ``geomesa.sql.broadcast.rows``, the coordinator fetches it once,
  ships it to every shard group, and each leg runs the existing fused
  device join kernels against its local slice of the big side
  (`join_partial_leg`); count results psum-merge, aggregate results
  merge by key, row results concatenate. Exact because the z-prefix
  partition of the big side is disjoint and covering.
- **Streamed ORDER BY ... LIMIT**: plain projections with a LIMIT ride
  the cluster's k-way sort-merge stream instead of a full materialize.

Everything else falls back to the single-node engine with the reason
recorded on ``SqlResult.plan`` — the EXPLAIN surface.

Legs ride the cluster's per-leg deadlines, hedging, breakers and the
typed/flagged partial-results contract: a lost leg raises
``ShardUnavailableError`` unless ``geomesa.cluster.allow.partial``
flags the merged result ``complete=False`` instead.

The leg functions (`partial_aggregate`, `join_partial_leg`,
`merge_partial_legs`) run over any port store; `try_distributed` needs
a cluster store (``prune_for``, ``sql_partial``, ``sql_join_partial``,
``query_stream``): the engine takes this path only over a
``ClusterDataStore``, and over a single store every statement stays
local. The leg
payloads are plain JSON-able dicts: a payload written by either package
decodes in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..features.batch import (BoolColumn, DateColumn, FeatureBatch,
                              GeometryColumn, NumericColumn, PointColumn,
                              StringColumn)
from ..features.sft import parse_spec
from ..filters import ast
from ..geometry import Geometry, parse_wkt, to_wkt
from ..index.api import Query
from ..utils.properties import SQL_BROADCAST_ROWS, SQL_DISTRIBUTED
from .parser import SelectItem, SqlSelect, parse_sql
from .planner import SQL_PLANNER, CostModel, estimate_for_store

__all__ = ["SQL_DISTRIBUTED", "SQL_BROADCAST_ROWS", "try_distributed",
           "partial_aggregate", "merge_partial_legs", "join_partial_leg"]

_MERGEABLE = ("count", "sum", "min", "max", "avg", "convex_hull", "extent")


class _Unsupported(ValueError):
    """Statement shape the distributed planner does not cover — the
    caller records the reason and falls back to the single-node path
    (which either answers or raises the proper user-facing error).
    ``cost`` (optional) carries the cost model's terms so the fallback
    plan can still explain the cardinality-driven decision."""

    cost: dict | None = None


class _FallbackReason(str):
    """The fallback reason string, plus the planner's cost terms when
    the decision was cost-based — the engine copies them onto the
    cluster-materialize plan (``plan["cost"]``)."""

    cost: dict | None = None


# -- partial planning ------------------------------------------------------

def _plan_partials(sel: SqlSelect, qualified: bool):
    """Decompose the select list (plus hidden HAVING aggregates) into
    mergeable components. Returns ``(key_items, leg_items, comps,
    keys)`` or None when some item is not mergeable.

    - ``key_items``: one aliased item per GROUP BY key (``__k{j}``)
    - ``leg_items``: aliased aggregate items each leg evaluates with
      the ordinary engine reduces (``__p{i}``; avg contributes a
      ``__p{i}s``/``__p{i}c`` sum+count pair)
    - ``comps``: output schema — how each final column is rebuilt from
      the merged accumulators
    """
    if sel.group_by is None:
        keys: list[str] = []
    elif qualified:
        keys = list(sel.group_by)
    else:
        keys = [k.split(".", 1)[1] if "." in k else k for k in sel.group_by]
    ext: list[SelectItem] = list(sel.items)
    sel_names = {it.name for it in sel.items}
    for cond in (sel.having or []):
        if cond.item.agg and cond.item.name not in sel_names:
            ext.append(cond.item)   # hidden: merged, filtered on, dropped
    key_items = [SelectItem(k, None, f"__k{j}") for j, k in enumerate(keys)]
    leg_items: list[SelectItem] = []
    comps: list[dict] = []
    for i, it in enumerate(ext):
        if not it.agg:
            e = it.expr if qualified else it.expr.split(".")[-1]
            if e not in keys:
                return None         # not a group key: engine will raise
            comps.append({"kind": "key", "name": it.name,
                          "key": keys.index(e)})
            continue
        if it.agg not in _MERGEABLE:
            return None             # scalar ST_* / unknown aggregate
        if it.agg == "avg":
            leg_items.append(SelectItem(it.expr, "sum", f"__p{i}s"))
            leg_items.append(SelectItem(it.expr, "count", f"__p{i}c"))
            comps.append({"kind": "avg", "name": it.name,
                          "sum": f"__p{i}s", "cnt": f"__p{i}c"})
            continue
        kind = {"convex_hull": "hull"}.get(it.agg, it.agg)
        leg_items.append(SelectItem(it.expr, it.agg, f"__p{i}"))
        comps.append({"kind": kind, "name": it.name, "src": f"__p{i}"})
    return key_items, leg_items, comps, keys


def _check_columns(cluster, table: str, exprs) -> None:
    """Reject unknown column references BEFORE scattering: a statement
    error must surface as the single-node path's user error, never as
    a ShardUnavailableError from every leg failing identically."""
    try:
        sft = cluster.get_schema(table)
    except Exception as e:
        raise _Unsupported(f"no schema for {table!r}: {e}") from e
    valid = {a.name for a in sft.attributes} | {"__fid__", "*"}
    for expr in exprs:
        if expr not in valid:
            raise _Unsupported(f"unknown column {expr!r} in {table!r}")


def _agg_aliases(comps) -> dict[str, str]:
    """leg column alias -> merge kind, for every non-key component."""
    out: dict[str, str] = {}
    for c in comps:
        if c["kind"] == "key":
            continue
        if c["kind"] == "avg":
            out[c["sum"]] = "sum"
            out[c["cnt"]] = "count"
        else:
            out[c["src"]] = c["kind"]
    return out


def _enc(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _enc_val(kind, v):
    if v is None:
        return None
    if kind in ("hull", "extent"):
        return to_wkt(v)
    return _enc(v)


# -- partial leg (single table) --------------------------------------------

def partial_aggregate(store, stmt, query_kwargs=None) -> dict:
    """One shard group's leg of a distributed single-table aggregate:
    run the ordinary engine reduces over the local rows with the
    decomposed (avg -> sum+count) item list, and return the per-key
    partials in the JSON-able wire form the coordinator merges —
    identical for in-process and REST legs, so transport is invisible
    to correctness (WKT floats round-trip via repr, losslessly)."""
    from .engine import SqlEngine, _strip_qualifier
    sel = parse_sql(stmt) if isinstance(stmt, str) else stmt
    if sel.joins:
        raise ValueError("sql partial legs are single-table aggregates")
    plan = _plan_partials(sel, qualified=False)
    if plan is None:
        raise ValueError("statement has no mergeable aggregate form")
    key_items, leg_items, comps, keys = plan
    where = (_strip_qualifier(sel.where, sel.alias)
             if sel.where is not None else ast.Include())
    eng = SqlEngine(store)
    res = store.query(Query(sel.table, where), **(query_kwargs or {}))
    if sel.group_by is not None:
        out = eng._grouped(key_items + leg_items, keys, res.batch)
        key_rows = [[_enc(out.columns[k.name][r]) for k in key_items]
                    for r in range(out.n)]
    else:
        out = eng._aggregate(leg_items, res.batch, res.n)
        key_rows = [[]]
    cols = {alias: [_enc_val(kind, out.columns[alias][r])
                    for r in range(out.n)]
            for alias, kind in _agg_aliases(comps).items()}
    return {"keys": key_rows, "cols": cols, "n": out.n}


# -- coordinator merge -----------------------------------------------------

def _combine(acc: dict, alias: str, kind: str, v):
    if kind == "count":
        acc[alias] = acc.get(alias, 0) + int(v or 0)
        return
    if v is None:
        return
    if kind == "sum":
        cur = acc.get(alias)
        acc[alias] = v if cur is None else cur + v
    elif kind == "min":
        cur = acc.get(alias)
        acc[alias] = v if cur is None else min(cur, v)
    elif kind == "max":
        cur = acc.get(alias)
        acc[alias] = v if cur is None else max(cur, v)
    elif kind == "hull":
        g = parse_wkt(v) if isinstance(v, str) else v
        acc.setdefault(alias, []).append(np.vstack(g.coords_list()))
    elif kind == "extent":
        g = parse_wkt(v) if isinstance(v, str) else v
        cur = acc.get(alias)
        env = g.envelope
        acc[alias] = env if cur is None else cur.expand(env)


def merge_partial_legs(sel: SqlSelect, legs: list[dict],
                       qualified: bool):
    """Merge per-leg partials by group key and finalize: avg =
    sum/count, hulls re-hull the pooled leg hull vertices (exact —
    hull of hulls), extents fold envelopes; then HAVING, hidden-column
    drop and post-merge ORDER BY / LIMIT, mirroring the single-node
    output shapes exactly."""
    from .engine import SqlEngine, SqlResult, _order_limit
    from ..analytics.st_functions import convex_hull_points
    plan = _plan_partials(sel, qualified=qualified)
    if plan is None:
        raise ValueError("statement has no mergeable aggregate form")
    _, _, comps, keys = plan
    aliases = _agg_aliases(comps)
    acc: dict[tuple, dict] = {}
    for leg in legs:
        for r in range(leg["n"]):
            kt = tuple(leg["keys"][r]) if keys else ()
            a = acc.setdefault(kt, {})
            for alias, kind in aliases.items():
                _combine(a, alias, kind, leg["cols"][alias][r])
    if not keys and not acc:
        acc[()] = {}        # zero rows everywhere still yields one row
    groups = sorted(acc, key=lambda kt: tuple((x is None, x) for x in kt)) \
        if keys else list(acc)
    empty = keys and not acc

    def finalize(c, a):
        kind = c["kind"]
        if kind == "count":
            return a.get(c["src"], 0)
        if kind == "avg":
            cnt = a.get(c["cnt"], 0)
            s = a.get(c["sum"])
            return None if not cnt or s is None else s / cnt
        if kind == "hull":
            pts = a.get(c["src"])
            return None if pts is None else convex_hull_points(
                np.vstack(pts))
        if kind == "extent":
            env = a.get(c["src"])
            return None if env is None else env.to_polygon()
        return a.get(c["src"])

    names_all, cols_all = [], {}
    for c in comps:
        names_all.append(c["name"])
        if c["kind"] == "key":
            cols_all[c["name"]] = np.array(
                [kt[c["key"]] for kt in groups], dtype=object)
        else:
            cols_all[c["name"]] = np.array(
                [finalize(c, acc[kt]) for kt in groups], dtype=object)
    if empty:
        cols_all = {n: np.empty(0, object) for n in names_all}
    out_all = SqlResult(names_all, cols_all)

    def compute(it):
        e = it.expr if qualified else it.expr.split(".")[-1]
        if not it.agg and e in keys:
            return np.array([kt[keys.index(e)] for kt in groups],
                            dtype=object)
        raise ValueError(f"not an aggregate: {it.name} (HAVING terms "
                         f"must aggregate or be group keys)")

    out_all = SqlEngine._apply_having(out_all, sel.having, compute)
    sel_names = [it.name for it in sel.items]
    out = SqlResult(sel_names,
                    {n: out_all.columns[n] for n in sel_names})
    if sel.group_by is None:
        return out   # single-node ungrouped aggregates ignore ORDER/LIMIT
    order = sel.order_by
    if order is not None and order not in out.columns:
        alt = order.split(".")[-1] if qualified else None
        if qualified and alt in out.columns:
            order = alt
        elif not qualified:
            stripped = order.split(".", 1)[1] if "." in order else order
            if stripped in out.columns:
                order = stripped
    return _order_limit(out, order, sel.order_desc, sel.limit)


# -- broadcast batch codec -------------------------------------------------

def _encode_batch(type_name: str, sft, res) -> dict:
    """JSON-able wire form of a (small) query result: ids plus one
    typed encoding per column. Exact round trip — string dictionaries,
    epoch millis, nan-tagged point slots and repr-format WKT all
    reconstruct the identical columns on the far side."""
    payload = {"type": type_name, "spec": sft.to_spec(),
               "n": int(res.n), "ids": [str(i) for i in res.ids],
               "cols": {}}
    batch = res.batch
    if batch is None or res.n == 0:
        payload["n"] = 0
        payload["ids"] = []
        return payload
    for a in sft.attributes:
        c = batch.col(a.name)
        if isinstance(c, PointColumn):
            enc = {"k": "pt", "x": c.x.tolist(), "y": c.y.tolist(),
                   "v": np.asarray(c.valid, bool).tolist()}
        elif isinstance(c, GeometryColumn):
            enc = {"k": "geom",
                   "w": [None if g is None else to_wkt(g)
                         for g in c.geoms]}
        elif isinstance(c, DateColumn):
            enc = {"k": "date", "ms": c.millis.tolist(),
                   "v": np.asarray(c.valid, bool).tolist()}
        elif isinstance(c, StringColumn):
            enc = {"k": "str", "c": c.codes.tolist(),
                   "vocab": [str(s) for s in c.vocab]}
        elif isinstance(c, BoolColumn):
            enc = {"k": "bool", "b": c.values.tolist(),
                   "v": np.asarray(c.valid, bool).tolist()}
        else:
            enc = {"k": "num", "f": c.values.tolist(),
                   "dt": str(c.values.dtype),
                   "v": np.asarray(c.valid, bool).tolist()}
        payload["cols"][a.name] = enc
    return payload


def _decode_batch(payload: dict):
    """(sft, ids, batch|None) from `_encode_batch` output."""
    sft = parse_spec(payload["type"], payload["spec"])
    ids = np.asarray(payload["ids"], dtype=object)
    if payload["n"] == 0:
        empty = FeatureBatch.from_dict(
            sft, [], {a.name: np.empty(0, object)
                      for a in sft.attributes})
        return sft, ids, empty
    cols = {}
    for a in sft.attributes:
        e = payload["cols"][a.name]
        if e["k"] == "pt":
            cols[a.name] = PointColumn(
                a.name, np.asarray(e["x"], np.float64),
                np.asarray(e["y"], np.float64),
                np.asarray(e["v"], bool))
        elif e["k"] == "geom":
            cols[a.name] = GeometryColumn.from_geoms(a.name, e["w"])
        elif e["k"] == "date":
            cols[a.name] = DateColumn(
                a.name, np.asarray(e["ms"], np.int64),
                np.asarray(e["v"], bool))
        elif e["k"] == "str":
            cols[a.name] = StringColumn(
                a.name, np.asarray(e["c"], np.int32),
                np.asarray(e["vocab"], dtype=object))
        elif e["k"] == "bool":
            cols[a.name] = BoolColumn(
                a.name, np.asarray(e["b"], bool),
                np.asarray(e["v"], bool))
        else:
            cols[a.name] = NumericColumn(
                a.name, np.asarray(e["f"], np.dtype(e["dt"])),
                np.asarray(e["v"], bool))
    return sft, ids, FeatureBatch(sft, ids, cols)


class _BroadcastSide:
    """QueryResult stand-in for the shipped small side of a join —
    just enough surface (ids / batch / n) for the engine's join
    machinery."""

    def __init__(self, ids, batch):
        self.ids = ids
        self.batch = batch
        self.n = len(ids)


def _enc_cell(v):
    if isinstance(v, Geometry):
        return {"__wkt__": to_wkt(v)}
    return _enc(v)


def _dec_cell(v):
    if isinstance(v, dict) and "__wkt__" in v:
        return parse_wkt(v["__wkt__"])
    return v


# -- join leg --------------------------------------------------------------

def _split_where(sel: SqlSelect, aliases, outer_aliases):
    """Mirror of the engine's join WHERE split: each conjunct pushes
    below the join on its own side, except conjuncts on a LEFT join's
    right side, which defer to post-NULL-extension evaluation."""
    from .engine import _qualifier_of, _strip_qualifier
    side_f = {a: [] for a in aliases}
    deferred = []
    if sel.where is not None:
        conjuncts = (list(sel.where.children)
                     if isinstance(sel.where, ast.And) else [sel.where])
        for c in conjuncts:
            quals = _qualifier_of(c)
            if len(quals) != 1 or "" in quals:
                raise _Unsupported("WHERE conjuncts must reference "
                                   "exactly one aliased table")
            a = next(iter(quals))
            if a not in side_f:
                raise _Unsupported(f"unknown table qualifier {a!r}")
            if a in outer_aliases:
                deferred.append((a, _strip_qualifier(c, a)))
            else:
                side_f[a].append(_strip_qualifier(c, a))
    return side_f, deferred


def _and(fs) -> ast.Filter:
    if not fs:
        return ast.Include()
    return ast.And(fs) if len(fs) > 1 else fs[0]


def _count_mode_ok(sel: SqlSelect, j, deferred) -> bool:
    """Conditions under which a leg can use the engine's device
    count-reduce (no pair materialization) — same gate as the
    single-node COUNT(*) fast path."""
    return (not j.outer and not deferred and sel.group_by is None
            and not sel.having and j.kind != "eq"
            and len(sel.items) == 1 and sel.items[0].agg == "count"
            and sel.items[0].expr == "*")


def join_partial_leg(store, spec: dict, query_kwargs=None) -> dict:
    """One shard group's leg of a broadcast join: rebuild the shipped
    small side, query the local slice of the big side with its pushed
    WHERE conjuncts, run the engine's fused join kernels, and return
    the mode-appropriate partial (count / keyed aggregate partials /
    projected rows)."""
    from .engine import SqlEngine
    sel = parse_sql(spec["sql"])
    # ORDER/LIMIT are coordinator-side (post-merge): a leg must never
    # truncate its slice of the answer
    sel = dataclasses.replace(sel, order_by=None, limit=None)
    j = sel.joins[0]
    aliases = [sel.alias, j.alias]
    tables = {sel.alias: sel.table, j.alias: j.table}
    b_alias = spec["broadcast"]
    side_f, deferred = _split_where(
        sel, aliases, {j.alias} if j.outer else set())
    _, ids, batch = _decode_batch(spec["payload"])
    eng = SqlEngine(store)
    results = {}
    for a in aliases:
        if a == b_alias:       # already filtered at the coordinator
            results[a] = _BroadcastSide(ids, batch)
        else:
            results[a] = store.query(Query(tables[a], _and(side_f[a])),
                                     **(query_kwargs or {}))
    mode = spec["mode"]
    if any(results[a].n == 0 for a in aliases if a != b_alias):
        # empty local slice: inner joins pair nothing, and for LEFT
        # joins the local side is always the outer anchor — either way
        # this leg contributes an empty partial
        if mode == "count":
            return {"count": 0}
        if mode == "agg":
            plan = _plan_partials(sel, qualified=True)
            key_items, leg_items, comps, keys = plan
            return {"keys": [], "cols": {a: [] for a in _agg_aliases(comps)},
                    "n": 0}
        return {"names": [it.name for it in sel.items],
                "cols": {it.name: [] for it in sel.items}, "n": 0}
    if mode == "count":
        a_alias, a_col = j.left_prop.split(".", 1)
        b2, b_col = j.right_prop.split(".", 1)
        total = eng._join_count(
            j, results[a_alias], a_col, results[b2], b_col,
            a_table=tables[a_alias] if a_alias != b_alias else None,
            b_table=tables[b2] if b2 != b_alias else None)
        return {"count": int(total)}
    rows = {sel.alias: np.arange(results[sel.alias].n, dtype=np.int64)}
    # exclude the broadcast alias from the device-resident shortcut:
    # its rows are the cluster-wide small side, not this store's table
    leg_tables = {a: tables[a] for a in aliases if a != b_alias}
    rows = eng._apply_join(j, results, rows, leg_tables)
    for a, f in deferred:
        keep = eng._post_join_mask(f, results[a], rows[a])
        rows = {k: v[keep] for k, v in rows.items()}
    if mode == "agg":
        plan = _plan_partials(sel, qualified=True)
        if plan is None:
            raise ValueError("statement has no mergeable aggregate form")
        key_items, leg_items, comps, keys = plan
        if sel.group_by is not None:
            psel = dataclasses.replace(sel, items=key_items + leg_items,
                                       having=None)
            out = eng._grouped_join(psel, results, rows)
            key_rows = [[_enc(out.columns[k.name][r]) for k in key_items]
                        for r in range(out.n)]
        else:
            psel = dataclasses.replace(sel, items=leg_items, having=None)
            out = eng._project_join(psel, results, rows)
            key_rows = [[]]
        cols = {alias: [_enc_val(kind, out.columns[alias][r])
                        for r in range(out.n)]
                for alias, kind in _agg_aliases(comps).items()}
        return {"keys": key_rows, "cols": cols, "n": out.n}
    out = eng._project_join(sel, results, rows)
    return {"names": out.names,
            "cols": {nm: [_enc_cell(v) for v in out.columns[nm]]
                     for nm in out.names},
            "n": out.n}


# -- the distributed planner ----------------------------------------------

def try_distributed(engine, cluster, sel: SqlSelect, text: str):
    """Attempt distributed execution. Returns ``(SqlResult, None)`` on
    success or ``(None, reason)`` to fall back to the single-node path
    (which raises the proper error for genuinely invalid statements)."""
    if not SQL_DISTRIBUTED.as_bool():
        return None, "disabled (geomesa.sql.distributed=false)"
    try:
        if sel.joins:
            return _broadcast_join(engine, cluster, sel, text), None
        return _single_table_distributed(engine, cluster, sel, text), None
    except _Unsupported as e:
        reason = _FallbackReason(str(e))
        reason.cost = getattr(e, "cost", None)
        return None, reason


def _flag(out, missing, *extra_partials):
    """Attach the partial-results contract to a merged SqlResult:
    union of leg-scatter missing info and any flagged sub-results the
    plan consumed (e.g. the broadcast-side fetch)."""
    groups: list = []
    z_ranges: list = []
    if missing:
        groups += missing["groups"]
        z_ranges += missing["z_ranges"]
    for p in extra_partials:
        if p is not None and not getattr(p, "complete", True):
            for g in getattr(p, "missing_groups", []):
                if g not in groups:
                    groups.append(g)
            z_ranges += [z for z in getattr(p, "missing_z_ranges", [])
                         if z not in z_ranges]
    if groups:
        out.complete = False
        out.missing_groups = sorted(set(groups))
        out.missing_z_ranges = z_ranges
    return out


def _describe_partials(comps) -> list[str]:
    out = []
    for c in comps:
        if c["kind"] == "key":
            continue
        desc = {"avg": "sum+count partials, divide at merge",
                "hull": "per-leg hull, re-hull pooled vertices",
                "extent": "per-leg envelope, fold at merge",
                "count": "per-leg count, add at merge",
                "sum": "per-leg sum, add at merge",
                "min": "per-leg min, min at merge",
                "max": "per-leg max, max at merge"}[c["kind"]]
        out.append(f"{c['name']}: {desc}")
    return out


def _single_table_distributed(engine, cluster, sel: SqlSelect, text: str):
    if sel.having and sel.group_by is None:
        raise _Unsupported("HAVING without GROUP BY")
    aggs = [i for i in sel.items if i.agg and i.agg != "st"]
    plain = [i for i in sel.items if not i.agg or i.agg == "st"]
    if sel.group_by is None and not aggs:
        return _streamed_select(engine, cluster, sel)
    if sel.group_by is None and plain:
        raise _Unsupported("mixed aggregates and plain columns")
    plan = _plan_partials(sel, qualified=False)
    if plan is None:
        raise _Unsupported("select list is not a mergeable aggregate "
                           "(scalar ST_* or non-key plain column)")
    _, _, comps, keys = plan
    _check_columns(cluster, sel.table,
                   [i.expr for i in sel.items] + list(sel.group_by or []))
    from .engine import _strip_qualifier
    where = (_strip_qualifier(sel.where, sel.alias)
             if sel.where is not None else None)
    legs_sel, prune_info = cluster.prune_for(sel.table, where)
    results, missing = cluster.sql_partial(text, type_name=sel.table,
                                           legs=legs_sel)
    legs = sorted(results)
    out = merge_partial_legs(sel, [results[n] for n in legs],
                             qualified=False)
    out.plan = {
        "mode": "distributed-aggregate", "distributed": True,
        "table": sel.table,
        "pushdown": str(sel.where) if sel.where is not None else "INCLUDE",
        "legs": legs,
        "group_by": keys or None,
        "partials": _describe_partials(comps),
        "merge": "by-key" if keys else "fold",
        "order_limit": ("post-merge" if sel.group_by is not None
                        and (sel.order_by or sel.limit is not None)
                        else None),
    }
    if prune_info is not None:
        out.plan["prune"] = dict(
            prune_info, contacted=legs,
            pruned=(sorted(set(cluster._names) - set(legs_sel))
                    if legs_sel is not None else []))
    if SQL_PLANNER.as_bool():
        est = estimate_for_store(cluster, sel.table, where)
        out.plan["cost"] = (
            {"estimator": "stats", "estimated_rows": int(est)}
            if est is not None else {"fallback": "no-stats"})
    if missing:
        out.plan["missing_groups"] = missing["groups"]
    return _flag(out, missing)


def _streamed_select(engine, cluster, sel: SqlSelect):
    """Plain projection: with a LIMIT, ride the k-way merge stream so
    the coordinator holds at most LIMIT rows; without one, a scatter
    materializes the world and the single-node path is no worse."""
    from .engine import SqlResult, _strip_qualifier
    if sel.limit is None:
        raise _Unsupported("plain projection without LIMIT "
                           "(full materialization either way)")
    where = (_strip_qualifier(sel.where, sel.alias)
             if sel.where is not None else ast.Include())
    order = sel.order_by
    if order and "." in order:
        order = order.split(".", 1)[1]
    q = Query(sel.table, where, sort_by=order, sort_desc=sel.order_desc,
              max_features=sel.limit)
    stream = cluster.query_stream(q)
    batches = list(stream)
    batch = FeatureBatch.concat_all(batches) if batches else None
    ids = batch.ids if batch is not None else np.empty(0, object)
    out = engine._project(sel.items, batch, ids, sel.alias)
    res = SqlResult(out.names, out.columns)
    res.plan = {
        "mode": "distributed-stream", "distributed": True,
        "table": sel.table,
        "pushdown": str(sel.where) if sel.where is not None else "INCLUDE",
        "legs": [n for n in cluster._names
                 if n not in getattr(stream, "missing_groups", [])],
        "merge": "k-way-stream",
        "order_limit": f"streamed (limit={sel.limit})",
    }
    return _flag(res, None, stream)


def _broadcast_join(engine, cluster, sel: SqlSelect, text: str):
    if len(sel.joins) != 1:
        raise _Unsupported("chained joins")
    if sel.having and sel.group_by is None:
        raise _Unsupported("HAVING without GROUP BY")
    j = sel.joins[0]
    aliases = [sel.alias, j.alias]
    if len(set(aliases)) != 2:
        raise _Unsupported("duplicate table aliases")
    tables = {sel.alias: sel.table, j.alias: j.table}
    a_alias = j.left_prop.split(".", 1)[0]
    b2 = j.right_prop.split(".", 1)[0]
    if {a_alias, b2} != set(aliases):
        raise _Unsupported("ON must reference both joined tables")
    for k in (sel.group_by or []):
        if "." not in k:
            raise _Unsupported(f"unqualified GROUP BY key {k!r}")
    side_f, deferred = _split_where(
        sel, aliases, {j.alias} if j.outer else set())
    refs = {a: [] for a in aliases}
    for q in ([i.expr for i in sel.items] + list(sel.group_by or [])
              + [j.left_prop, j.right_prop]):
        if "." in q:
            al, col = q.split(".", 1)
            if al in refs:
                refs[al].append(col)
    for a in aliases:
        _check_columns(cluster, tables[a], refs[a])

    threshold = SQL_BROADCAST_ROWS.as_int() or 0
    # cardinality-driven side choice: estimated (filtered) rows from
    # the per-shard stats sketches replace the exact query_count
    # scatters — the planning cost drops from two cluster scans to
    # O(cells) sketch math. Estimates only pick the side; the shipped
    # batch's true size is re-checked against the threshold below.
    cost: dict = {}
    counts = None
    if SQL_PLANNER.as_bool():
        est = {a: estimate_for_store(cluster, tables[a], _and(side_f[a]))
               for a in aliases}
        if all(e is not None for e in est.values()):
            counts = {a: int(est[a]) for a in aliases}
            model = CostModel(len(cluster._groups),
                              breakers=getattr(cluster, "_breakers", None),
                              leg_names=list(cluster._names))
            lo, hi = sorted(counts.values())
            cost = {"estimator": "stats", "estimated_rows": dict(counts),
                    "threshold": threshold,
                    "broadcast_cost_s": model.broadcast_cost(lo, hi),
                    "materialize_cost_s": model.materialize_cost(lo, hi),
                    "coefficients": model.describe()}
        else:
            cost = {"fallback": "no-stats", "estimated_rows": est,
                    "threshold": threshold}
    if counts is None:        # planner off or cold stats: exact counts
        counts = {a: int(cluster.query_count(Query(tables[a],
                                                   _and(side_f[a]))))
                  for a in aliases}
    eligible = [a for a in aliases if counts[a] <= threshold]
    if j.outer:
        # broadcasting the anchor of a LEFT join would NULL-extend its
        # unmatched rows once per leg; only the right side distributes
        eligible = [a for a in eligible if a == j.alias]
    if not eligible:
        outer_note = ", LEFT join anchors cannot broadcast" \
            if j.outer else ""
        word = "estimated rows" if cost.get("estimator") else "rows"
        err = _Unsupported(
            f"no broadcastable side ({word}: "
            f"{ {a: counts[a] for a in aliases} }, threshold: "
            f"{threshold}{outer_note})")
        if cost:
            err.cost = dict(cost, strategy="cluster-materialize")
        raise err
    small = min(eligible, key=lambda a: counts[a])

    if _count_mode_ok(sel, j, deferred):
        mode = "count"
    elif all(i.agg and i.agg != "st" for i in sel.items) \
            or sel.group_by is not None:
        mode = "agg"
        if any(i.agg == "st" or (not i.agg and "." not in i.expr
                                 and i.expr != "*")
               for i in sel.items):
            raise _Unsupported("select list is not a mergeable "
                               "qualified aggregate")
        if _plan_partials(sel, qualified=True) is None:
            raise _Unsupported("select list is not a mergeable aggregate")
    else:
        if any(i.agg and i.agg != "st" for i in sel.items):
            raise _Unsupported("mixed aggregates and plain columns")
        mode = "rows"
        for it in sel.items:
            if "." not in it.expr and it.expr != "*":
                raise _Unsupported(f"unqualified join column {it.expr!r}")

    sres = cluster.query(Query(tables[small], _and(side_f[small])))
    if cost.get("estimator") == "stats" and sres.n > threshold:
        # the estimate undershot: the fetched side is too big to ship.
        # Fall back to cluster-materialize rather than broadcast a
        # side the operator's threshold forbids.
        err = _Unsupported(
            f"estimated broadcast side {small!r} has {sres.n} rows "
            f"(> threshold {threshold})")
        err.cost = dict(cost, strategy="cluster-materialize",
                        actual_rows=int(sres.n))
        raise err
    sft = cluster.get_schema(tables[small])
    spec = {"sql": text, "broadcast": small, "mode": mode,
            "payload": _encode_batch(tables[small], sft, sres)}
    # Z-prune the scatter by the LOCAL side's pushed filter: a leg
    # whose owned z range cannot hold local-side matches would join
    # the shipped batch against an empty slice — an empty partial
    other = next(a for a in aliases if a != small)
    legs_sel, prune_info = cluster.prune_for(tables[other],
                                             _and(side_f[other]))
    results, missing = cluster.sql_join_partial(
        spec, type_name=f"{tables[sel.alias]}*{tables[j.alias]}",
        legs=legs_sel)
    legs = sorted(results)

    from .engine import SqlResult, _order_limit
    if mode == "count":
        from ..analytics.join import psum_counts
        total = psum_counts(results[n]["count"] for n in legs)
        name = sel.items[0].name
        out = SqlResult([name], {name: np.array([total])})
    elif mode == "agg":
        out = merge_partial_legs(sel, [results[n] for n in legs],
                                 qualified=True)
    else:
        first = (results[legs[0]] if legs
                 else {"names": [it.name for it in sel.items],
                       "cols": {it.name: [] for it in sel.items}})
        names = first["names"]
        cols = {nm: np.array(
            [_dec_cell(v) for n in legs for v in results[n]["cols"][nm]],
            dtype=object) for nm in names}
        out = _order_limit(SqlResult(names, cols), sel.order_by,
                           sel.order_desc, sel.limit)
    out.plan = {
        "mode": "broadcast-join", "distributed": True,
        "join": {"kind": j.kind, "on": [j.left_prop, j.right_prop],
                 "outer": j.outer},
        "broadcast": {"side": small, "table": tables[small],
                      "rows": (int(sres.n)
                               if cost.get("estimator") == "stats"
                               else counts[small]),
                      "threshold": threshold},
        "pushdown": {a: str(_and(side_f[a])) for a in aliases},
        "deferred": [str(f) for _, f in deferred] or None,
        "legs": legs,
        "merge": {"count": "psum", "agg": "by-key" if sel.group_by
                  else "fold", "rows": "concat"}[mode],
    }
    if prune_info is not None:
        out.plan["prune"] = dict(
            prune_info, side=other, contacted=legs,
            pruned=(sorted(set(cluster._names) - set(legs_sel))
                    if legs_sel is not None else []))
    if cost:
        out.plan["cost"] = dict(cost, strategy="broadcast")
    if missing:
        out.plan["missing_groups"] = missing["groups"]
    return _flag(out, missing, sres)
