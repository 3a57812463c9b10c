"""Cost-based planning for cluster reads and distributed SQL.

The reference picks scan strategies from maintained stats — the
StatsBasedEstimator feeds CostBasedStrategyDecider's cost phase
(index/planner.py mirrors it per-store). This module lifts the same
idea to the cluster/SQL tier:

- **Cardinality estimates, cluster-merged**: ``estimate_for_store``
  answers "how many rows match this filter" without scanning, from
  whatever surface the store offers — a local ``DataStoreStats``
  sketch registry, a replicated group's primary, a remote group's
  ``/rest/estimate`` endpoint, or a ``ClusterDataStore``'s per-shard
  sum (each shard estimates its own slice; the coordinator adds).
- **Cost model**: ``CostModel`` turns estimated cardinalities into
  wall-clock cost terms for the distributed join strategies (broadcast
  vs cluster-materialize), with the per-leg overhead coefficient
  recalibrated online from the breaker board's observed leg-latency
  EWMAs (``geomesa.sql.planner.recalibrate``).
- **Join ordering**: ``reorder_joins`` greedily orders inner
  multi-join trees smallest-estimated-side-first, respecting each
  ON clause's anchor dependency.

``geomesa.sql.planner=false`` kills all of it: strategy choice falls
back to the exact-count static-threshold path, join order stays as
written, and plans carry no cost terms — bit-identical to the
pre-planner behavior. Cold types with no stats fall back the same
way, flagged ``plan["cost"]["fallback"] = "no-stats"`` — never an
error.
"""

from __future__ import annotations

from ..filters import ast, parse_ecql
from ..utils.properties import PLANNER_RECALIBRATE, SQL_PLANNER

__all__ = ["SQL_PLANNER", "PLANNER_RECALIBRATE", "CostModel",
           "estimate_for_store", "reorder_joins"]

# static cost coefficients (seconds). LEG_OVERHEAD_S is the scatter
# fixed cost per contacted leg (thread + breaker + merge bookkeeping)
# and is the recalibrated term; the per-row terms are transport and
# leg-local scan work. Only *ratios* matter for strategy choice, so
# rough magnitudes are fine — the reported cost terms make the chosen
# boundary auditable.
_LEG_OVERHEAD_S = 2e-3
_SHIP_S_PER_ROW = 2e-6
_SCAN_S_PER_ROW = 2e-7


def _as_filter(f) -> ast.Filter:
    if f is None:
        return ast.Include()
    if isinstance(f, str):
        return parse_ecql(f)
    return f


def estimate_for_store(store, type_name: str, f) -> int | None:
    """Best-effort cardinality estimate of ``f`` over ``store``'s
    ``type_name`` rows, or None when not estimable (cold type, cleared
    stats, unsupported filter shape, unreachable remote). Never
    raises — a planner that errors is worse than one that scans."""
    try:
        f = _as_filter(f)
        # replicated group: stats live on the primary
        primary = getattr(store, "primary", None)
        if primary is not None:
            return estimate_for_store(primary, type_name, f)
        # local store with a sketch registry
        stats = getattr(store, "stats", None)
        if stats is not None and hasattr(stats, "get"):
            est = stats.get(type_name)
            if est is None:
                return None
            return est.estimate_count(f)
        # remote / cluster stores answer through their own surface
        fn = getattr(store, "estimate_count", None)
        if callable(fn):
            return fn(type_name, f)
    except Exception:  # noqa: BLE001 — estimates are advisory
        return None
    return None


class CostModel:
    """Cost terms for the distributed join strategies, in estimated
    wall-clock seconds.

    - broadcast: ship the small side to every leg, each leg joins it
      against its local slice of the big side (scan work parallel
      across legs).
    - materialize: pull both sides to the coordinator and join there
      (all scan work serial at the coordinator).

    ``leg_s`` — the fixed per-leg overhead — recalibrates from the
    cluster breaker board's observed per-leg latency EWMAs when
    ``geomesa.sql.planner.recalibrate`` is on, so a cluster whose legs
    are genuinely slow (remote groups, cold caches) weighs fan-out
    width more heavily than an in-process one.
    """

    def __init__(self, n_legs: int, breakers=None, leg_names=None):
        self.n_legs = max(int(n_legs), 1)
        self.ship_s = _SHIP_S_PER_ROW
        self.scan_s = _SCAN_S_PER_ROW
        self.leg_s = _LEG_OVERHEAD_S
        self.recalibrated = False
        if breakers is not None and PLANNER_RECALIBRATE.as_bool():
            obs = []
            for name in (leg_names or []):
                try:
                    p99 = breakers.latency_p99_s(name)
                except Exception:  # noqa: BLE001 — advisory
                    p99 = None
                if p99:
                    obs.append(float(p99))
            if obs:
                self.leg_s = sum(obs) / len(obs)
                self.recalibrated = True

    def broadcast_cost(self, small_rows: int, big_rows: int) -> float:
        ship = self.n_legs * small_rows * self.ship_s
        scan = big_rows * self.scan_s / self.n_legs
        return self.n_legs * self.leg_s + ship + scan

    def materialize_cost(self, rows_a: int, rows_b: int) -> float:
        pulled = rows_a + rows_b
        return (self.n_legs * self.leg_s + pulled * self.ship_s
                + pulled * self.scan_s)

    def describe(self) -> dict:
        return {"leg_s": self.leg_s, "ship_s_per_row": self.ship_s,
                "scan_s_per_row": self.scan_s, "n_legs": self.n_legs,
                "recalibrated": self.recalibrated}


def _join_anchor(j) -> str | None:
    """The preceding alias a join's ON clause anchors to, or None for
    an irregular ON shape (reorder then bails to statement order)."""
    quals = {j.left_prop.split(".", 1)[0], j.right_prop.split(".", 1)[0]}
    if j.alias not in quals:
        return None
    other = quals - {j.alias}
    if len(other) != 1:
        return None
    return next(iter(other))


def reorder_joins(store, anchor_alias: str, joins, tables: dict,
                  side_f: dict):
    """Greedy smallest-first ordering of an inner multi-join tree:
    each step runs, among the joins whose anchor alias is already
    joined, the one with the smallest estimated (filtered) side —
    shrinking intermediate row sets early, exactly like the
    reference's relation-size join ordering. Returns ``(joins, note)``
    where note is None when the order is unchanged (or the planner is
    off / estimates are unavailable / the tree shape is irregular —
    inner joins only; callers must not pass outer joins)."""
    joins = list(joins)
    if len(joins) < 2 or not SQL_PLANNER.as_bool():
        return joins, None
    est: dict[str, int] = {}
    for j in joins:
        fs = side_f.get(j.alias) or []
        f = ast.And(fs) if len(fs) > 1 else (fs[0] if fs else ast.Include())
        e = estimate_for_store(store, tables[j.alias], f)
        if e is None:
            return joins, None
        est[j.alias] = int(e)
    avail = {anchor_alias}
    remaining = list(joins)
    ordered = []
    while remaining:
        runnable = [j for j in remaining
                    if (_join_anchor(j) or object()) in avail]
        if not runnable:
            return joins, None      # irregular shape: statement order
        pick = min(runnable, key=lambda j: est[j.alias])
        ordered.append(pick)
        avail.add(pick.alias)
        remaining.remove(pick)
    if [j.alias for j in ordered] == [j.alias for j in joins]:
        return joins, None
    note = {"order": [j.alias for j in ordered],
            "estimated_rows": est}
    return ordered, note
