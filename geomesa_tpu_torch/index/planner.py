"""Query planner: strategy selection + explain.

Mirrors StrategyDecider/CostBasedStrategyDecider
(index/planning/StrategyDecider.scala:47-64): enumerate strategy options
via the splitter, cost each (stats-based when the store keeps stats for
the type, index-priority heuristics otherwise), pick the cheapest,
honoring the QUERY_INDEX hint override. Every strategy is exact, so the
ids a query returns do not depend on which one ran.
"""

from __future__ import annotations

from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import extract_intervals
from .api import Explainer, FilterStrategy, Query, QueryHints
from .splitter import split_filter

__all__ = ["decide_strategy", "heuristic_cost"]

# index-priority costs (id < attr equality < attr range < z3 < xz3 < z2
# < xz2 < scan) when no stats are available
_BASE_COST = {"empty": 0.0, "id": 1.0, "z3": 200.0, "xz3": 201.0,
              "z2": 400.0, "xz2": 401.0}
_ATTR_EQ_COST = 10.0
_ATTR_RANGE_COST = 100.0
# a full scan is a last resort, never a tie-winner
_FULLSCAN_PENALTY = 1e9


def heuristic_cost(sft: SimpleFeatureType, s: FilterStrategy,
                   n_features: int) -> float:
    if s.index.startswith("attr:"):
        if isinstance(s.primary, ast.Compare) and s.primary.op == "=":
            return _ATTR_EQ_COST
        return _ATTR_RANGE_COST
    if s.index == "fullscan":
        return _FULLSCAN_PENALTY + float(max(n_features, 1))
    return _BASE_COST.get(s.index, 1e9)


def decide_strategy(sft: SimpleFeatureType, query: Query,
                    indices: list[str], n_features: int,
                    stats=None, explain: Explainer | None = None
                    ) -> FilterStrategy:
    """Pick the best strategy (StrategyDecider.getFilterPlan analog);
    ``stats`` is the type's StatsEstimator, or None for the heuristic."""
    explain = explain or Explainer()
    options = split_filter(sft, query.filter, indices)
    explain.push(lambda: f"Strategy options for '{query.filter}':")

    forced = query.hints.get(QueryHints.QUERY_INDEX)
    if forced:
        for s in options:
            if s.index == forced or s.index.startswith(f"{forced}:"):
                explain(f"Forced via QUERY_INDEX hint: {s}")
                explain.pop()
                return s
        explain(f"QUERY_INDEX={forced} requested but not viable; ignoring")

    best = None
    for s in options:
        if stats is not None:
            s.cost = _stats_cost(sft, s, stats, n_features)
        else:
            s.cost = heuristic_cost(sft, s, n_features)
        explain(lambda s=s: f"option: {s}")
        if best is None or s.cost < best.cost:
            best = s
    explain(lambda: f"Selected: {best}")
    explain.pop()
    return best


def _stats_cost(sft: SimpleFeatureType, s: FilterStrategy, stats,
                n_features: int) -> float:
    """Stats-based cost: estimated matching count for the primary
    (StatsBasedEstimator analog); falls back to heuristics."""
    if s.index == "empty":
        return 0.0
    if s.index == "fullscan":
        return _FULLSCAN_PENALTY + float(max(n_features, 1))
    if s.primary is None:
        return float(max(n_features, 1))
    if s.index.startswith("attr:"):
        cost = heuristic_cost(sft, s, n_features)
        # sketch-backed equality selectivity: a predicate on a value
        # covering most of the table must lose to a selective z strategy
        # (StatsBasedEstimator.scala:27)
        if (isinstance(s.primary, ast.Compare)
                and s.primary.op == ast.CompareOp.EQ):
            est = stats.attr_equality_estimate(
                s.index.split(":", 1)[1], s.primary.value)
            if est is not None:
                cost = float(est)
        # secondary (value, date) tiering: an equality scan narrowed by
        # the residual's date bounds touches only the matching time
        # bins, so its cost scales with the temporal selectivity
        # (AttributeIndex.scala:124-158)
        if (sft.dtg_field is not None and s.secondary is not None
                and isinstance(s.primary, ast.Compare)
                and s.primary.op == ast.CompareOp.EQ):
            iv = extract_intervals(s.secondary, sft.dtg_field)
            frac = stats.temporal_fraction(iv)
            if frac is not None:
                cost *= max(frac, 1e-3)
        return cost
    try:
        est = stats.estimate_count(s.primary)
    except Exception:
        est = None
    if est is None:
        return heuristic_cost(sft, s, n_features)
    # small bias keeps z3 preferred over z2 at equal selectivity
    return est + _BASE_COST.get(s.index, 500.0) / 1e6
