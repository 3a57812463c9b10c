"""Query planner: strategy selection + explain.

Mirrors StrategyDecider (index/planning/StrategyDecider.scala:47-64):
enumerate strategy options via the splitter, cost each by the
index-priority heuristic, pick the cheapest, honoring the QUERY_INDEX
hint override. Stats-based costing arrives with the stats slice of the
port; both costings pick among exact strategies, so the ids a query
returns do not depend on which one ran.
"""

from __future__ import annotations

from ..features.sft import SimpleFeatureType
from ..filters import ast
from .api import Explainer, FilterStrategy, Query, QueryHints
from .splitter import split_filter

__all__ = ["decide_strategy", "heuristic_cost"]

# index-priority costs (id < attr equality < attr range < z3 < z2 < scan);
# a full scan is a last resort
_BASE_COST = {"empty": 0.0, "id": 1.0, "z3": 200.0, "z2": 400.0}
_ATTR_EQ_COST = 10.0
_ATTR_RANGE_COST = 100.0
_FULLSCAN_PENALTY = 1e9


def heuristic_cost(s: FilterStrategy, n_features: int) -> float:
    if s.index.startswith("attr:"):
        if isinstance(s.primary, ast.Compare) and s.primary.op == "=":
            return _ATTR_EQ_COST
        return _ATTR_RANGE_COST
    if s.index == "fullscan":
        return _FULLSCAN_PENALTY + float(max(n_features, 1))
    return _BASE_COST.get(s.index, 1e9)


def decide_strategy(sft: SimpleFeatureType, query: Query,
                    indices: list[str], n_features: int,
                    explain: Explainer | None = None) -> FilterStrategy:
    """Pick the best strategy (StrategyDecider.getFilterPlan analog)."""
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
        s.cost = heuristic_cost(s, n_features)
        explain(lambda s=s: f"option: {s}")
        if best is None or s.cost < best.cost:
            best = s
    explain(lambda: f"Selected: {best}")
    explain.pop()
    return best
