"""Incrementally-maintained materialized views.

Standing single-table GROUP BY aggregate statements folded on every
write-path commit: O(delta rows) per group-commit instead of O(table)
per refresh, bit-identical to a from-scratch re-execution at the same
LSN (including under deletes), served through the LSN-keyed result
cache and streamed as group deltas on ``view.<name>`` bus topics.
"""

from .registry import (VIEW_RESERVOIR_K, VIEWS_ENABLED,
                       MaterializedView, ViewRegistry)
from .state import ViewState, compile_view
from .subscribe import ViewDeltaSubscriber, view_topic

__all__ = ["ViewRegistry", "MaterializedView", "ViewState",
           "compile_view", "ViewDeltaSubscriber", "view_topic",
           "VIEWS_ENABLED", "VIEW_RESERVOIR_K"]
