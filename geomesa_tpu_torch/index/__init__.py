"""Index & query-planning core: the splitter and planner, the z-key
index of point schemas and the XZ-key index of extent schemas."""

from .api import Explainer, FilterStrategy, Query, QueryHints
from .planner import decide_strategy, heuristic_cost
from .splitter import split_filter
from .splitters import (AlphaNumericSplitter, DigitSplitter, HexSplitter,
                        NoSplitter, splitter_for)
from .xzkeys import XZKeyIndex
from .zkeys import SCAN_BLOCK_THRESHOLD, ZKeyIndex, search_rows

__all__ = ["Explainer", "FilterStrategy", "Query", "QueryHints",
           "decide_strategy", "heuristic_cost", "split_filter",
           "SCAN_BLOCK_THRESHOLD", "XZKeyIndex", "ZKeyIndex", "search_rows",
           "AlphaNumericSplitter", "DigitSplitter", "HexSplitter",
           "NoSplitter", "splitter_for"]
