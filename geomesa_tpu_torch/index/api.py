"""Index/query API core of the point query slice: Query, FilterStrategy,
Explainer.

Mirrors the reference's geomesa-index-api surface: ``FilterStrategy``
(index/api/FilterPlan.scala:19-34) and the tree-style ``Explainer``
(index/utils/Explainer.scala:16-56).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..filters import ast
from ..filters.ecql import parse_ecql

__all__ = ["Query", "FilterStrategy", "Explainer", "QueryHints"]


class QueryHints:
    """Per-query hint keys (index/conf/QueryHints.scala:22-68). The
    store's query() reads QUERY_INDEX, SAMPLING and SAMPLE_BY and, as
    the reference's does, accepts and ignores the rest: its pushdowns
    (stats_query, density, bin_query, arrow_ipc) take their parameters
    as arguments."""
    DENSITY_BBOX = "DENSITY_BBOX"
    DENSITY_WIDTH = "DENSITY_WIDTH"
    DENSITY_HEIGHT = "DENSITY_HEIGHT"
    DENSITY_WEIGHT = "DENSITY_WEIGHT"
    STATS_STRING = "STATS_STRING"
    ENCODE_STATS = "ENCODE_STATS"
    BIN_TRACK = "BIN_TRACK"
    BIN_GEOM = "BIN_GEOM"
    BIN_DTG = "BIN_DTG"
    BIN_LABEL = "BIN_LABEL"
    BIN_SORT = "BIN_SORT"
    BIN_BATCH_SIZE = "BIN_BATCH_SIZE"
    ARROW_ENCODE = "ARROW_ENCODE"
    ARROW_DICTIONARY_FIELDS = "ARROW_DICTIONARY_FIELDS"
    SAMPLING = "SAMPLING"
    SAMPLE_BY = "SAMPLE_BY"
    QUERY_INDEX = "QUERY_INDEX"
    COST_EVALUATION = "COST_EVALUATION"
    EXACT_COUNT = "EXACT_COUNT"
    LOOSE_BBOX = "LOOSE_BBOX"


@dataclasses.dataclass
class Query:
    """A query against one feature type (GeoTools Query analog)."""
    type_name: str
    filter: ast.Filter = dataclasses.field(default_factory=ast.Include)
    properties: list[str] | None = None      # projection; None = all
    max_features: int | None = None
    sort_by: str | None = None
    sort_desc: bool = False
    hints: dict[str, Any] = dataclasses.field(default_factory=dict)
    auths: list[str] | None = None   # visibility authorizations

    def __post_init__(self):
        if isinstance(self.filter, str):
            self.filter = parse_ecql(self.filter)


@dataclasses.dataclass
class FilterStrategy:
    """A possible way to run a query against one index: the primary
    (index-consumable) part and the secondary (residual) part."""
    index: str
    primary: ast.Filter | None
    secondary: ast.Filter | None
    cost: float = 0.0

    def __str__(self) -> str:
        p = str(self.primary) if self.primary else "INCLUDE"
        s = str(self.secondary) if self.secondary else "None"
        return f"{self.index}[primary={p}, secondary={s}, cost={self.cost:g}]"


class Explainer:
    """Tree-structured explain output (index/utils/Explainer.scala)."""

    def __init__(self, out: Callable[[str], None] | None = None):
        self._depth = 0
        self._lines: list = []
        self._out = out

    def __call__(self, msg) -> "Explainer":
        """``msg`` may be a zero-arg callable, formatted only when the
        text is read."""
        if self._out is None and callable(msg):
            self._lines.append(("  " * self._depth, msg))
            return self
        if callable(msg):
            msg = msg()
        line = "  " * self._depth + str(msg)
        self._lines.append(line)
        if self._out:
            self._out(line)
        return self

    def push(self, msg=None) -> "Explainer":
        if msg is not None:
            self(msg)
        self._depth += 1
        return self

    def pop(self) -> "Explainer":
        self._depth = max(0, self._depth - 1)
        return self

    @property
    def text(self) -> str:
        out = []
        for ln in self._lines:
            if isinstance(ln, tuple):
                indent, fn = ln
                out.append(indent + str(fn()))
            else:
                out.append(ln)
        return "\n".join(out)
