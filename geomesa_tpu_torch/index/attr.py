"""Sorted-attribute secondary index: the AttributeIndex analog.

The reference stores rows keyed by [attribute value][secondary
date][feature id] and answers attribute predicates with key-range scans
joined back to the record table (AttributeIndex.scala:386-395, with the
secondary date tier of index/AttributeIndex.scala:40,124-158). Here:
one sorted permutation per indexed attribute on the host, keyed
(value, millis) when the schema has a default date. Typed bounds from
``extract_attribute_bounds`` binary-search into the sorted keys and
give contiguous slices of the permutation: row indices into the
columns, so the join is an index operation. Equality slices narrow by
the filter's date bounds inside the composite order.

Dictionary-encoded strings never materialize: bounds translate to
code-space thresholds against the sorted vocab, so a string range scan
is an integer binary search.
"""

from __future__ import annotations

import numpy as np

from ..features.batch import (BoolColumn, Column, DateColumn, NumericColumn,
                              StringColumn)
from ..filters.helper import Bound, FilterValues, to_millis

__all__ = ["AttributeKeyIndex"]


class AttributeKeyIndex:
    """Sorted permutation over one column, keyed (value, date) when a
    secondary date column is supplied; bounds -> candidate rows."""

    def __init__(self, col: Column, date_millis: np.ndarray | None = None):
        if isinstance(col, NumericColumn):
            keys = col.values
            self._kind = "num"
        elif isinstance(col, DateColumn):
            keys = col.millis
            self._kind = "date"
        elif isinstance(col, StringColumn):
            # codes index a sorted vocab, so code order == lexicographic
            keys = col.codes
            self._kind = "str"
            self._vocab = col.vocab.astype(str)
        elif isinstance(col, BoolColumn):
            keys = col.values.astype(np.int8)
            self._kind = "bool"
        else:
            raise TypeError(f"cannot index {type(col).__name__}")
        rows = np.flatnonzero(col.valid)  # nulls are not indexed
        if date_millis is not None:
            dm = np.asarray(date_millis, np.int64)[rows]
            order = np.lexsort((dm, keys[rows]))
            self.sorted_millis = dm[order]
        else:
            order = np.argsort(keys[rows], kind="stable")
            self.sorted_millis = None
        self.sorted_keys = keys[rows][order]
        self.sorted_rows = rows[order]

    @property
    def n(self) -> int:
        return len(self.sorted_rows)

    def _pos(self, bound: Bound, *, lower: bool) -> int:
        """Permutation position for one side of a Bounds interval."""
        if not bound.is_bounded:
            return 0 if lower else self.n
        if lower:
            side = "left" if bound.inclusive else "right"
        else:
            side = "right" if bound.inclusive else "left"
        v = bound.value
        if self._kind == "str":
            # code-space threshold t: lower keeps codes >= t, upper keeps
            # codes < t; inclusivity is absorbed by the vocab search side
            t = np.searchsorted(self._vocab, str(v), side=side)
            # in the keys' dtype: searchsorted would cast all the keys
            return int(np.searchsorted(self.sorted_keys, np.int32(t),
                                       side="left"))
        if self._kind == "date":
            v = to_millis(v)
        elif self._kind == "bool":
            v = np.int8(bool(v))
        return int(np.searchsorted(self.sorted_keys, v, side=side))

    @staticmethod
    def is_point_bound(b) -> bool:
        """An equality bound [v, v]: its slice holds ONE value, so the
        (value, date) order is date-sorted within it and the secondary
        tier can range-scan the date."""
        return (b.lower.is_bounded and b.upper.is_bounded
                and b.lower.inclusive and b.upper.inclusive
                and b.lower.value == b.upper.value)

    def candidates(self, bounds: FilterValues,
                   max_rows: int | None = None,
                   intervals_ms=None) -> np.ndarray | None:
        """Sorted row indices whose value falls in any of the bounds,
        with equality slices narrowed to ``intervals_ms`` (inclusive
        [lo, hi] epoch-millis pairs) by the secondary date key.

        None when the bounds cannot be answered by range scans (an
        empty or unbounded extraction), or when the candidates exceed
        ``max_rows``: wide bounds cost more to gather and re-evaluate
        than a dense column scan (the z index's SCAN_BLOCK_THRESHOLD
        crossover)."""
        if bounds.disjoint:
            return np.empty(0, dtype=np.int64)
        if bounds.is_empty or not any(b.is_bounded for b in bounds):
            return None
        slices = []
        total = 0
        for b in bounds:
            lo = self._pos(b.lower, lower=True)
            hi = self._pos(b.upper, lower=False)
            if hi <= lo:
                continue
            if (intervals_ms and self.sorted_millis is not None
                    and self.is_point_bound(b)):
                seg = self.sorted_millis[lo:hi]
                for iv_lo, iv_hi in intervals_ms:
                    s = lo + int(np.searchsorted(seg, iv_lo, side="left"))
                    e = lo + int(np.searchsorted(seg, iv_hi, side="right"))
                    if e > s:
                        total += e - s
                        if max_rows is not None and total > max_rows:
                            return None
                        slices.append(self.sorted_rows[s:e])
                continue
            total += hi - lo
            if max_rows is not None and total > max_rows:
                return None
            slices.append(self.sorted_rows[lo:hi])
        if not slices:
            return np.empty(0, dtype=np.int64)
        # OR'd bounds may still touch after code-space rounding (and date
        # intervals may overlap); unique sorts and dedupes in one pass
        return np.unique(np.concatenate(slices))
