"""Host-side sorted z-key index: query ranges -> candidate rows.

The analog of the reference's key-range pruning (Z3IndexKeySpace.getRanges,
geomesa-index-api/.../index/z3/Z3IndexKeySpace.scala:121-136): the
device columns stay in insertion order, and what is sorted is a
host-side key array + permutation. Planning a query:

    boxes + time intervals
      -> per-bin z ranges (curves/zranges.py)
      -> binary search into the sorted keys (np.searchsorted)
      -> candidate row positions -> original row ids via the permutation

The candidate set over-approximates the matches; either the host tier
evaluates it exactly here, or the store's gathered device tier does.
Sort orders build lazily per curve, with numpy (the native C++ sort and
encode fast paths of the reference package are a later slice).
"""

from __future__ import annotations

import numpy as np

from ..curves import timebin
from ..curves.sfc import z2sfc, z3sfc
from ..curves.timebin import TimePeriod
from ..utils.properties import HOST_RANGES_TARGET, SystemProperty

__all__ = ["ZKeyIndex", "multi_arange", "search_rows", "prune_candidates",
           "binned_candidate_positions", "SCAN_BLOCK_THRESHOLD"]

# candidate-fraction above which an indexed scan falls back to the dense
# full-batch kernel (gather cost crossover)
SCAN_BLOCK_THRESHOLD = SystemProperty("geomesa.scan.index.threshold", "0.4")

_WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)


def multi_arange(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(starts[i], stops[i])`` without a Python loop."""
    starts = np.asarray(starts, dtype=np.int64)
    stops = np.asarray(stops, dtype=np.int64)
    counts = stops - starts
    keep = counts > 0
    starts, counts = starts[keep], counts[keep]
    if len(starts) == 0:
        return np.empty(0, dtype=np.int64)
    total = int(counts.sum())
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


def binned_candidate_positions(ubins, seg_offsets, keys_sorted,
                               intervals_ms, period, range_fn,
                               max_rows: int | None,
                               base_total: int = 0) -> np.ndarray | None:
    """Per-time-bin fan-out (Z3IndexKeySpace.getRanges:100-136): clamp
    intervals into the indexable range, union per-bin offset hulls, and
    binary-search each bin's covering ranges inside its sorted segment.
    Returns positions into the sorted order, an empty array when nothing
    matches, or None when the interval set is empty or the candidate
    count (plus ``base_total``) exceeds ``max_rows``. Used by the z3
    point index and the xz3 extent index."""
    cap = timebin.max_date_millis(period) - 1
    by_bin: dict[int, list[int]] = {}
    for lo_ms, hi_ms in intervals_ms:
        if hi_ms < lo_ms:
            continue
        lo_ms = min(max(int(lo_ms), 0), cap)
        hi_ms = min(max(int(hi_ms), 0), cap)
        bs, los, his = timebin.bins_of_interval(lo_ms, hi_ms, period)
        for b, lo, hi in zip(bs.tolist(), los.tolist(), his.tolist()):
            cur = by_bin.get(b)
            if cur is None:
                by_bin[b] = [lo, hi]
            else:
                # over-approximate disjoint unions with the hull; the
                # exact re-check downstream handles every candidate
                cur[0] = min(cur[0], lo)
                cur[1] = max(cur[1], hi)
    if not by_bin:
        return None
    if max_rows is not None and base_total > max_rows:
        return None
    range_cache: dict[tuple, np.ndarray] = {}
    pieces: list[np.ndarray] = []
    total = base_total
    for b in sorted(by_bin):
        i = int(np.searchsorted(ubins, b))
        if i >= len(ubins) or int(ubins[i]) != b:
            continue
        s, e = int(seg_offsets[i]), int(seg_offsets[i + 1])
        key = tuple(by_bin[b])
        ranges = range_cache.get(key)
        if ranges is None:
            ranges = range_cache[key] = range_fn(key)
        if len(ranges) == 0:
            continue
        seg = keys_sorted[s:e]
        los = s + np.searchsorted(seg, ranges[:, 0], side="left")
        his = s + np.searchsorted(seg, ranges[:, 1], side="right")
        total += int(np.sum(his - los))
        if max_rows is not None and total > max_rows:
            return None
        pos = multi_arange(los, his)
        if len(pos):
            pieces.append(pos)
    if not pieces:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(pieces)


def search_rows(zindex: "ZKeyIndex | None", index_name: str, boxes,
                intervals, host_cap: int | None, block_cap: int | None):
    """The store-level tier policy: whole-world gate, then one range
    decomposition via ``zindex.query_rows`` serving both index tiers —
    ("exact", rows) under ``host_cap``, ("candidates", rows) under
    ``block_cap``, (None, None) for the dense path."""
    whole_world = list(boxes) == [_WHOLE_WORLD]
    if zindex is None or (whole_world
                          and not (index_name == "z3" and intervals)):
        return None, None
    return zindex.query_rows(index_name, boxes, intervals, host_cap,
                             block_cap)


def prune_candidates(zindex, index_name: str, boxes, intervals,
                     max_rows: int | None) -> np.ndarray | None:
    """The pruning policy of the xz2/xz3 extent orders: the
    spatio-temporal or spatial-only order for the strategy, no pruning
    for an unconstrained (whole-world, no-time) query, and None (the
    caller's dense path) when the candidates exceed ``max_rows``.
    Returns candidate row indices or None."""
    whole_world = list(boxes) == [_WHOLE_WORLD]
    if zindex is None or (whole_world and not intervals):
        return None
    if index_name in ("z3", "xz3") and intervals:
        fn = getattr(zindex, f"candidates_{index_name}", None)
        return None if fn is None else fn(boxes, intervals,
                                          max_rows=max_rows)
    if not whole_world:
        spatial = "xz2" if index_name.startswith("xz") else "z2"
        fn = getattr(zindex, f"candidates_{spatial}", None)
        return None if fn is None else fn(boxes, max_rows=max_rows)
    return None


class ZKeyIndex:
    """Sorted (bin, z3) and z2 key orders over point columns.

    Parameters are host arrays in insertion order; ``millis`` may be
    None for a time-less schema (z2 only).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray,
                 millis: np.ndarray | None,
                 period: TimePeriod | str = TimePeriod.WEEK):
        self._x = np.asarray(x, dtype=np.float64)
        self._y = np.asarray(y, dtype=np.float64)
        self._millis = (None if millis is None
                        else np.asarray(millis, dtype=np.int64))
        self.period = TimePeriod.parse(period)
        self.n = len(self._x)
        if self.n >= 2**31:
            raise ValueError("a single table holds fewer than 2^31 rows")
        self._z3 = None  # (ubins, seg_offsets, z_sorted, perm)
        self._z2 = None  # (z_sorted, perm)

    # -- build -------------------------------------------------------------

    def _build_z3(self):
        if self._z3 is not None or self._millis is None:
            return self._z3
        bins, offs = timebin.to_binned(self._millis, self.period,
                                       lenient=True)
        z = z3sfc(self.period).index(self._x, self._y,
                                     offs.astype(np.float64),
                                     lenient=True).astype(np.int64)
        perm = np.lexsort((z, bins)).astype(np.int32)
        bins_sorted = bins[perm]
        z_sorted = z[perm]
        ubins, seg_starts = np.unique(bins_sorted, return_index=True)
        self._z3 = (ubins, np.append(seg_starts, self.n), z_sorted, perm)
        return self._z3

    def _build_z2(self):
        if self._z2 is None:
            z = z2sfc().index(self._x, self._y,
                              lenient=True).astype(np.int64)
            perm = np.argsort(z, kind="stable").astype(np.int32)
            self._z2 = (z[perm], perm)
        return self._z2

    # -- incremental maintenance -------------------------------------------

    def extend(self, x: np.ndarray, y: np.ndarray,
               millis: np.ndarray | None) -> "ZKeyIndex":
        """New index covering the existing rows plus appended rows, with
        already-built sort orders MERGED (sorted-run merge: O(N) memcpy
        + O(D log D) delta sort) instead of re-sorted from scratch."""
        if (self._millis is None) != (millis is None):
            raise ValueError("time column presence must match")
        out = ZKeyIndex(
            np.concatenate([self._x, np.asarray(x, dtype=np.float64)]),
            np.concatenate([self._y, np.asarray(y, dtype=np.float64)]),
            None if millis is None else np.concatenate(
                [self._millis, np.asarray(millis, dtype=np.int64)]),
            self.period)
        if self._z3 is not None:
            out._z3 = self._merged_z3(x, y, millis)
        if self._z2 is not None:
            out._z2 = self._merged_z2(x, y)
        return out

    def _merged_z2(self, x, y):
        z_sorted, perm = self._z2
        dz = z2sfc().index(np.asarray(x, dtype=np.float64),
                           np.asarray(y, dtype=np.float64),
                           lenient=True).astype(np.int64)
        dorder = np.argsort(dz, kind="stable")
        dzs = dz[dorder]
        # side="right": appended rows land after equal existing keys,
        # preserving stable insertion order
        pos = np.searchsorted(z_sorted, dzs, side="right")
        return (np.insert(z_sorted, pos, dzs),
                np.insert(perm, pos, (dorder + self.n).astype(perm.dtype)))

    def _merged_z3(self, x, y, millis):
        ubins, seg_offsets, z_sorted, perm = self._z3
        dbins, doffs = timebin.to_binned(np.asarray(millis, dtype=np.int64),
                                         self.period, lenient=True)
        dz = z3sfc(self.period).index(
            np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64),
            doffs.astype(np.float64), lenient=True).astype(np.int64)
        dorder = np.lexsort((dz, dbins))
        dbs, dzs = dbins[dorder], dz[dorder]
        pos = np.empty(len(dbs), dtype=np.int64)
        # per distinct delta bin: binary search within the bin's segment
        for b in np.unique(dbs):
            m = dbs == b
            i = int(np.searchsorted(ubins, b))
            if i < len(ubins) and int(ubins[i]) == b:
                s, e = int(seg_offsets[i]), int(seg_offsets[i + 1])
                pos[m] = s + np.searchsorted(z_sorted[s:e], dzs[m],
                                             side="right")
            else:
                # a bin the table has not seen: insert at the boundary
                pos[m] = int(seg_offsets[i])
        bins_sorted = np.repeat(ubins, np.diff(seg_offsets))
        new_bins = np.insert(bins_sorted, pos, dbs)
        # new_bins is sorted: segment bounds from value changes
        steps = np.flatnonzero(new_bins[1:] != new_bins[:-1]) + 1
        seg_starts = np.concatenate([[0], steps])
        return (new_bins[seg_starts], np.append(seg_starts, len(new_bins)),
                np.insert(z_sorted, pos, dzs),
                np.insert(perm, pos, (dorder + self.n).astype(perm.dtype)))

    # -- search ------------------------------------------------------------

    def _eval_rows(self, rows, boxes, intervals_ms) -> np.ndarray:
        """Exact f64 evaluation over original-order rows; identical
        semantics to zscan.exact_patch (inclusive box bounds, inclusive
        [lo, hi] millis intervals). Returns keep mask over rows."""
        x = self._x[rows]
        y = self._y[rows]
        keep = np.zeros(len(rows), dtype=bool)
        for xmin, ymin, xmax, ymax in boxes:
            keep |= ((x >= xmin) & (x <= xmax)
                     & (y >= ymin) & (y <= ymax))
        if intervals_ms:
            m = self._millis[rows]
            tk = np.zeros(len(rows), dtype=bool)
            for lo, hi in intervals_ms:
                tk |= (m >= lo) & (m <= hi)
            keep &= tk
        return keep

    def query_rows(self, index_name: str, boxes, intervals_ms,
                   host_cap: int | None, block_cap: int | None):
        """ONE range decomposition serving both index tiers: returns
        ("exact", sorted int64 rows) when the candidates fit
        ``host_cap``, ("candidates", int32 rows in z-order) when they fit
        only ``block_cap`` (caller runs the gathered device scan), or
        (None, None) for the dense path."""
        use_z3 = index_name == "z3" and bool(intervals_ms)
        # the z2 order cannot evaluate time: with intervals present but
        # no z3 order in play, results may only be CANDIDATES
        exact_ok = use_z3 or not intervals_ms
        # the host tiers re-check every candidate exactly, so a coarse
        # cover only grows the candidate set (SCAN_RANGES_TARGET analog)
        max_ranges = int(HOST_RANGES_TARGET.get())
        if use_z3:
            built = self._build_z3()
            if built is None:
                return None, None
            ubins, seg_offsets, z_sorted, perm = built
            sfc = z3sfc(self.period)
            pos = binned_candidate_positions(
                ubins, seg_offsets, z_sorted, intervals_ms, self.period,
                lambda key: sfc.ranges(boxes, [key], max_ranges=max_ranges),
                block_cap)
        else:
            z_sorted, perm = self._build_z2()
            ranges = z2sfc().ranges(boxes, max_ranges=max_ranges)
            los = np.searchsorted(z_sorted, ranges[:, 0], side="left")
            his = np.searchsorted(z_sorted, ranges[:, 1], side="right")
            if block_cap is not None and int(np.sum(his - los)) > block_cap:
                pos = None
            else:
                pos = multi_arange(los, his)
        if pos is None:
            return None, None
        # the perm's own int32: the gathered kernel takes int32 ids
        rows = perm[pos]
        if not exact_ok or (host_cap is not None and len(pos) > host_cap):
            return "candidates", rows
        keep = self._eval_rows(rows, boxes, intervals_ms if use_z3 else [])
        return "exact", np.sort(rows[keep]).astype(np.int64)
