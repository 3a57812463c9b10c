"""Host-side sorted XZ-key index: extent-geometry range pruning.

The analog of the reference's XZ2/XZ3 index key spaces
(geomesa-index-api's index/z2/XZ2IndexKeySpace.scala and
index/z3/XZ3IndexKeySpace.scala; curve math XZ2SFC.scala:146-252): extent
geometries key by their XZ sequence code (from the bounding box), the
table sorts by [time bin][code], and a query decomposes into covering
code ranges so scans touch only intersecting candidates.

Same architecture as the point-geometry ZKeyIndex (index/zkeys.py):
device/host columns stay in insertion order; the sorted thing is a
host key array + permutation; candidate sets over-approximate and an
exact predicate always re-checks them.
"""

from __future__ import annotations

import numpy as np

from ..curves import timebin
from ..curves.timebin import TimePeriod
from ..curves.xz import xz2sfc, xz3sfc
from .zkeys import binned_candidate_positions, multi_arange

__all__ = ["XZKeyIndex"]


class XZKeyIndex:
    """Sorted xz2 / (bin, xz3) code orders over extent bounds.

    ``bounds`` is the (n, 4) xmin/ymin/xmax/ymax array (nan rows =
    null geometries, never candidates); ``millis`` may be None for a
    time-less schema (xz2 only).
    """

    def __init__(self, bounds: np.ndarray, millis: np.ndarray | None,
                 period: TimePeriod | str = TimePeriod.WEEK):
        self._bounds = np.asarray(bounds, dtype=np.float64)
        self._millis = (None if millis is None
                        else np.asarray(millis, dtype=np.int64))
        self.period = TimePeriod.parse(period)
        self.n = len(self._bounds)
        self._valid = ~np.isnan(self._bounds[:, 0])
        # lenient indexing clamps out-of-domain bounds, so such rows
        # could land outside a query's covering ranges: they stay
        # unconditional candidates instead
        b = self._bounds
        esc = self._valid & ((b[:, 0] < -180) | (b[:, 1] < -90)
                             | (b[:, 2] > 180) | (b[:, 3] > 90))
        self._escape = np.flatnonzero(esc).astype(np.int64)
        self._valid = self._valid & ~esc
        self._xz2 = None  # (codes_sorted, perm)
        self._xz3 = None  # (ubins, seg_offsets, codes_sorted, perm)

    # -- build -------------------------------------------------------------

    def _build_xz2(self):
        if self._xz2 is None:
            rows = np.flatnonzero(self._valid)
            b = self._bounds[rows]
            codes = xz2sfc().index_boxes(b[:, 0], b[:, 1], b[:, 2],
                                         b[:, 3], lenient=True)
            order = np.argsort(codes, kind="stable")
            self._xz2 = (codes[order], rows[order].astype(np.int64))
        return self._xz2

    def _build_xz3(self):
        if self._xz3 is None and self._millis is not None:
            rows = np.flatnonzero(self._valid)
            b = self._bounds[rows]
            bins, offs = timebin.to_binned(self._millis[rows], self.period,
                                           lenient=True)
            off = offs.astype(np.float64)
            sfc = xz3sfc(period=self.period)
            codes = sfc.index_boxes(b[:, 0], b[:, 1], off,
                                    b[:, 2], b[:, 3], off, lenient=True)
            perm = np.lexsort((codes, bins))
            bins_s = bins[perm]
            ubins, seg_starts = np.unique(bins_s, return_index=True)
            self._xz3 = (ubins, np.append(seg_starts, len(bins_s)),
                         codes[perm], rows[perm].astype(np.int64))
        return self._xz3

    # -- candidates --------------------------------------------------------

    def candidates_xz2(self, boxes, *, max_rows: int | None = None,
                       max_ranges: int | None = None) -> np.ndarray | None:
        """Candidate rows whose extent may intersect any query box."""
        codes_sorted, perm = self._build_xz2()
        ranges = xz2sfc().ranges(
            [(b[0], b[1], b[2], b[3]) for b in boxes],
            max_ranges=max_ranges)
        if len(ranges) == 0:
            return np.empty(0, dtype=np.int64)
        los = np.searchsorted(codes_sorted, ranges[:, 0], side="left")
        his = np.searchsorted(codes_sorted, ranges[:, 1], side="right")
        # escape rows count against the cap: they join every candidate
        # set unconditionally
        if max_rows is not None and \
                int(np.sum(his - los)) + len(self._escape) > max_rows:
            return None
        pos = multi_arange(los, his)
        cand = perm[pos] if len(pos) else np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate([cand, self._escape]))

    def candidates_xz3(self, boxes, intervals_ms, *,
                       max_rows: int | None = None,
                       max_ranges: int | None = None) -> np.ndarray | None:
        """Per-time-bin fan-out like the z3 index: interior bins use
        whole-period windows, edge bins their partial offsets."""
        built = self._build_xz3()
        if built is None:
            return None
        ubins, seg_offsets, codes_sorted, perm = built
        sfc = xz3sfc(period=self.period)

        def range_fn(key):
            lo_off, hi_off = key
            return sfc.ranges(
                [(bx[0], bx[1], float(lo_off),
                  bx[2], bx[3], float(hi_off)) for bx in boxes],
                max_ranges=max_ranges)

        pos = binned_candidate_positions(
            ubins, seg_offsets, codes_sorted, intervals_ms, self.period,
            range_fn, max_rows,
            base_total=len(self._escape))  # escapes count against cap
        if pos is None:
            return None
        cand = perm[pos] if len(pos) else np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate([cand, self._escape]))
