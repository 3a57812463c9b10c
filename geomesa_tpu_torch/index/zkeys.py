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
Sort orders build lazily per curve, in the native host library
(``native/src/zbuild.cpp``, ``zsort.cpp``): the fused clamp + bin + z3
encode, a counting sort by bin with radix-sorted segments, and the
sorted-order coordinate copies of the host tier (``gather_xyz``). Each
has its numpy plain twin beside it (``*_plain``), equal bit for bit, tie
order included.

An index has a layout version: 1 sorts and prunes by the legacy z3
curve (``curves/legacy.py``), 2 by the current one. The sort order and
every query's ranges come from the same curve, or pruning would drop
rows silently.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..curves import timebin
from ..curves.legacy import legacy_z3sfc
from ..curves.sfc import z2sfc, z3sfc
from ..curves.timebin import TimePeriod
from ..utils.properties import HOST_RANGES_TARGET, SystemProperty

__all__ = ["ZKeyIndex", "multi_arange", "search_rows", "prune_candidates",
           "binned_candidate_positions", "SCAN_BLOCK_THRESHOLD",
           "encode_binned_z3", "encode_binned_z3_plain", "sort_bin_z",
           "sort_bin_z_plain", "sort_z", "sort_z_plain", "gather_xyz",
           "gather_xyz_plain"]

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


# -- native build paths and their plain twins -------------------------------

_PERIOD_CODE = {TimePeriod.DAY: 0, TimePeriod.WEEK: 1}
_EDGE_CACHE: dict = {}  # period -> int64 bin-edge epoch millis


def _bin_edges(period: TimePeriod) -> np.ndarray:
    """Epoch millis of every MONTH or YEAR bin's first instant, one past
    the last indexable bin included (computed once, 262 KB)."""
    if period not in _EDGE_CACHE:
        unit = "M" if period is TimePeriod.MONTH else "Y"
        grid = np.arange(0, timebin.MAX_BIN + 2).astype(f"datetime64[{unit}]")
        _EDGE_CACHE[period] = grid.astype("datetime64[ms]").astype(np.int64)
    return _EDGE_CACHE[period]


def _raise_rc(rc: int, name: str):
    if rc != 0:
        raise ValueError(f"{name} refused its inputs ({rc})")


def encode_binned_z3(x, y, millis, period):
    """(bins int32, z int64) of the current z3 curve in one native pass:
    the lenient clamp, the bin split and the encode, fused. DAY and WEEK
    split by constant divisors; MONTH and YEAR search a table of bin
    edges."""
    period = TimePeriod.parse(period)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    millis = np.ascontiguousarray(millis, dtype=np.int64)
    n = len(x)
    if x.ndim != 1 or y.shape != (n,) or millis.shape != (n,):
        raise ValueError("x, y and millis must be 1-d of one length")
    bins = np.empty(n, dtype=np.int32)
    z = np.empty(n, dtype=np.int64)
    if n == 0:
        return bins, z
    lib = native.library()
    t_max = float(z3sfc(period).time.max)
    args = (native.ptr(x, native.F64P), native.ptr(y, native.F64P),
            native.ptr(millis, native.I64P), n)
    out = (native.ptr(bins, native.I32P), native.ptr(z, native.I64P))
    code = _PERIOD_CODE.get(period)
    if code is not None:
        rc = lib.geomesa_encode_binned_z3(*args, code, t_max, *out)
    else:
        edges = _bin_edges(period)
        off_div = 1000 if period is TimePeriod.MONTH else 60_000
        rc = lib.geomesa_encode_binned_z3_edges(
            *args, native.ptr(edges, native.I64P), len(edges) - 1, off_div,
            t_max, *out)
    _raise_rc(rc, "geomesa_encode_binned_z3")
    return bins, z


def encode_binned_z3_plain(x, y, millis, period):
    """``encode_binned_z3`` in numpy: to_binned, then the lenient z3."""
    bins, offs = timebin.to_binned_plain(millis, period, lenient=True)
    z = z3sfc(period).index_plain(x, y, offs.astype(np.float64),
                                  lenient=True).astype(np.int64)
    return bins, z


def _check_keys(z: np.ndarray):
    if len(z) and int(z.min()) < 0:
        raise ValueError("z-order keys are non-negative")


def sort_bin_z(bins, z):
    """(z_sorted, perm int32, ubins, seg_offsets): the rows ordered by
    (bin, z, row), as np.lexsort((z, bins)) orders them; ubins are the
    bins present and seg_offsets their segments' bounds in that order.
    Natively: a counting sort by bin, then each bin's segment radix
    sorted, on as many threads as the rows are worth."""
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    z = np.ascontiguousarray(z, dtype=np.int64)
    n = len(z)
    if bins.shape != (n,) or n >= 2**31:
        raise ValueError("bins and z must be 1-d of one length under 2^31")
    if n == 0:
        return (z.copy(), np.empty(0, np.int32), bins.copy(),
                np.zeros(1, np.int64))
    _check_keys(z)
    max_bin = int(bins.max())
    perm = np.empty(n, dtype=np.int32)
    z_sorted = np.empty(n, dtype=np.int64)
    offsets = np.empty(max_bin + 2, dtype=np.int64)
    rc = native.library().geomesa_sort_bin_z(
        native.ptr(bins, native.I32P), native.ptr(z, native.I64P), n,
        max_bin, native.ptr(perm, native.I32P),
        native.ptr(z_sorted, native.I64P), native.ptr(offsets, native.I64P))
    _raise_rc(rc, "geomesa_sort_bin_z (a bin outside [0, 2^20]?)")
    # the counting sort's prefix sums give the segments without a pass
    present = np.diff(offsets) > 0
    ubins = np.flatnonzero(present).astype(np.int32)
    return z_sorted, perm, ubins, np.append(offsets[:-1][present], n)


def sort_bin_z_plain(bins, z):
    """``sort_bin_z`` in numpy (np.lexsort, then np.unique)."""
    bins = np.asarray(bins, dtype=np.int32)
    z = np.asarray(z, dtype=np.int64)
    perm = np.lexsort((z, bins)).astype(np.int32)
    ubins, seg_starts = np.unique(bins[perm], return_index=True)
    return z[perm], perm, ubins, np.append(seg_starts, len(z))


def sort_z(z):
    """(z_sorted, perm int32): the rows ordered by (z, row), as a stable
    argsort orders them. Natively: one MSD pass, then radix-sorted
    buckets."""
    z = np.ascontiguousarray(z, dtype=np.int64)
    n = len(z)
    if z.ndim != 1 or n >= 2**31:
        raise ValueError("z must be 1-d, under 2^31 rows")
    if n == 0:
        return z.copy(), np.empty(0, np.int32)
    _check_keys(z)
    perm = np.empty(n, dtype=np.int32)
    z_sorted = np.empty(n, dtype=np.int64)
    rc = native.library().geomesa_sort_z(
        native.ptr(z, native.I64P), n, native.ptr(perm, native.I32P),
        native.ptr(z_sorted, native.I64P))
    _raise_rc(rc, "geomesa_sort_z")
    return z_sorted, perm


def sort_z_plain(z):
    """``sort_z`` in numpy (a stable argsort)."""
    z = np.asarray(z, dtype=np.int64)
    perm = np.argsort(z, kind="stable").astype(np.int32)
    return z[perm], perm


def gather_xyz(x, y, ms, perm):
    """(x[perm], y[perm], ms[perm] or None) in one threaded native pass:
    perm read once a row, the outputs written in order."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    if ms is not None:
        ms = np.ascontiguousarray(ms, dtype=np.int64)
    perm = np.ascontiguousarray(perm)
    n = len(perm)
    if (perm.dtype != np.int32 or perm.ndim != 1 or y.shape != x.shape
            or (ms is not None and ms.shape != x.shape)):
        raise ValueError("perm must be 1-d int32, x, y (and ms) of one "
                         "length")
    if n and (int(perm.min()) < 0 or int(perm.max()) >= len(x)):
        raise ValueError("perm holds a row outside the columns")
    xo = np.empty(n, dtype=np.float64)
    yo = np.empty(n, dtype=np.float64)
    mo = None if ms is None else np.empty(n, dtype=np.int64)
    rc = native.library().geomesa_gather_xyz(
        native.ptr(x, native.F64P), native.ptr(y, native.F64P),
        native.ptr(ms, native.I64P), native.ptr(perm, native.I32P), n,
        native.ptr(xo, native.F64P), native.ptr(yo, native.F64P),
        native.ptr(mo, native.I64P))
    _raise_rc(rc, "geomesa_gather_xyz")
    return xo, yo, mo


def gather_xyz_plain(x, y, ms, perm):
    """``gather_xyz`` in numpy (three fancy-index gathers)."""
    return (np.asarray(x, np.float64)[perm], np.asarray(y, np.float64)[perm],
            None if ms is None else np.asarray(ms, np.int64)[perm])


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
    None for a time-less schema (z2 only). ``version`` is the layout:
    1 = the legacy z3 curve, 2 = the current one.
    """

    # exact-tier queries per curve before the sorted-order coordinate
    # copies are worth their full-table gathers: the first query answers
    # from a gather of its candidates, a repeat builds the copies
    _COORDS_AFTER = 1

    def __init__(self, x: np.ndarray, y: np.ndarray,
                 millis: np.ndarray | None,
                 period: TimePeriod | str = TimePeriod.WEEK,
                 version: int = 2):
        self._x = np.asarray(x, dtype=np.float64)
        self._y = np.asarray(y, dtype=np.float64)
        self._millis = (None if millis is None
                        else np.asarray(millis, dtype=np.int64))
        self.period = TimePeriod.parse(period)
        self.version = int(version)
        self.n = len(self._x)
        if self.n >= 2**31:
            raise ValueError("a single table holds fewer than 2^31 rows")
        self._z3 = None  # (ubins, seg_offsets, z_sorted, perm)
        self._z2 = None  # (z_sorted, perm)
        # the coordinates in each sort order: a query's candidate
        # positions are runs of the order, so its exact test reads them
        # in sequence instead of gathering from the insertion order
        self._z3_coords = None  # (xs, ys, ms)
        self._z2_coords = None  # (xs, ys, None)
        self._z3_uses = 0       # exact-tier queries served per curve
        self._z2_uses = 0

    # -- build -------------------------------------------------------------

    def _sfc3(self):
        """The z3 curve of this index's layout version."""
        if self.version == 1:
            return legacy_z3sfc(self.period)
        return z3sfc(self.period)

    def _keys3(self, x, y, millis):
        """(bins, z) of rows under this index's z3 curve."""
        if self.version != 1:
            return encode_binned_z3(x, y, millis, self.period)
        # the fused native encode implements only the current curve
        bins, offs = timebin.to_binned(millis, self.period, lenient=True)
        z = self._sfc3().index(x, y, offs.astype(np.float64),
                               lenient=True).astype(np.int64)
        return bins, z

    def _build_z3(self):
        if self._z3 is not None or self._millis is None:
            return self._z3
        bins, z = self._keys3(self._x, self._y, self._millis)
        z_sorted, perm, ubins, seg_offsets = sort_bin_z(bins, z)
        self._z3 = (ubins, seg_offsets, z_sorted, perm)
        return self._z3

    def _build_z2(self):
        if self._z2 is None:
            z = z2sfc().index(self._x, self._y,
                              lenient=True).astype(np.int64)
            self._z2 = sort_z(z)
        return self._z2

    def _coords(self, use_z3: bool, perm: np.ndarray):
        """The sorted-order coordinate copies of a curve once it has
        served _COORDS_AFTER exact queries, else None."""
        if use_z3:
            self._z3_uses += 1
            if self._z3_coords is None and self._z3_uses > self._COORDS_AFTER:
                self._z3_coords = gather_xyz(self._x, self._y, self._millis,
                                             perm)
            return self._z3_coords
        self._z2_uses += 1
        if self._z2_coords is None and self._z2_uses > self._COORDS_AFTER:
            self._z2_coords = gather_xyz(self._x, self._y, None, perm)
        return self._z2_coords

    def with_version(self, version: int) -> "ZKeyIndex":
        """New index over the same rows at layout ``version``, its z3
        order built under that version's curve; the z2 order and its
        coordinate copies carry over (the z2 curve has one version)."""
        out = ZKeyIndex(self._x, self._y, self._millis, self.period,
                        version=version)
        out._z2, out._z2_coords = self._z2, self._z2_coords
        out._build_z3()
        return out

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """The built sort orders as plain arrays, for persistence beside
        the rows (the file store's index sidecars); empty when none is
        built. The keys and dtypes are the JAX package's, so a state
        written by either package loads in the other. The coordinate
        copies are gathers, rebuilt on demand."""
        out: dict = {}
        if self._z3 is not None:
            ubins, seg_offsets, z_sorted, perm = self._z3
            out.update(z3_ubins=ubins, z3_seg_offsets=seg_offsets,
                       z3_zsorted=z_sorted, z3_perm=perm)
        if self._z2 is not None:
            z_sorted, perm = self._z2
            out.update(z2_zsorted=z_sorted, z2_perm=perm)
        if out:
            out["index_version"] = np.array([self.version], dtype=np.int64)
        return out

    def load_state(self, state: dict) -> bool:
        """Install persisted sort orders (possibly memory-mapped).
        Returns False, installing nothing, when the arrays do not cover
        this table's rows (a stale state after writes) or were built
        under another index version (a reindexed table must not adopt
        its old orders)."""
        if int(np.asarray(state.get("index_version", [2]))[0]) != self.version:
            return False
        ok = False
        if "z3_zsorted" in state and self._millis is not None:
            z_sorted, perm = state["z3_zsorted"], state["z3_perm"]
            if len(z_sorted) == self.n and len(perm) == self.n:
                self._z3 = (state["z3_ubins"], state["z3_seg_offsets"],
                            z_sorted, perm)
                self._z3_coords = None
                ok = True
        if "z2_zsorted" in state:
            z_sorted, perm = state["z2_zsorted"], state["z2_perm"]
            if len(z_sorted) == self.n and len(perm) == self.n:
                self._z2 = (z_sorted, perm)
                self._z2_coords = None
                ok = True
        return ok

    # -- incremental maintenance -------------------------------------------

    def extend(self, x: np.ndarray, y: np.ndarray,
               millis: np.ndarray | None) -> "ZKeyIndex":
        """New index covering the existing rows plus appended rows, with
        already-built sort orders (and coordinate copies) MERGED (O(N)
        memcpy + O(D log D) delta sort) instead of re-sorted from
        scratch."""
        if (self._millis is None) != (millis is None):
            raise ValueError("time column presence must match")
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        out = ZKeyIndex(
            np.concatenate([self._x, x]), np.concatenate([self._y, y]),
            None if millis is None else np.concatenate(
                [self._millis, np.asarray(millis, dtype=np.int64)]),
            self.period, self.version)
        out._z3_uses, out._z2_uses = self._z3_uses, self._z2_uses
        if self._z3 is not None:
            out._z3, out._z3_coords = self._merged_z3(x, y, millis)
        if self._z2 is not None:
            out._z2, out._z2_coords = self._merged_z2(x, y)
        return out

    @staticmethod
    def _merged_coords(coords, pos, dorder, x, y, millis):
        if coords is None:
            return None
        xs, ys, ms = coords
        return (np.insert(xs, pos, x[dorder]), np.insert(ys, pos, y[dorder]),
                None if ms is None else np.insert(ms, pos, millis[dorder]))

    def _merged_z2(self, x, y):
        z_sorted, perm = self._z2
        dz = z2sfc().index(x, y, lenient=True).astype(np.int64)
        dorder = np.argsort(dz, kind="stable")
        dzs = dz[dorder]
        # side="right": appended rows land after equal existing keys,
        # preserving stable insertion order
        pos = np.searchsorted(z_sorted, dzs, side="right")
        return ((np.insert(z_sorted, pos, dzs),
                 np.insert(perm, pos, (dorder + self.n).astype(perm.dtype))),
                self._merged_coords(self._z2_coords, pos, dorder, x, y, None))

    def _merged_z3(self, x, y, millis):
        ubins, seg_offsets, z_sorted, perm = self._z3
        millis = np.asarray(millis, dtype=np.int64)
        dbins, dz = self._keys3(x, y, millis)
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
        return ((new_bins[seg_starts], np.append(seg_starts, len(new_bins)),
                 np.insert(z_sorted, pos, dzs),
                 np.insert(perm, pos, (dorder + self.n).astype(perm.dtype))),
                self._merged_coords(self._z3_coords, pos, dorder, x, y,
                                    millis))

    # -- search ------------------------------------------------------------

    @staticmethod
    def _keep(x, y, ms, boxes, intervals_ms) -> np.ndarray:
        """Exact f64 evaluation; identical semantics to zscan.exact_patch
        (inclusive box bounds, inclusive [lo, hi] millis intervals)."""
        keep = np.zeros(len(x), dtype=bool)
        for xmin, ymin, xmax, ymax in boxes:
            keep |= ((x >= xmin) & (x <= xmax)
                     & (y >= ymin) & (y <= ymax))
        if intervals_ms:
            tk = np.zeros(len(x), dtype=bool)
            for lo, hi in intervals_ms:
                tk |= (ms >= lo) & (ms <= hi)
            keep &= tk
        return keep

    @staticmethod
    def _eval_sorted(xs, ys, ms, pos, boxes, intervals_ms) -> np.ndarray:
        """``_keep`` over the rows ``pos`` of (xs, ys, ms), no time test
        without ms (the reference's ZKeyIndex._eval_sorted; the mesh
        store's gathered tier). Returns the keep mask over pos."""
        if ms is None:
            return ZKeyIndex._keep(xs[pos], ys[pos], None, boxes, [])
        return ZKeyIndex._keep(xs[pos], ys[pos], ms[pos], boxes,
                               intervals_ms)

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
            sfc = self._sfc3()
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
        coords = self._coords(use_z3, perm)
        if coords is not None:
            x, y = coords[0][pos], coords[1][pos]
            ms = coords[2][pos] if use_z3 else None
        else:
            x, y = self._x[rows], self._y[rows]
            ms = self._millis[rows] if use_z3 else None
        keep = self._keep(x, y, ms, boxes, intervals_ms if use_z3 else [])
        return "exact", np.sort(rows[keep]).astype(np.int64)
