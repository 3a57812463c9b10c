"""Fused spatio-temporal scan over device tensors (the TPU package's
scan/zscan.py, in PyTorch).

- coordinates live on the device as *round-down two-float* pairs
  (hi = float32 rounded toward -inf, lo = float32(x - hi) in [0, ulp)),
  so box comparisons against bounds split the same way are exact in
  float64 terms up to a ~1e-12 deg residual; points sharing a hi cell
  with a query bound are re-checked on the host in float64
  (``boundary_candidates`` / ``exact_patch``), making the final result
  EXACTLY the double-precision one;
- times live as (days-since-epoch int32, millis-in-day int32) pairs.

The column split stays numpy on the host; ``ScanData`` holds the six
columns as tensors on one device with power-of-two capacity, beside a
row-major copy of the same words for the gathered tier, and appends
copy into that capacity in place. The predicate itself runs in the
hand kernels of ``kernels.py`` (their plain versions on the CPU); a
batch of queries runs in one pass of the batched kernels
(``stack_queries`` + ``batch_hit_rows``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels

__all__ = ["MAX_ROWS", "MILLIS_PER_DAY", "BatchedScanQuery", "ScanData",
           "ScanQuery", "batch_hit_rows", "boundary_candidates",
           "build_scan_data", "exact_patch", "extend_scan_data", "make_query",
           "next_pow2", "pack_rows", "patch_hit_rows", "scan_count",
           "scan_data_from_numpy", "scan_mask", "scan_mask_at",
           "scan_mask_batch", "split_two_float", "stack_points",
           "stack_queries"]

MILLIS_PER_DAY = 86_400_000

# row ids are int32 on the device (the z-index's permutation and the
# gathered kernel's ids), as the reference caps a table's rows
MAX_ROWS = 2**31 - 1


def split_two_float(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 -> (hi, lo) f32 pair with hi = round-toward-neg-inf(x) and
    lo = f32(x - hi) >= 0. Lexicographic (hi, lo) compare then mirrors
    the f64 order to within f32-rounding of the residual."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    over = hi.astype(np.float64) > x
    hi = np.where(over, np.nextafter(hi, np.float32(-np.inf)), hi)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _split_time(millis) -> tuple[np.ndarray, np.ndarray]:
    millis = np.asarray(millis, dtype=np.int64)
    tday = (millis // MILLIS_PER_DAY).astype(np.int32)
    tms = (millis - tday.astype(np.int64) * MILLIS_PER_DAY).astype(np.int32)
    return tday, tms


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class ScanData:
    """Device columns for the scan: ``cap`` rows allocated, the first
    ``n`` valid. Rows >= n are never matches.

    ``rows`` is the gathered tier's copy of the same words, row-major: a
    (cap, 8) int32 table [xhi, xlo, yhi, ylo, tday, tms, 0, 0] with the
    floats as their bit patterns, so a random candidate row is one
    32-byte sector instead of six. The dense kernels keep reading the
    columns, which cost them 24 B/row (16 B without time) against the
    table's 32. Build it with ``pack_rows``."""
    xhi: torch.Tensor
    xlo: torch.Tensor
    yhi: torch.Tensor
    ylo: torch.Tensor
    tday: torch.Tensor
    tms: torch.Tensor
    rows: torch.Tensor
    n: int

    def __post_init__(self):
        if self.cap > MAX_ROWS:
            raise ValueError(f"a capacity of {self.cap} rows: row ids are "
                             f"int32, so a table holds at most {MAX_ROWS}")
        if tuple(self.rows.shape) != (self.cap, 8):
            raise ValueError("rows must be the (cap, 8) gather table")

    @property
    def cap(self) -> int:
        return int(self.xhi.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xhi.device

    @property
    def cols(self) -> tuple[torch.Tensor, ...]:
        return (self.xhi, self.xlo, self.yhi, self.ylo, self.tday, self.tms)

    @property
    def nbytes(self) -> int:
        """Device bytes: 24 B/row of columns + 32 B/row of the table."""
        return self.cap * (4 * 4 + 2 * 4 + 8 * 4)


def pack_rows(cols, n: int | None = None, rows=None,
              lo: int = 0) -> torch.Tensor:
    """Write rows ``lo`` .. ``n`` of the (cap, 8) int32 gather table from
    the columns' words, on the columns' device (a strided copy per
    column, no host traffic). ``rows=None`` allocates a zeroed table;
    ``n=None`` means every row of the columns."""
    cap = cols[0].shape[0]
    n = cap if n is None else n
    if rows is None:
        rows = torch.zeros((cap, 8), dtype=torch.int32,
                           device=cols[0].device)
    for j, c in enumerate(cols):
        rows[lo:n, j].copy_(c[lo:n].view(torch.int32))
    return rows


def scan_data_from_numpy(xhi, xlo, yhi, ylo, tday, tms, n: int,
                         device) -> ScanData:
    """ScanData from host column arrays (e.g. another implementation's
    device columns fetched as numpy), copied to ``device`` as they are,
    capacity padding included."""
    def put(a, dt):
        return torch.from_numpy(np.require(a, dt, ["C", "W"])).to(device)
    f, i = np.float32, np.int32
    cols = (put(xhi, f), put(xlo, f), put(yhi, f), put(ylo, f),
            put(tday, i), put(tms, i))
    if not 0 <= n <= len(cols[0]) or any(
            len(c) != len(cols[0]) for c in cols):
        raise ValueError("columns must share one length >= n")
    return ScanData(*cols, pack_rows(cols), int(n))


def build_scan_data(x: np.ndarray, y: np.ndarray, millis: np.ndarray,
                    device, cap: int | None = None,
                    xy_split=None) -> ScanData:
    """Host f64 coords + epoch millis -> device columns, zero-padded to
    ``cap`` rows when given. ``xy_split`` passes precomputed
    (xhi, xlo, yhi, ylo) pairs so a caller that also needs host copies
    splits once."""
    if xy_split is not None:
        xhi, xlo, yhi, ylo = xy_split
    else:
        xhi, xlo = split_two_float(x)
        yhi, ylo = split_two_float(y)
    tday, tms = _split_time(millis)
    n = len(xhi)
    cap = n if cap is None else cap
    if cap < n:
        raise ValueError(f"cap={cap} < n={n}")
    if cap > MAX_ROWS:
        raise ValueError(f"cap={cap} above {MAX_ROWS} rows")
    cols = []
    for a in (xhi, xlo, yhi, ylo, tday, tms):
        t = torch.zeros(cap, dtype=torch.from_numpy(a[:0]).dtype,
                        device=device)
        t[:n].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        cols.append(t)
    return ScanData(*cols, pack_rows(cols, n), n)


def extend_scan_data(data: ScanData, x, y, millis,
                     xy_split=None) -> ScanData | None:
    """Append rows IN PLACE within the existing capacity (a slice
    ``copy_`` into each column, then the same rows of the gather table
    from the columns on the device), or None when the capacity is
    exhausted (the caller rebuilds with fresh headroom). The returned
    ScanData shares the tensors of ``data``."""
    d = len(x)
    if d == 0:
        return data
    if data.n + d > data.cap:
        return None
    if xy_split is None:
        xhi, xlo = split_two_float(x)
        yhi, ylo = split_two_float(y)
    else:
        xhi, xlo, yhi, ylo = xy_split
    tday, tms = _split_time(millis)
    for col, a in zip(data.cols, (xhi, xlo, yhi, ylo, tday, tms)):
        col[data.n:data.n + d].copy_(torch.from_numpy(np.ascontiguousarray(a)))
    pack_rows(data.cols, data.n + d, data.rows, lo=data.n)
    return dataclasses.replace(data, n=data.n + d)


class ScanQuery:
    """Padded query: K spatial boxes + B time intervals, as the kernels'
    tables.

    boxes: (K, 8) f32 [xmin_hi, xmin_lo, xmax_hi, xmax_lo,
                       ymin_hi, ymin_lo, ymax_hi, ymax_lo]
    times: (B, 4) i32 [day_lo, ms_lo, day_hi, ms_hi], inclusive bounds

    K and B are powers of two; the unused slots hold impossible bounds
    (a box with xmin_hi=+inf and xmax_hi=-inf, an interval with
    day_lo=INT32_MAX and day_hi=INT32_MIN) so no row matches them and
    the kernels need no validity masks. ``time_any``: no time
    constraint at all. ``host_*`` fields are the exact f64/i64
    originals for the boundary recheck. The tables move to a device on
    first use there.
    """

    def __init__(self, boxes: np.ndarray, times: np.ndarray,
                 time_any: bool, n_boxes: int, host_boxes: np.ndarray,
                 host_box_his: np.ndarray, host_intervals: np.ndarray):
        self.boxes_np = boxes
        self.times_np = times
        self.time_any = time_any
        self.n_boxes = n_boxes
        self.host_boxes = host_boxes
        self.host_box_his = host_box_his
        self.host_intervals = host_intervals
        self._tables: dict = {}

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(boxes, times) tensors on ``device``, uploaded once."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = (torch.from_numpy(self.boxes_np).to(device),
                                 torch.from_numpy(self.times_np).to(device))
        return self._tables[key]


def make_query(boxes_f64, intervals_ms) -> ScanQuery:
    """Build a padded ScanQuery.

    boxes_f64: list of (xmin, ymin, xmax, ymax) float64 tuples.
    intervals_ms: list of (lo_millis, hi_millis) INCLUSIVE int bounds,
      or None/[] for no time constraint.
    """
    boxes_f64 = list(boxes_f64)
    k = next_pow2(max(len(boxes_f64), 1))
    boxes = np.zeros((k, 8), dtype=np.float32)
    boxes[:, 0] = np.inf     # unused slot: xmin_hi = +inf -> never >= it
    boxes[:, 2] = -np.inf    #              xmax_hi = -inf -> never <= it
    host_boxes = np.zeros((len(boxes_f64), 4), dtype=np.float64)
    host_his = np.zeros((len(boxes_f64), 4), dtype=np.float32)
    for i, (xmin, ymin, xmax, ymax) in enumerate(boxes_f64):
        xmin_hi, xmin_lo = split_two_float(np.float64(xmin))
        xmax_hi, xmax_lo = split_two_float(np.float64(xmax))
        ymin_hi, ymin_lo = split_two_float(np.float64(ymin))
        ymax_hi, ymax_lo = split_two_float(np.float64(ymax))
        boxes[i] = (xmin_hi, xmin_lo, xmax_hi, xmax_lo,
                    ymin_hi, ymin_lo, ymax_hi, ymax_lo)
        host_boxes[i] = (xmin, ymin, xmax, ymax)
        host_his[i] = (xmin_hi, xmax_hi, ymin_hi, ymax_hi)

    intervals_ms = list(intervals_ms or [])
    b = next_pow2(max(len(intervals_ms), 1))
    times = np.zeros((b, 4), dtype=np.int32)
    times[:, 0] = np.iinfo(np.int32).max   # unused slot: never after day_lo
    times[:, 2] = np.iinfo(np.int32).min   #              never before day_hi
    for i, (lo, hi) in enumerate(intervals_ms):
        lo, hi = int(lo), int(hi)
        times[i] = (lo // MILLIS_PER_DAY, lo % MILLIS_PER_DAY,
                    hi // MILLIS_PER_DAY, hi % MILLIS_PER_DAY)

    host_iv = np.asarray(intervals_ms, dtype=np.int64).reshape(-1, 2)
    return ScanQuery(boxes, times, not intervals_ms, len(boxes_f64),
                     host_boxes, host_his, host_iv)


# -- the scans ---------------------------------------------------------------

def scan_mask(data: ScanData, q: ScanQuery) -> torch.Tensor:
    """Dense tier: bool[cap] mask on the data's device whose
    capacity-padding tail (rows >= data.n) is always False."""
    boxes, times = q.tables(data.device)
    return kernels.scan_mask(data.cols, data.n, boxes, times, q.time_any)


def scan_mask_at(data: ScanData, q: ScanQuery,
                 rows: np.ndarray) -> np.ndarray:
    """Gathered tier: the scan over just ``rows`` (original-order row
    indices; the z-key index hands them as int32, which go to the device
    as they are) through the gather table; returns a host
    bool[len(rows)]."""
    rows = np.asarray(rows)
    if len(rows) == 0:
        return np.zeros(0, dtype=bool)
    if rows.min() < 0 or rows.max() >= data.n:
        raise IndexError(f"row ids outside [0, {data.n})")
    boxes, times = q.tables(data.device)
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32))
    out = kernels.scan_mask_gather(data.rows, idx.to(data.device), boxes,
                                   times, q.time_any)
    return out.cpu().numpy()


def scan_count(data: ScanData, q: ScanQuery) -> int:
    """The kernel's hit count over the first n rows: the mask never
    leaves the device. Callers wanting the exact f64 count still apply
    the boundary adjustment."""
    boxes, times = q.tables(data.device)
    return int(kernels.scan_count(data.cols, data.n, boxes, times,
                                  q.time_any).item())


# -- micro-batched multi-query scan -------------------------------------------
#
# N concurrent queries become ONE pass of the batched kernels: each
# query's padded boxes/intervals are stacked along a leading batch dim
# of exactly N. Per-query time_any may differ within a batch, so a
# time-free query gets the reference's CATCH-ALL interval (all
# representable days) and the batched kernel always runs the temporal
# compare.

_CATCH_ALL_INTERVAL = (-(2 ** 30), 0, 2 ** 30, MILLIS_PER_DAY)
# an unused box slot of a stacked table holds NaN in every bound, so
# neither the predicate nor the boundary-candidate test (hi == bound)
# matches any row; an unused interval slot is never after its day_lo
# nor before its day_hi
_NO_BOX = np.full(8, np.nan, dtype=np.float32)
_NO_INTERVAL = (np.iinfo(np.int32).max, 0, np.iinfo(np.int32).min, 0)


class BatchedScanQuery:
    """Stacked queries padded to common box/interval counts, as the
    batched kernels' tables.

    boxes: (Q, K, 8) f32; times: (Q, B, 4) i32; counts: (Q, 2) i32, each
    query's own boxes and intervals (a time-free query's catch-all
    interval counts as one), the slots the bitmap kernel evaluates

    ``queries`` keeps the original ScanQuery objects (exact f64 bounds
    for the per-query boundary patch). The tables move to a device on
    first use there."""

    def __init__(self, boxes: np.ndarray, times: np.ndarray,
                 counts: np.ndarray, queries: list[ScanQuery]):
        self.boxes_np = boxes
        self.times_np = times
        self.counts_np = counts
        self.queries = list(queries)
        self._tables: dict = {}

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    def _upload(self, device):
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.boxes_np, self.times_np, self.counts_np))
        return self._tables[key]

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(boxes, times) tensors on ``device``, uploaded once."""
        return self._upload(device)[:2]

    def counts(self, device) -> torch.Tensor:
        """The (Q, 2) counts on ``device``, uploaded with the tables."""
        return self._upload(device)[2]


def stack_queries(queries: list[ScanQuery]) -> BatchedScanQuery:
    """Stack padded ScanQueries into one BatchedScanQuery.

    Box/interval dims are padded to the max across the batch. Only each
    query's used slots are copied, and counted; every other slot matches
    nothing."""
    if not queries:
        raise ValueError("stack_queries needs at least one query")
    k = max(q.boxes_np.shape[0] for q in queries)
    b = max(q.times_np.shape[0] for q in queries)
    boxes = np.empty((len(queries), k, 8), dtype=np.float32)
    boxes[:] = _NO_BOX
    times = np.empty((len(queries), b, 4), dtype=np.int32)
    times[:] = _NO_INTERVAL
    counts = np.empty((len(queries), 2), dtype=np.int32)
    for i, q in enumerate(queries):
        boxes[i, :q.n_boxes] = q.boxes_np[:q.n_boxes]
        if q.time_any:
            times[i, 0] = _CATCH_ALL_INTERVAL
            m = 1
        else:
            m = len(q.host_intervals)
            times[i, :m] = q.times_np[:m]
        counts[i] = (q.n_boxes, m)
    return BatchedScanQuery(boxes, times, counts, queries)


def scan_mask_batch(data: ScanData, bq: BatchedScanQuery) -> torch.Tensor:
    """One pass of the batched kernel over all queries: bool[Q, cap]
    on the data's device, False on rows >= data.n."""
    boxes, times = bq.tables(data.device)
    bits, _ = kernels.scan_batch_bits(data.cols, data.n, boxes, times,
                                      bq.counts(data.device))
    q = bq.n_queries
    return kernels.unpack_bits(bits[0].reshape(-1)).view(q, -1)[:, :data.cap]


def batch_hit_rows(data: ScanData, bq: BatchedScanQuery
                   ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The batched scan + compaction on the device: per query (ascending
    int32 hit rows, boundary-candidate rows), on the host.

    The bitmap kernel finds both sets in one pass; the compaction copies
    the per-query counts (2*Q ints) to the host, its one sync, and writes
    every query's ids into one buffer per kind, so the host receives
    O(hits) and runs no O(n) candidate pass."""
    boxes, times = bq.tables(data.device)
    bits, partials = kernels.scan_batch_bits(data.cols, data.n, boxes, times,
                                             bq.counts(data.device))
    hit_ids, cand_ids, counts = kernels.compact_bits(bits, partials)
    return tuple(np.split(ids.cpu().numpy(), np.cumsum(cnt)[:-1])
                 for ids, cnt in ((hit_ids, counts[0]),
                                  (cand_ids, counts[1])))


def stack_points(qx, qy, min_batch: int = 1
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """Stack query POINTS into one pow2-padded f32 batch, the point-query
    analog of ``stack_queries`` (multi-query KNN). Returns ``(qx_pad,
    qy_pad, nq)``: the batch dim is the next power of two >= max(nq,
    min_batch), and padding rows repeat the first query, so they are
    valid coordinates (callers slice results back to ``nq``)."""
    qx = np.atleast_1d(np.asarray(qx, np.float64))
    qy = np.atleast_1d(np.asarray(qy, np.float64))
    if qx.shape != qy.shape or qx.ndim != 1:
        raise ValueError("stack_points needs matching 1-d coordinates")
    nq = len(qx)
    if nq == 0:
        raise ValueError("stack_points needs at least one query point")
    qp = max(next_pow2(nq), max(min_batch, 1))
    qxp = np.full(qp, qx[0], dtype=np.float32)
    qyp = np.full(qp, qy[0], dtype=np.float32)
    qxp[:nq] = qx.astype(np.float32)
    qyp[:nq] = qy.astype(np.float32)
    return qxp, qyp, nq


# -- exact f64 boundary patch (host) -----------------------------------------

def boundary_candidates(data_xhi: np.ndarray, data_yhi: np.ndarray,
                        q: ScanQuery) -> np.ndarray:
    """Indices of points whose hi-cell equals any query bound's hi-cell
    — the only points where the two-float compare can differ from exact
    f64. Typically a vanishing fraction of n (~n * 2^-23)."""
    mask = np.zeros(len(data_xhi), dtype=bool)
    for i in range(q.n_boxes):
        his = q.host_box_his[i]
        mask |= (data_xhi == his[0]) | (data_xhi == his[1])
        mask |= (data_yhi == his[2]) | (data_yhi == his[3])
    return np.flatnonzero(mask)


def _exact_hits(cand_idx: np.ndarray, x: np.ndarray, y: np.ndarray,
                millis: np.ndarray, q: ScanQuery) -> np.ndarray:
    """Exact f64/i64 verdict for each candidate row index."""
    cx, cy = x[cand_idx], y[cand_idx]
    ok = np.zeros(len(cand_idx), dtype=bool)
    for i in range(q.n_boxes):
        xmin, ymin, xmax, ymax = q.host_boxes[i]
        ok |= (cx >= xmin) & (cx <= xmax) & (cy >= ymin) & (cy <= ymax)
    if not q.time_any:
        cm = millis[cand_idx]
        t_ok = np.zeros(len(cand_idx), dtype=bool)
        for lo, hi in q.host_intervals:
            t_ok |= (cm >= lo) & (cm <= hi)
        ok &= t_ok
    return ok


def exact_patch(mask: np.ndarray, cand_idx: np.ndarray,
                x: np.ndarray, y: np.ndarray, millis: np.ndarray,
                q: ScanQuery) -> np.ndarray:
    """Re-evaluate boundary candidates in exact f64/i64 semantics and
    patch their mask bits, making the overall result exact."""
    if len(cand_idx) == 0:
        return mask
    mask = mask.copy()
    mask[cand_idx] = _exact_hits(cand_idx, x, y, millis, q)
    return mask


def patch_hit_rows(rows: np.ndarray, q: ScanQuery,
                   x: np.ndarray, y: np.ndarray, millis: np.ndarray,
                   cand: np.ndarray) -> np.ndarray:
    """The boundary patch in row-index space: add/remove the candidates
    ``cand`` from the sorted hit ``rows`` by their exact f64/i64
    verdict."""
    if len(cand) == 0:
        return rows
    ok = _exact_hits(cand, x, y, millis, q)
    if (~ok).any():
        rows = np.setdiff1d(rows, cand[~ok])
    if ok.any():
        rows = np.union1d(rows, cand[ok])
    return rows
