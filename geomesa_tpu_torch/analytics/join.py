"""Spatial joins on the device: the ST_DWithin / ST_Contains joins and
KNN (the JAX package's analytics/join.py).

The reference runs spatial joins via Spark: spatially-partitioned RDDs
and a per-cell sweepline (GeoMesaSparkSQL.scala:312-360, SQLRules
SpatialJoinStrategy:270). Here the large side is one f32 table on the
card and the small side (query points, polygons) is handed to the hand
kernels of ``scan/kernels.py`` (``csrc/join.cu``) in one call:

- ``dwithin_counts``: each query's f32 distances against the radius's
  error band over the tiles of the x-sorted table that its slab meets,
  reduced to counts on the device;
- ``slab_pairs``: the candidate pairs within each query's x-slab of the
  x-sorted table (a device sort kept per resident table), compacted on
  the device, so only O(candidates) ids reach the host;
- ``contains_counts``: per polygon its slab, the box test, the f32
  crossing number and the EDGE_EPS band;
- ``knn_topk``: each query's kpad smallest squared distances.

Pairs within the f32 error band of the threshold are re-checked on the
host in f64, so every result is exact.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..scan import kernels
from ..scan.gscan import EDGE_EPS, EDGE_EPS2
from ..scan.zscan import next_pow2, stack_points
from ..utils.device import resolve_device
from ..utils.fp import f32_band as _f32_band

__all__ = ["dwithin_join", "contains_join", "knn", "knn_batched",
           "pack_polygon_batch", "prewarm_join_kernels", "psum_counts"]


def psum_counts(leg_counts) -> int:
    """psum-style reduce of per-shard join match counts: the z-prefix
    partition of the scattered side is disjoint and covering, so the
    cluster-wide broadcast-join count is exactly the sum of leg
    counts."""
    return int(sum(int(c) for c in leg_counts))


# (xs, ys, order): the rows sorted by x, padded rows at +inf (y NaN)
_sorted_by_x = kernels.sorted_by_x


# the x-sorted tables of resident columns, most recent last, keyed on
# the columns' identities: a store's columns re-resolve slabs across many
# join calls, and the sort is the largest per-call cost. An entry holds
# its columns by weak reference and leaves when either dies (the store's
# remove_schema, delete or rebuild past capacity drops them), so no sort
# of a dropped table stays on the card; the bound keeps the rest to a
# few tables. The store appends to its columns in place, so an entry
# also holds the columns' version counters and the row count, and a miss
# on them replaces the entry.
_XSORT_CACHE: OrderedDict = OrderedDict()
_XSORT_ENTRIES = 4
_XSORT_LOCK = threading.Lock()   # joins may run from several threads


def _sorted_by_x_cached(pxj, pyj, nrows: int, cacheable: bool):
    """``cacheable`` is True only for caller-owned resident columns: a
    per-call upload is a new tensor every time, so caching it could
    never hit."""
    ident = (id(pxj), id(pyj))
    version = (pxj._version, pyj._version, nrows)
    with _XSORT_LOCK:
        entry = _XSORT_CACHE.get(ident)
        if (entry is not None and entry[0]() is pxj and entry[1]() is pyj
                and entry[2] == version):
            _XSORT_CACHE.move_to_end(ident)
            return entry[3]
    tables = _sorted_by_x(pxj, pyj, nrows)
    if cacheable:
        # a weakref callback may run inside the lock (a collection), so
        # it takes none: OrderedDict.pop is one atomic call
        def drop(_ref, ident=ident):
            _XSORT_CACHE.pop(ident, None)
        entry = (weakref.ref(pxj, drop), weakref.ref(pyj, drop), version,
                 tables)
        with _XSORT_LOCK:
            _XSORT_CACHE[ident] = entry
            _XSORT_CACHE.move_to_end(ident)
            while len(_XSORT_CACHE) > _XSORT_ENTRIES:
                _XSORT_CACHE.popitem(last=False)
    return tables


def clear_xsort_cache():
    """Drop every cached x-sort (and the columns it keeps alive)."""
    with _XSORT_LOCK:
        _XSORT_CACHE.clear()


def _slab_bounds(xs, qb, w):
    """(los, widths) int32 on the device, and both on the host: each
    query's slab [searchsorted(qb - w, left), searchsorted(qb + w,
    right)) of xs, with qb and w f32 (so each edge rounds in f32)."""
    qb = torch.as_tensor(np.asarray(qb, np.float32), device=xs.device)
    w = torch.as_tensor(np.asarray(w, np.float32), device=xs.device)
    los = torch.searchsorted(xs, qb - w, side="left")
    his = torch.searchsorted(xs, qb + w, side="right")
    los_t, w_t = los.to(torch.int32), (his - los).to(torch.int32)
    return los_t, w_t, los_t.cpu().numpy(), w_t.cpu().numpy()


class _Slabs(NamedTuple):
    """The x-sorted table and each query's slab of it, on the device
    (``los``, ``widths``) and the widths on the host."""
    xs: torch.Tensor
    ys: torch.Tensor
    order: torch.Tensor
    los: torch.Tensor
    widths: torch.Tensor
    widths_host: np.ndarray


def _slab_setup(tables, q_x64, radius_deg, r2_hi) -> _Slabs:
    """The shared slab setup of the banded count resolution and the
    pairs path over the x-sorted ``tables`` (xs, ys, order): slab
    half-width = radius + f32 rounding + band, the batched
    searchsorted."""
    xs, ys, order = tables
    eps = float(np.sqrt(max(r2_hi, 0.0))) - radius_deg + 1e-4
    w = radius_deg + eps
    los, widths, _, w_h = _slab_bounds(xs, q_x64.astype(np.float32),
                                       np.float32(w))
    return _Slabs(xs, ys, order, los, widths, w_h)


def _slab_pairs_exact(slabs: _Slabs, qx64, qy64, px64, py64, radius_deg,
                      r2_hi):
    """(rows, query) int64 pairs with f64 d2 <= r^2, query-major and in
    slab order: the device's in-band candidates (f32 d2 <= r2_hi, a
    superset of the exact pairs), then the exact check on the host."""
    qa = torch.from_numpy(np.stack([qx64, qy64], axis=1).astype(np.float32))
    rows, qi = kernels.slab_pairs(slabs.xs, slabs.ys, slabs.order, slabs.los,
                                  slabs.widths, qa.to(slabs.xs.device),
                                  float(np.float32(r2_hi)), 0.0, box=False)
    rows = rows.cpu().numpy().astype(np.int64)
    qi = qi.cpu().numpy().astype(np.int64)
    exact = ((px64[rows] - qx64[qi]) ** 2
             + (py64[rows] - qy64[qi]) ** 2) <= radius_deg * radius_deg
    return rows[exact], qi[exact]


def _resolve_band_counts(tables, px64, py64, qx64, qy64, banded,
                         radius_deg, r2_hi, counts):
    """Exact f64 counts of the queries with in-band pairs, from their
    x-slab candidates |x - qx| <= r + eps: the device x-sort's
    ``tables``, a batched searchsorted, the slab kernel's in-band rows,
    then the f64 distance on the host. No O(n) host work and no (k, n)
    band matrix."""
    slabs = _slab_setup(tables, qx64[banded], radius_deg, r2_hi)
    if not len(slabs.widths_host) or slabs.widths_host.max() == 0:
        return
    _, qi = _slab_pairs_exact(slabs, qx64[banded], qy64[banded], px64, py64,
                              radius_deg, r2_hi)
    counts[banded] = np.bincount(qi, minlength=len(banded))


def _as_device_f32(px64, py64, device_xy, device):
    """The join's large side on the device: the caller's resident f32
    columns (a store's scan_data.xhi/yhi, which may be capacity-padded
    past n), or one upload to ``device`` (None: CUDA)."""
    if device_xy is not None:
        pxj, pyj = device_xy
        return pxj, pyj
    dev = resolve_device(device)
    return (torch.from_numpy(px64.astype(np.float32)).to(dev),
            torch.from_numpy(py64.astype(np.float32)).to(dev))


def dwithin_join(px: np.ndarray, py: np.ndarray,
                 qx: np.ndarray, qy: np.ndarray,
                 radius_deg: float, *, counts_only: bool = False,
                 device_xy=None, device=None):
    """Radius join: for each query point, the points within radius_deg
    (planar degrees, the rewritten-DWithin semantics).

    Returns (counts[k], pairs) where pairs is an (m, 2) int64 array of
    (point_idx, query_idx), query-major, or (counts, None) with
    counts_only.

    ``counts_only`` counts every pair on the device (the kernel walks
    the x-sorted table, each query over the tiles its slab meets, and
    groups the queries itself, so the reference's ``chunk`` tile has no
    counterpart here), with only the queries that have in-band pairs
    resolved exactly through their x-slabs. The pairs path runs on
    x-slab candidates: in-band pairs compact on the device and only they
    reach the host, where f64 filters the f32 band.

    ``device_xy`` passes resident f32 columns of the large side (possibly
    capacity-padded past len(px); padded rows never match); without it
    the coordinates upload to ``device`` (None: CUDA) per call.
    """
    px64 = np.asarray(px, np.float64)
    py64 = np.asarray(py, np.float64)
    qx64 = np.asarray(qx, np.float64)
    qy64 = np.asarray(qy, np.float64)
    pxj, pyj = _as_device_f32(px64, py64, device_xy, device)
    n, k = len(px64), len(qx64)
    r2_hi, r2_lo = _f32_band(radius_deg, 360.0)
    counts = np.zeros(k, dtype=np.int64)
    cacheable = device_xy is not None

    if counts_only:
        if n == 0 or k == 0:
            return counts, None
        dev = pxj.device
        qxj = torch.from_numpy(qx64.astype(np.float32)).to(dev)
        qyj = torch.from_numpy(qy64.astype(np.float32)).to(dev)
        tables = _sorted_by_x_cached(pxj, pyj, n, cacheable)
        def_counts, band_counts = kernels.dwithin_counts(
            pxj, pyj, qxj, qyj, float(np.float32(r2_hi)),
            float(np.float32(r2_lo)), n, tables[:2])
        counts[:] = def_counts.cpu().numpy()
        banded = np.flatnonzero(band_counts.cpu().numpy())
        if len(banded):
            _resolve_band_counts(tables, px64, py64, qx64, qy64, banded,
                                 radius_deg, r2_hi, counts)
        return counts, None

    if n == 0 or k == 0:
        return counts, np.empty((0, 2), dtype=np.int64)
    slabs = _slab_setup(_sorted_by_x_cached(pxj, pyj, n, cacheable), qx64,
                        radius_deg, r2_hi)
    if not len(slabs.widths_host) or slabs.widths_host.max() == 0:
        return counts, np.empty((0, 2), dtype=np.int64)
    rows, qi = _slab_pairs_exact(slabs, qx64, qy64, px64, py64, radius_deg,
                                 r2_hi)
    pairs = np.stack([rows, qi], axis=1).astype(np.int64)
    if len(pairs):
        counts[:] = np.bincount(pairs[:, 1], minlength=k)
    return counts, pairs


# -- ST_Contains join ------------------------------------------------------

def _poly_edges(poly) -> np.ndarray:
    """One polygon's or multipolygon's rings as an (e, 4) f64 segment
    list [x0 y0 x1 y1]. Holes are included: crossing-number parity
    handles them uniformly."""
    rings: list[np.ndarray] = []
    for p in getattr(poly, "parts", [poly]):
        rings.append(np.asarray(p.shell, np.float64))
        for h in getattr(p, "holes", []):
            rings.append(np.asarray(h, np.float64))
    segs = []
    for ring in rings:
        a = ring[:-1] if np.allclose(ring[0], ring[-1]) else ring
        b = np.roll(a, -1, axis=0)
        segs.append(np.concatenate([a, b], axis=1))
    return (np.concatenate(segs, axis=0) if segs
            else np.zeros((0, 4), np.float64))


def _poly_pad(k: int) -> int:
    """Polygon-batch shape class: pow2 up to 1024, then the next 1024
    multiple."""
    return next_pow2(k) if k <= 1024 else ((k + 1023) // 1024) * 1024


def pack_polygon_batch(polygons, pad_to: int | None = None):
    """Stack every polygon's edges into one batched layout: (kp, ne, 4)
    f32 edges + (kp, ne) valid + (kp, 4) f32 envelopes, pow2-padded on
    the edge dim and padded to ``pad_to`` polygons. Padding rows carry
    an inverted envelope and no edges: they match nothing."""
    k = len(polygons)
    kp = max(pad_to or k, k, 1)
    elist = [_poly_edges(p) for p in polygons]
    ne = next_pow2(max((len(e) for e in elist), default=1) or 1)
    edges = np.zeros((kp, ne, 4), np.float32)
    evalid = np.zeros((kp, ne), dtype=bool)
    boxes = np.full((kp, 4), 1e9, np.float32)
    boxes[:, 2:] = -1e9
    for i, e in enumerate(elist):
        edges[i, : len(e)] = e
        evalid[i, : len(e)] = True
        boxes[i] = polygons[i].envelope.as_tuple()
    return edges, evalid, boxes


def _contains_slab_setup(xs, boxes64):
    """Per-polygon x-slabs from envelope centers: slab half-width =
    envelope half-width + 2*EDGE_EPS, which dominates both the box's
    widening and the f32 rounding of center and half-width, so every
    point passing the widened f32 box test lies in its slab."""
    cxs = (boxes64[:, 0] + boxes64[:, 2]) * 0.5
    half = (boxes64[:, 2] - boxes64[:, 0]) * 0.5 + 2.0 * EDGE_EPS
    return _slab_bounds(xs, cxs.astype(np.float32), half.astype(np.float32))


def contains_join(polygons, px: np.ndarray, py: np.ndarray,
                  counts_only: bool = False, device_xy=None, device=None):
    """ST_Contains join: points against many polygons.

    Counts path: one kernel call over the pow2-padded polygon batch; per
    polygon its x-slab of the x-sorted table (cached per resident
    table), the widened box test, the f32 crossing number with the
    EDGE_EPS band, and device counts plus the first band rows. Only the
    counts and the band rows reach the host, where the band rows re-check
    in exact f64 (closed-boundary contains_points semantics), so counts
    are exact.

    Pairs path: the box candidates of every slab compact on the device;
    the exact host f64 PIP decides each candidate.

    ``device_xy`` and ``device`` as in dwithin_join.
    """
    from .st_functions import contains_points
    px64 = np.asarray(px, np.float64)
    py64 = np.asarray(py, np.float64)
    k = len(polygons)
    n = len(px64)
    counts = np.zeros(k, dtype=np.int64)
    empty = None if counts_only else np.empty((0, 2), dtype=np.int64)
    if k == 0 or n == 0:
        return counts, empty

    boxes64 = np.array([p.envelope.as_tuple() for p in polygons],
                       np.float64).reshape(k, 4)
    pxj, pyj = _as_device_f32(px64, py64, device_xy, device)
    dev = pxj.device
    xs, ys, order = _sorted_by_x_cached(pxj, pyj, n, device_xy is not None)
    _, _, los, widths = _contains_slab_setup(xs, boxes64)
    if not len(widths) or int(widths.max()) == 0:
        return counts, empty
    eps = float(np.float32(EDGE_EPS))

    if counts_only:
        kp = _poly_pad(k)
        edges, evalid, boxes32 = pack_polygon_batch(polygons, pad_to=kp)
        losp = np.zeros(kp, np.int32)
        widthsp = np.zeros(kp, np.int32)
        losp[:k] = los
        widthsp[:k] = widths
        tables = (xs, ys, order, torch.from_numpy(losp).to(dev),
                  torch.from_numpy(widthsp).to(dev),
                  torch.from_numpy(boxes32).to(dev),
                  torch.from_numpy(edges).to(dev),
                  torch.from_numpy(evalid.sum(axis=1).astype(np.int32)).to(dev))
        band_cap = 256
        dc, bc, brows = kernels.contains_counts(*tables, eps, EDGE_EPS2,
                                                band_cap)
        counts[:] = dc.cpu().numpy()[:k]
        bc = bc.cpu().numpy()[:k]
        brows = brows.cpu().numpy()[:k]
        for j in np.flatnonzero(bc):
            rows_j = brows[j]
            rows_j = rows_j[rows_j >= 0]
            if int(bc[j]) > band_cap:
                cap = 1 << (int(bc[j]) - 1).bit_length()
                rows_j = kernels.contains_band_rows(
                    *tables, eps, EDGE_EPS2, [j], cap).cpu().numpy()[0]
                rows_j = rows_j[rows_j >= 0]
            hit = contains_points(polygons[j], px64[rows_j], py64[rows_j])
            counts[j] += int(hit.sum())
        return counts, None

    # pairs: box candidates compact on the device, then the exact host
    # PIP decides each candidate in f64 (no band machinery: every
    # candidate is checked exactly)
    rows, qi = kernels.slab_pairs(
        xs, ys, order, torch.from_numpy(los).to(dev),
        torch.from_numpy(widths).to(dev),
        torch.from_numpy(boxes64.astype(np.float32)).to(dev), 0.0, eps,
        box=True)
    rows = rows.cpu().numpy().astype(np.int64)
    qi = qi.cpu().numpy().astype(np.int64)
    bounds = np.searchsorted(qi, np.arange(k + 1))
    pair_chunks: list[np.ndarray] = []
    for j in np.flatnonzero(np.diff(bounds)):
        sel = rows[bounds[j]:bounds[j + 1]]
        sel = sel[contains_points(polygons[j], px64[sel], py64[sel])]
        counts[j] = len(sel)
        if len(sel):
            pair_chunks.append(np.stack(
                [sel, np.full(len(sel), j)], axis=1).astype(np.int64))
    pairs = (np.concatenate(pair_chunks, axis=0) if pair_chunks
             else np.empty((0, 2), dtype=np.int64))
    return counts, pairs


# -- KNN -------------------------------------------------------------------

def knn_batched(px: np.ndarray, py: np.ndarray,
                qx, qy, k: int, device_xy=None, device=None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-query KNN: one kernel call answers all Q query points (the
    reference KNearestNeighborSearchProcess takes a collection of query
    features for the same reason). Returns (distances (Q, k), indices
    (Q, k)), each row ascending by exact f64 distance.

    The query batch pads to a pow2 (zscan.stack_points) and the
    candidate window to kpad = next_pow2(k + 32) rows per query, which
    the host re-ranks in f64.

    Ties are id-stable: the kernel prefers the lower row on equal f32
    distances (lax.top_k's order), and the f64 re-rank sorts (distance,
    id) lexicographically, so equal-distance points at the k boundary
    resolve to the smallest row ids, in the batched and single-query
    paths alike.
    """
    px64 = np.asarray(px, np.float64)
    py64 = np.asarray(py, np.float64)
    qx64 = np.atleast_1d(np.asarray(qx, np.float64))
    qy64 = np.atleast_1d(np.asarray(qy, np.float64))
    nq = len(qx64)
    n = len(px64)
    k = min(k, n)
    if nq == 0 or k <= 0:
        return (np.zeros((nq, max(k, 0))),
                np.zeros((nq, max(k, 0)), np.int64))
    pxj, pyj = _as_device_f32(px64, py64, device_xy, device)
    dev = pxj.device
    kpad = min(next_pow2(k + 32), int(pxj.shape[0]))
    qxp, qyp, _ = stack_points(qx64, qy64)
    _, idx = kernels.knn_topk(pxj, pyj, torch.from_numpy(qxp).to(dev),
                              torch.from_numpy(qyp).to(dev), kpad, n)
    idx = idx.cpu().numpy()[:nq].astype(np.int64)
    # f32 distances can tie or misorder within ~1e-5 deg: the k + 32
    # window absorbs the misordering and the host re-ranks it in f64.
    # Capacity padding surfaces idx >= n only when kpad exceeds n; those
    # slots rank last and never reach the first k <= n positions.
    safe = np.minimum(idx, n - 1)
    dx = px64[safe] - qx64[:, None]
    dy = py64[safe] - qy64[:, None]
    exact = np.sqrt(dx * dx + dy * dy)
    exact[idx >= n] = np.inf
    dists = np.empty((nq, k), np.float64)
    ids = np.empty((nq, k), np.int64)
    for i in range(nq):
        top = np.lexsort((idx[i], exact[i]))[:k]
        dists[i] = exact[i][top]
        ids[i] = idx[i][top]
    return dists, ids


def knn(px: np.ndarray, py: np.ndarray, qx: float, qy: float,
        k: int, device_xy=None, device=None) -> tuple[np.ndarray, np.ndarray]:
    """k nearest points to (qx, qy): one kernel pass over every row (the
    batched path with Q = 1). Returns (distances_deg, indices) sorted
    ascending. ``device_xy`` passes resident f32 columns (see
    dwithin_join), so a store-backed KNN never re-uploads its table."""
    d, ids = knn_batched(px, py, float(qx), float(qy), k,
                         device_xy=device_xy, device=device)
    return d[0], ids[0]


def prewarm_join_kernels(device_xy, nrows: int) -> None:
    """Ready the join paths for a resident table: build the kernel
    library (on the card, once per source hash) and cache the columns'
    x-sort, so the first real join pays neither. The port compiles
    nothing per shape, so the reference's dummy joins have nothing left
    to warm; the shape classes the reference prewarms (dwithin at 1,024
    queries, KNN at 1 and 8) are still noted to ``obs.runtime`` as
    misses of domain ``join``, as the reference notes them. Called from
    the store's bulk ingest (``geomesa.join.prewarm``)."""
    pxj, pyj = device_xy
    if nrows == 0:
        return
    from ..obs.runtime import runtime
    cap = 1 << max(int(nrows - 1).bit_length(), 0)
    runtime.note_plan_probe("join", ("dwithin", cap, 1024), hit=False)
    for q in (1, 8):
        runtime.note_plan_probe("join", ("knn", cap, q), hit=False)
    if pxj.device.type == "cuda":
        kernels._library()
    _sorted_by_x_cached(pxj, pyj, nrows, cacheable=True)
