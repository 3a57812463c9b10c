"""Ring collectives on the shards: the distributed join counts and KNN.

The reference runs these as ring pipelines over its device mesh
(``geomesa_tpu/parallel/ring.py``): the left side stays sharded, the
right side's shards rotate around the ring by ``ppermute`` until every
(left shard, right shard) block has met once, and KNN prunes each shard
to a few candidates, gathers them and re-ranks them exactly on the host.

Here the shards are tensors on the mesh's devices (``mesh.py``), so the
ring's rotation becomes a loop over the right shards: each (left shard,
right shard) block goes through the dwithin kernel (``dwithin_counts``,
whose f32 steps are each rounded as the reference's are), with each
right shard's x-sorted copy built once a call and shared by every left
shard. KNN's per-shard prune is the knn kernel (``knn_topk``), its
candidates gathered in shard order. No NCCL: a mesh spans one process.

f32 distance arithmetic is conservative: pairs within ``band`` of the
radius are counted separately so callers can resolve them exactly on
host (the same two-tier contract as analytics/join.dwithin_join).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scan import kernels, zscan
from .mesh import PAD_COORD, DataMesh, shard_tensor

__all__ = ["ring_dwithin_counts", "distributed_knn", "shard_points",
           "shard_points_split"]


def _valid(n: int, n_padded: int) -> np.ndarray:
    valid = np.ones(n_padded, dtype=bool)
    valid[n:] = False
    return valid


def shard_points(x: np.ndarray, y: np.ndarray, mesh: DataMesh,
                 fill=PAD_COORD):
    """Pad to equal shards and place f32 coords on the shards' devices.

    Returns (xs, ys, valid, n), each of the first three a list with one
    tensor a shard: pad rows get ``fill`` (far outside any realistic
    query) and valid=False."""
    n = len(x)
    n_padded = mesh.per(n) * mesh.size
    pad = n_padded - n

    def prep(a):
        a = np.asarray(a, np.float64).astype(np.float32)
        return np.concatenate([a, np.full(pad, fill, np.float32)]) if pad else a

    return (shard_tensor(prep(x), mesh), shard_tensor(prep(y), mesh),
            shard_tensor(_valid(n, n_padded), mesh), n)


def shard_points_split(x: np.ndarray, y: np.ndarray, mesh: DataMesh,
                       fill=PAD_COORD):
    """Two-float sharded coords: ((xhi, xlo, yhi, ylo), valid, n), each
    a list with one tensor a shard.

    The (hi, lo) pairs reconstruct f64 to ~1e-12 deg on host, so exact
    re-ranks never need a full host coordinate copy: candidate coords
    travel back with the candidates themselves."""
    n = len(x)
    n_padded = mesh.per(n) * mesh.size
    pad = n_padded - n

    def padded(a):
        a = np.asarray(a, np.float64)
        return np.concatenate([a, np.full(pad, fill)]) if pad else a

    xhi, xlo = zscan.split_two_float(padded(x))
    yhi, ylo = zscan.split_two_float(padded(y))
    return (tuple(shard_tensor(a, mesh) for a in (xhi, xlo, yhi, ylo)),
            shard_tensor(_valid(n, n_padded), mesh), n)


def _valid_prefix(valid: torch.Tensor) -> int | None:
    """The row count when ``valid`` holds its true rows first (as the
    shard functions give them), else None."""
    nrows = int(valid.sum())
    if nrows < valid.shape[0] and bool(valid[nrows:].any()):
        return None
    return nrows


def _rows_for(px, valid):
    """(px, nrows) for the kernels: the rows past a valid prefix rank
    as padding by ``nrows``; any other invalid row gets a NaN x, which
    no distance test passes."""
    nrows = _valid_prefix(valid)
    if nrows is None:
        return px.masked_fill(~valid, float("nan")), px.shape[0]
    return px, nrows


def ring_dwithin_counts(lx, ly, lvalid, rx, ry, rvalid, mesh: DataMesh,
                        radius_deg: float, coord_span: float = 360.0):
    """Per-left-point neighbor counts within ``radius_deg`` (planar) of
    any right point, over every (left shard, right shard) block.

    Returns (sure, band_counts) host int32 arrays over the padded left
    length: ``sure`` pairs are definitely within radius in f64 terms;
    left rows with band_counts > 0 have pairs inside the f32 error band
    around the radius and need a host f64 recheck for exact totals.
    The band is derived from f32 eps and ``coord_span`` (the coordinate
    magnitude bound: 360 for degrees; pass the actual span for
    projected coordinates) by the same rule as analytics/join's."""
    from ..utils.fp import f32_band
    r2_hi, r2_lo = (float(np.float32(v))
                    for v in f32_band(radius_deg, coord_span))
    # each right shard's table and x-sort, built once for every left shard
    right = []
    for px, py, valid in zip(rx, ry, rvalid):
        px, nrows = _rows_for(px, valid)
        right.append((px, py, nrows, kernels.sorted_by_x(px, py, nrows)))
    sure_out, band_out = [], []
    for qx, qy, lv in zip(lx, ly, lvalid):
        sure = torch.zeros(qx.shape[0], dtype=torch.int32, device=qx.device)
        band = torch.zeros_like(sure)
        for px, py, nrows, xs in right:
            d, b = kernels.dwithin_counts(px, py, qx.to(px.device),
                                          qy.to(px.device), r2_hi, r2_lo,
                                          nrows, xsorted=xs)
            sure += d.to(sure.device)
            band += b.to(band.device)
        zero = torch.zeros_like(sure)
        sure_out.append(torch.where(lv, sure, zero).cpu().numpy())
        band_out.append(torch.where(lv, band, zero).cpu().numpy())
    return np.concatenate(sure_out), np.concatenate(band_out)


def _prune(px, py, valid, q, fetch: int):
    """One shard's ``fetch`` nearest rows to q: (f32 d2, local rows) on
    the shard's device, ascending in (d2, row), pad and invalid rows at
    +inf or NaN (the caller drops them)."""
    px, nrows = _rows_for(px, valid)
    qx = torch.tensor([q[0]], dtype=torch.float32, device=px.device)
    qy = torch.tensor([q[1]], dtype=torch.float32, device=px.device)
    d2, idx = kernels.knn_topk(px, py, qx, qy, fetch, nrows)
    return d2[0], idx[0]


def distributed_knn(px, py, pvalid, mesh: DataMesh, n: int,
                    qx: float, qy: float, k: int,
                    host_x: np.ndarray | None = None,
                    host_y: np.ndarray | None = None,
                    split=None) -> np.ndarray:
    """k nearest rows to (qx, qy): each shard's prune to its candidates
    on its device, the candidate sets gathered in shard order, exact
    re-rank on host.

    Each shard over-fetches (2k + 16 candidates, clamped to the shard
    length) so f32 ranking ties at the k-th boundary don't drop a true
    f64 top-k member; the result is exact unless more than 2k + 16
    points of one shard land inside the f32 error band of the k-th
    distance (the reference's geohash-spiral KNN is likewise approximate
    at its precision floor, knn/KNNQuery.scala:27).

    Exact re-rank sources, in preference order:
    - ``split`` (from shard_points_split, pass px=py=None): candidates
      return WITH their two-float coords, reconstructed host-side to
      ~1e-12 deg: no host coordinate copy at any scale;
    - ``host_x/host_y``: full f64 host arrays (small tables only);
    - neither: the f32 device distances rank as-is.
    The re-rank is a stable sort over the candidates in shard order, each
    shard's in ascending (f32 d2, row) order. Returns global row
    indices, nearest first."""
    kk = min(k, max(n, 1))
    shards = split[0] if split is not None else px
    shard_len = shards[0].shape[0]
    if shard_len == 0:
        return np.empty(0, dtype=np.int64)
    fetch = min(2 * kk + 16, max(shard_len, 1))
    q = np.array([qx, qy], np.float32)
    dists, gids, coords = [], [], []
    for s, valid in enumerate(pvalid):
        if split is not None:
            xhi, xlo, yhi, ylo = (c[s] for c in split)
            d2, idx = _prune(xhi, yhi, valid, q, fetch)
            coords.append([c[idx].cpu().numpy() for c in (xhi, xlo, yhi,
                                                          ylo)])
        else:
            d2, idx = _prune(px[s], py[s], valid, q, fetch)
        dists.append(d2.cpu().numpy())
        gids.append(idx.cpu().numpy() + s * shard_len)
    dists = np.concatenate(dists)
    gids = np.concatenate(gids)
    mask = (dists < np.inf) & (gids < n)
    keep = gids[mask]
    if split is not None:
        cxh, cxl, cyh, cyl = (np.concatenate(c) for c in zip(*coords))
        cx = (cxh.astype(np.float64) + cxl.astype(np.float64))[mask]
        cy = (cyh.astype(np.float64) + cyl.astype(np.float64))[mask]
        d2 = (cx - qx) ** 2 + (cy - qy) ** 2
        order = np.argsort(d2, kind="stable")
    elif host_x is not None and host_y is not None:
        d2 = (host_x[keep] - qx) ** 2 + (host_y[keep] - qy) ** 2
        order = np.argsort(d2, kind="stable")
    else:
        order = np.argsort(dists[mask], kind="stable")
    return keep[order][:kk]
