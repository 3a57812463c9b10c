"""Spatial partitioning for parallel joins (geomesa-spark-sql analog).

The reference spatially partitions both sides of an ST join so matching
cells join pairwise (GeoMesaSparkSQL.scala:228-289 `spatiallyPartition`,
RelationUtils.spatiallyPartition:457 grid / weighted envelopes,
sql/IndexPartitioner.scala:13), then zipPartitions runs a sweepline per
cell (GeoMesaJoinRelation:312). Here partitions are envelope lists,
assignment is vectorized numpy, and each cell runs one dwithin_join
(analytics/join.py) on the device: cells are the outer (host) loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .join import dwithin_join

__all__ = ["grid_partitions", "quadtree_partitions", "assign_partitions",
           "IndexPartitioner", "partitioned_dwithin_join"]


def grid_partitions(envelope, nx: int, ny: int) -> np.ndarray:
    """(nx*ny, 4) equal-size grid envelopes covering `envelope`
    (RelationUtils equal-grid partitioning)."""
    xmin, ymin, xmax, ymax = (float(v) for v in envelope)
    xs = np.linspace(xmin, xmax, nx + 1)
    ys = np.linspace(ymin, ymax, ny + 1)
    cells = [(xs[i], ys[j], xs[i + 1], ys[j + 1])
             for j in range(ny) for i in range(nx)]
    return np.asarray(cells)


def quadtree_partitions(x, y, target_per_cell: int = 10_000,
                        max_level: int = 12,
                        sample: int = 100_000) -> np.ndarray:
    """Weighted quadtree from a data sample: refine cells until each
    holds <= target (the weighted-envelope strategy,
    GeoMesaSparkSQL.scala:252-289). Returns (n_cells, 4) envelopes
    covering the data's bbox exactly."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) > sample:
        idx = np.random.default_rng(0).choice(len(x), sample, replace=False)
        x, y = x[idx], y[idx]
    xmin, xmax = float(x.min()), float(x.max())
    ymin, ymax = float(y.min()), float(y.max())
    # expand a hair so max points fall strictly inside
    ex = (xmax - xmin or 1.0) * 1e-9
    ey = (ymax - ymin or 1.0) * 1e-9
    out: list = []
    stack = [(xmin, ymin, xmax + ex, ymax + ey, 0,
              np.arange(len(x)))]
    while stack:
        x0, y0, x1, y1, lvl, idx = stack.pop()
        if len(idx) <= target_per_cell or lvl >= max_level:
            out.append((x0, y0, x1, y1))
            continue
        mx, my = (x0 + x1) / 2, (y0 + y1) / 2
        right = x[idx] >= mx
        top = y[idx] >= my
        for quad, (qx0, qy0, qx1, qy1) in (
                (idx[~right & ~top], (x0, y0, mx, my)),
                (idx[right & ~top], (mx, y0, x1, my)),
                (idx[~right & top], (x0, my, mx, y1)),
                (idx[right & top], (mx, my, x1, y1))):
            stack.append((qx0, qy0, qx1, qy1, lvl + 1, quad))
    return np.asarray(out)


def assign_partitions(x, y, envelopes: np.ndarray) -> np.ndarray:
    """Partition index per point (-1 if in no cell). Cells are
    half-open [x0, x1) x [y0, y1) so assignment is unique for grid and
    quadtree layouts."""
    x = np.asarray(x, dtype=np.float64)[:, None]
    y = np.asarray(y, dtype=np.float64)[:, None]
    e = np.asarray(envelopes, dtype=np.float64)[None, :, :]
    inside = ((x >= e[:, :, 0]) & (x < e[:, :, 2])
              & (y >= e[:, :, 1]) & (y < e[:, :, 3]))
    hit = inside.argmax(axis=1)
    return np.where(inside.any(axis=1), hit, -1).astype(np.int64)


@dataclasses.dataclass
class IndexPartitioner:
    """Partition router: index i -> partition i (IndexPartitioner.scala:13);
    exists so pre-assigned partition ids shuffle straight through."""
    num_partitions: int

    def partition(self, key: int) -> int:
        if not 0 <= key < self.num_partitions:
            raise KeyError(f"partition {key} out of range")
        return int(key)


def partitioned_dwithin_join(xa, ya, xb, yb, radius_deg: float,
                             envelopes: np.ndarray | None = None,
                             target_per_cell: int = 50_000, device=None):
    """Distance join via spatial partitioning: side A partitions by cell,
    side B replicates into every cell its radius-buffer touches (the
    reference covers the same with partition-envelope overlap in
    SpatialJoinStrategy), then each cell joins with the device kernels
    on ``device`` (None: CUDA). Returns (n_pairs, 2) [a_idx, b_idx]
    global indices.
    """
    xa = np.asarray(xa, dtype=np.float64)
    ya = np.asarray(ya, dtype=np.float64)
    xb = np.asarray(xb, dtype=np.float64)
    yb = np.asarray(yb, dtype=np.float64)
    if envelopes is None:
        envelopes = quadtree_partitions(
            np.concatenate([xa, xb]), np.concatenate([ya, yb]),
            target_per_cell=target_per_cell)
    pa = assign_partitions(xa, ya, envelopes)
    pairs = []
    e = np.asarray(envelopes, dtype=np.float64)
    for c in range(len(e)):
        ia = np.flatnonzero(pa == c)
        if not len(ia):
            continue
        x0, y0, x1, y1 = e[c]
        ib = np.flatnonzero((xb >= x0 - radius_deg) & (xb < x1 + radius_deg)
                            & (yb >= y0 - radius_deg) & (yb < y1 + radius_deg))
        if not len(ib):
            continue
        # (the reference pads each cell to a power of two with far-away
        # points for its compile cache; they never pair, and the port
        # compiles nothing per shape)
        _, local = dwithin_join(xa[ia], ya[ia], xb[ib], yb[ib], radius_deg,
                                device=device)
        if len(local):
            pairs.append(np.stack([ia[local[:, 0]], ib[local[:, 1]]], axis=1))
    if not pairs:
        return np.empty((0, 2), dtype=np.int64)
    out = np.concatenate(pairs)
    return out[np.lexsort((out[:, 1], out[:, 0]))]
