"""Sharded scans: the multi-device execution path on torch devices.

The reference shards feature columns evenly over a ``jax.sharding.Mesh``
axis ``"data"`` and runs each program under ``shard_map``, reducing with
``psum``/``pmin``/``pmax`` over ICI (``geomesa_tpu/parallel/mesh.py``).
Here a mesh is an ordered list of torch devices, one per shard: shard
``i`` lies on visible CUDA device ``i % device_count``, so on one card
every shard shares it, and the CPU tests hold several shards on ``cpu``.

The row placement is the reference's: ``per = ceil(n / k)`` rows a shard,
shard ``i`` holding rows ``[i * per, (i + 1) * per)``; the pad rows of
the last shards carry x = y = 1e9 and millis -1, so no query matches
them. Every ``shard_map`` program becomes a loop over the shards whose
body calls a kernel the port already has (``scan/kernels.py``):

- ``_mask_fn`` and ``_mask_hit_rows``: ``scan_mask`` (the hit rows by
  ``torch.nonzero`` on the shard's device);
- ``_count_fn``: ``scan_count``;
- ``_batch_mask_fn``: ``scan_batch_bits`` + ``compact_bits`` (which runs
  ``compact_prefix``);
- ``_density_fn``: ``scan_mask`` + ``density_grid``;
- ``_tristate_fn``: ``extent_tristate``;
- ``_contains_fn``: ``contains_counts`` over each shard's x-sorted hi
  parts (cached on the data).

Each ``psum`` becomes a torch sum of the shards' results in shard order,
``pmin``/``pmax`` a min/max, an ``all_gather`` a concatenation. The
histogram and min/max programs (``_hist_fn``, ``_minmax_fn``) are torch
ops on the shards' tensors, each reading one column once a call; the
histogram counts in int64. No NCCL: a mesh spans one process.

Masks and counts stay on the shards' devices; only hit rows, counts and
the boundary candidates' verdicts reach the host, where the exact f64
boundary patch runs as in the single-card store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scan import kernels, zscan
from ..utils.device import resolve_device

__all__ = ["DataMesh", "data_mesh", "DistributedScanData", "shard_scan_data",
           "distributed_scan_mask", "exact_host_mask", "exact_hit_rows",
           "batch_exact_hit_rows", "distributed_count",
           "distributed_contains_counts", "distributed_density",
           "distributed_histogram", "distributed_minmax",
           "DistributedExtentData", "shard_extent_data",
           "distributed_tristate", "shard_tensor"]

# out-of-domain coordinates and millis of the pad rows (never a match)
PAD_COORD = 1e9
PAD_MILLIS = -1


class DataMesh:
    """A 1-D mesh over the data axis: ``devices[i]`` holds shard i."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"

    def per(self, n: int) -> int:
        """Rows a shard of ``n`` rows: ceil(n / k)."""
        return -(-n // self.size)


def data_mesh(n_devices: int | None = None, device=None) -> DataMesh:
    """A mesh of ``n_devices`` shards (None: one per visible CUDA card,
    or one on a CPU ``device``). ``device`` None means CUDA and raises
    without it; shard i lies on CUDA device ``i % device_count``, so
    ``data_mesh(8)`` on one card gives eight shards on ``cuda:0`` and
    ``data_mesh(8, device="cpu")`` eight shards on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        k = count if n_devices is None else int(n_devices)
        devs = [torch.device("cuda", i % count) for i in range(k)]
    else:
        k = 1 if n_devices is None else int(n_devices)
        devs = [dev] * k
    if k < 1:
        raise ValueError(f"a mesh of {k} shards")
    return DataMesh(devs)


def _padded(a: np.ndarray, n_padded: int, fill) -> np.ndarray:
    pad = n_padded - len(a)
    return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)]) if pad else a


def shard_tensor(a: np.ndarray, mesh: DataMesh) -> list[torch.Tensor]:
    """A padded host array (k * per rows) cut into its k shards, each
    copied to its shard's device."""
    a = np.asarray(a)
    per = len(a) // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per]))
            .to(dev) for i, dev in enumerate(mesh.devices)]


@dataclasses.dataclass
class DistributedScanData:
    """Per shard the six scan columns (xhi, xlo, yhi, ylo, tday, tms) of
    ``per`` rows on the shard's device, the true and padded row counts,
    and the host originals (kept for the exact f64 boundary patch,
    mirroring the single-card store)."""
    cols: list
    n: int            # true (unpadded) row count
    n_padded: int
    mesh: DataMesh
    host_x: np.ndarray
    host_y: np.ndarray
    host_millis: np.ndarray
    host_xhi: np.ndarray
    host_yhi: np.ndarray
    # per shard (xs, ys, order) of the hi parts sorted by x, built by the
    # first contains call
    xsorted: list | None = None

    @property
    def per(self) -> int:
        return self.n_padded // self.mesh.size

    @property
    def nbytes(self) -> int:
        """Device bytes: 24 a row of the padded shards."""
        return 24 * self.n_padded

    def knn_split(self):
        """((xhi, xlo, yhi, ylo), valid, n) as ``ring.shard_points_split``
        returns them for the same rows, each a list with one tensor a
        shard: the columns are the scan's own (bit-identical to that
        split, padded alike), valid marks rows < n."""
        per = self.per
        valid = [torch.arange(per, device=c[0].device) + i * per < self.n
                 for i, c in enumerate(self.cols)]
        return (tuple([c[j] for c in self.cols] for j in range(4)), valid,
                self.n)


def shard_scan_data(x: np.ndarray, y: np.ndarray, millis: np.ndarray,
                    mesh: DataMesh) -> DistributedScanData:
    """Host columns -> evenly-sharded device columns (padded so every
    shard is equal; pad rows carry out-of-domain coords so no query
    matches them)."""
    n = len(x)
    n_padded = mesh.per(n) * mesh.size
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    millis_h = np.asarray(millis, np.int64)
    xhi, xlo = zscan.split_two_float(_padded(x, n_padded, PAD_COORD))
    yhi, ylo = zscan.split_two_float(_padded(y, n_padded, PAD_COORD))
    tday, tms = zscan._split_time(_padded(millis_h, n_padded, PAD_MILLIS))
    parts = [shard_tensor(a, mesh) for a in (xhi, xlo, yhi, ylo, tday, tms)]
    return DistributedScanData([tuple(c) for c in zip(*parts)], n, n_padded,
                               mesh, x, y, millis_h, xhi[:n], yhi[:n])


def _offsets(data) -> range:
    return range(0, data.n_padded, max(data.per, 1))


def _shard_masks(data: DistributedScanData, q: zscan.ScanQuery) -> list:
    out = []
    for cols in data.cols:
        b, t = q.tables(cols[0].device)
        out.append(kernels.scan_mask(cols, cols[0].shape[0], b, t,
                                     q.time_any))
    return out


def distributed_scan_mask(data: DistributedScanData,
                          q: zscan.ScanQuery) -> torch.Tensor:
    """The scan on every shard; the raw device verdict as bool[n_padded]
    on the first shard's device (use ``exact_host_mask`` for the
    f64-patched result)."""
    dev = data.mesh.devices[0]
    return torch.cat([m.to(dev) for m in _shard_masks(data, q)])


def exact_host_mask(data: DistributedScanData,
                    q: zscan.ScanQuery) -> np.ndarray:
    """Gathered host mask with the exact f64 boundary patch applied
    (drops padding rows)."""
    mask = distributed_scan_mask(data, q).cpu().numpy()[:data.n]
    cand = zscan.boundary_candidates(data.host_xhi, data.host_yhi, q)
    return zscan.exact_patch(mask, cand, data.host_x, data.host_y,
                             data.host_millis, q)


def exact_hit_rows(data: DistributedScanData,
                   q: zscan.ScanQuery) -> np.ndarray:
    """Sorted matching row ids with the exact f64 boundary patch: each
    shard's mask compacts to its hit rows on its device, so host work
    and transfers are O(hits + boundary candidates), never a full-length
    mask (the materializing analog of distributed_count's sum)."""
    parts = [torch.nonzero(m).flatten() + off
             for m, off in zip(_shard_masks(data, q), _offsets(data))]
    rows = (np.concatenate([p.cpu().numpy() for p in parts])
            if parts else np.empty(0, dtype=np.int64)).astype(np.int64)
    rows = rows[rows < data.n]
    # boundary patch in ROW-SET space: recompute the two-float verdict
    # on host for just the boundary candidates, compare with exact f64,
    # and add/remove the flipped rows
    cand = zscan.boundary_candidates(data.host_xhi, data.host_yhi, q)
    if len(cand):
        dev, exact = _boundary_verdicts(data, q, cand)
        add = cand[exact & ~dev]
        remove = cand[dev & ~exact]
        if len(remove):
            rows = np.setdiff1d(rows, remove, assume_unique=True)
        if len(add):
            rows = np.union1d(rows, add)
    # already sorted: the shards' rows ascend in shard order,
    # setdiff1d keeps the (sorted) input order, union1d sorts
    return rows


def _boundary_verdicts(data: DistributedScanData, q: zscan.ScanQuery,
                       cand: np.ndarray):
    """(two_float, exact_f64) bool verdicts for the candidate rows,
    with identical arithmetic to the device kernel for the former."""
    dev = np.zeros(len(cand), dtype=bool)
    xhi, xlo = zscan.split_two_float(data.host_x[cand])
    yhi, ylo = zscan.split_two_float(data.host_y[cand])
    boxes = q.boxes_np
    for i in range(q.n_boxes):
        b = boxes[i]
        dev |= (((xhi > b[0]) | ((xhi == b[0]) & (xlo >= b[1])))
                & ((xhi < b[2]) | ((xhi == b[2]) & (xlo <= b[3])))
                & ((yhi > b[4]) | ((yhi == b[4]) & (ylo >= b[5])))
                & ((yhi < b[6]) | ((yhi == b[6]) & (ylo <= b[7]))))
    exact = np.zeros(len(cand), dtype=bool)
    for i in range(q.n_boxes):
        xmin, ymin, xmax, ymax = q.host_boxes[i]
        cx, cy = data.host_x[cand], data.host_y[cand]
        exact |= (cx >= xmin) & (cx <= xmax) & (cy >= ymin) & (cy <= ymax)
    if not q.time_any:
        cm = data.host_millis[cand]
        t_ok = np.zeros(len(cand), dtype=bool)
        for lo, hi in q.host_intervals:
            t_ok |= (cm >= lo) & (cm <= hi)
        dev &= t_ok
        exact &= t_ok
    return dev, exact


def batch_exact_hit_rows(data: DistributedScanData,
                         bq: zscan.BatchedScanQuery) -> list[np.ndarray]:
    """Micro-batched exact_hit_rows: on every shard one pass of the
    batched kernels evaluates every query of the batch and compacts each
    query's hit and boundary-candidate rows on the device; the host then
    patches each query's rows, O(hits + candidates) a query."""
    hits = [[] for _ in bq.queries]
    cands = [[] for _ in bq.queries]
    for cols, off in zip(data.cols, _offsets(data)):
        dev = cols[0].device
        b, t = bq.tables(dev)
        bits, partials = kernels.scan_batch_bits(cols, cols[0].shape[0], b,
                                                 t, bq.counts(dev))
        hit_ids, cand_ids, counts = kernels.compact_bits(bits, partials)
        for out, ids, cnt in ((hits, hit_ids, counts[0]),
                              (cands, cand_ids, counts[1])):
            for i, part in enumerate(np.split(ids.cpu().numpy(),
                                              np.cumsum(cnt)[:-1])):
                out[i].append(part.astype(np.int64) + off)
    out = []
    for i, sq in enumerate(bq.queries):
        rows = np.concatenate(hits[i]) if hits[i] else np.empty(0, np.int64)
        crows = (np.concatenate(cands[i]) if cands[i]
                 else np.empty(0, np.int64))
        out.append(zscan.patch_hit_rows(rows[rows < data.n], sq, data.host_x,
                                        data.host_y, data.host_millis,
                                        crows[crows < data.n]))
    return out


def _exact_count_adjustment(data: DistributedScanData,
                            q: zscan.ScanQuery) -> int:
    """Difference between exact-f64 and two-float verdicts over the
    boundary candidates (time is exact in both, so only spatial flips)."""
    cand = zscan.boundary_candidates(data.host_xhi, data.host_yhi, q)
    if len(cand) == 0:
        return 0
    dev, exact = _boundary_verdicts(data, q, cand)
    return int(exact.sum()) - int(dev.sum())


def distributed_count(data: DistributedScanData, q: zscan.ScanQuery) -> int:
    """Scan + count on every shard, summed in shard order (the psum),
    corrected by the host boundary adjustment so the result is
    exact-f64."""
    dev = data.mesh.devices[0]
    parts = []
    for cols in data.cols:
        b, t = q.tables(cols[0].device)
        parts.append(kernels.scan_count(cols, cols[0].shape[0], b, t,
                                        q.time_any).to(dev, torch.int64))
    device = int(torch.cat(parts).sum().item()) if parts else 0
    return device + _exact_count_adjustment(data, q)


def distributed_density(data: DistributedScanData, q: zscan.ScanQuery,
                        bbox: tuple[float, float, float, float],
                        width: int, height: int) -> np.ndarray:
    """Density surface: per shard the scan mask and the density kernel
    over its points (x = f32(xhi + xlo), the raw two-float verdict, no
    f64 boundary patch), the f32 grids summed in shard order (the psum).
    Pixel-snap output; boundary-band f64 differences are below pixel
    resolution (DensityScan analog, index/iterators/DensityScan.scala:30)."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    sx = width / (xmax - xmin) if xmax > xmin else 0.0
    sy = height / (ymax - ymin) if ymax > ymin else 0.0
    scalars = [float(np.float32(v)) for v in (xmin, ymin, sx, sy)]
    dev = data.mesh.devices[0]
    grid = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for cols, mask in zip(data.cols, _shard_masks(data, q)):
        xhi, xlo, yhi, ylo = cols[:4]
        grid += kernels.density_grid(xhi + xlo, yhi + ylo, None, mask,
                                     *scalars, width, height).to(dev)
    return grid.cpu().numpy()


def distributed_histogram(values: list, mask: list, mesh: DataMesh,
                          nbins: int, lo: float, hi: float) -> np.ndarray:
    """Per shard a scatter-add histogram of the f32 ``values`` where
    ``mask`` (bool), summed in shard order (the StatsCombiner merge
    analog; Histogram/BinnedArray, utils/stats/), int64 counts.
    np.histogram semantics: values outside [lo, hi] are dropped, the
    last bin is closed at hi; the bin of a value is
    ``clip(int((v - lo) * scale), 0, nbins - 1)`` in f32."""
    if nbins <= 0 or not hi > lo:
        raise ValueError(f"invalid histogram range: nbins={nbins}, "
                         f"lo={lo}, hi={hi}")
    scale = nbins / (hi - lo)
    out = torch.zeros(nbins, dtype=torch.int64, device=mesh.devices[0])
    for v, m in zip(values, mask):
        lo32 = torch.tensor(lo, dtype=torch.float32, device=v.device)
        hi32 = torch.tensor(hi, dtype=torch.float32, device=v.device)
        keep = m & (v >= lo32) & (v <= hi32)
        b = ((v[keep] - lo32)
             * torch.tensor(scale, dtype=torch.float32, device=v.device))
        b = b.to(torch.int64).clamp(0, nbins - 1)
        out += torch.bincount(b, minlength=nbins).to(out.device)
    return out.cpu().numpy()


def distributed_minmax(values: list, mask: list,
                       mesh: DataMesh) -> tuple[float, float]:
    """Global (min, max) of the masked shard values (+inf, -inf where
    none): a min and a max per shard, then across the shards (MinMax
    sketch merge, utils/stats/MinMax.scala analog)."""
    lo, hi = float("inf"), float("-inf")
    for v, m in zip(values, mask):
        if v.numel():
            inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
            lo = min(lo, float(torch.where(m, v, inf).min()))
            hi = max(hi, float(torch.where(m, v, -inf).max()))
    return lo, hi


@dataclasses.dataclass
class DistributedExtentData:
    """Per shard an extent schema's rows (``gscan.ExtentScanData``:
    outward-rounded f32 bounds, valid, (day, ms) times or None) on the
    shard's device; pad rows are not valid."""
    shards: list
    has_time: bool
    n: int
    n_padded: int
    mesh: DataMesh


def shard_extent_data(bounds: np.ndarray, millis: np.ndarray | None,
                      mesh: DataMesh) -> DistributedExtentData:
    """(n, 4) f64 bounds [xmin ymin xmax ymax] (NaN rows = null geoms)
    -> evenly-sharded outward-rounded f32 device rows."""
    from ..scan.gscan import ExtentScanData, _round_out
    bounds = np.asarray(bounds, np.float64).reshape(-1, 4)
    n = len(bounds)
    n_padded = mesh.per(n) * mesh.size
    valid = ~np.isnan(bounds[:, 0])
    safe = np.where(valid[:, None], bounds, 0.0)
    # the rounded bounds and the (day, ms) words written straight into
    # the padded tables (pad rows zero, as the reference pads them)
    table = np.zeros((n_padded, 4), np.float32)
    table[:n, 0], table[:n, 2] = _round_out(safe[:, 0], safe[:, 2])
    table[:n, 1], table[:n, 3] = _round_out(safe[:, 1], safe[:, 3])
    del safe
    has_time = millis is not None
    times = None
    if has_time:
        times = np.zeros((n_padded, 2), np.int32)
        times[:n, 0], times[:n, 1] = zscan._split_time(millis)
    valid = _padded(valid, n_padded, False)
    per = mesh.per(n)
    shards = []
    for i, dev in enumerate(mesh.devices):
        s = slice(i * per, (i + 1) * per)
        shards.append(ExtentScanData(
            torch.from_numpy(np.ascontiguousarray(table[s])).to(dev),
            torch.from_numpy(np.ascontiguousarray(valid[s])).to(dev),
            None if times is None
            else torch.from_numpy(np.ascontiguousarray(times[s])).to(dev),
            per))
    return DistributedExtentData(shards, has_time, n, n_padded, mesh)


def distributed_tristate(data: DistributedExtentData, q) -> np.ndarray:
    """The extent tristate on every shard (``q`` a
    ``gscan.ExtentQuery``); host int8[n] (0=OUT, 1=MAYBE, 2=IN) with
    padding dropped. Same exactness contract as gscan.extent_tristate:
    the MAYBE band goes to the caller's exact host predicate."""
    from ..scan import gscan
    return np.concatenate([gscan.extent_tristate(s, q).cpu().numpy()
                           for s in data.shards])[:data.n]


def _xsorted(data: DistributedScanData) -> list:
    """Per shard its hi parts sorted by x (kernels.sorted_by_x), built
    once and kept on the data."""
    if data.xsorted is None:
        data.xsorted = [kernels.sorted_by_x(c[0], c[2], c[0].shape[0])
                        for c in data.cols]
    return data.xsorted


def distributed_contains_counts(data: DistributedScanData, polygons,
                                band_cap: int = 512) -> np.ndarray:
    """Sharded exact ST_Contains counts: points vs many polygons.

    The multi-shard form of analytics/join.contains_join's counts path:
    every shard runs the contains kernel over its own points' hi parts
    (the f32 crossing number with the EDGE_EPS band) for ALL polygons,
    the definite counts sum over the shards, and only each shard's band
    rows (global ids) come back for the exact host f64 patch, so counts
    carry the same exact-by-construction contract. A polygon whose band
    overflows ``band_cap`` on some shard is recounted exactly on the host
    over its bbox candidates (rare: the band is a ~1e-4 deg strip around
    the boundary)."""
    from ..analytics.join import (_contains_slab_setup, _poly_pad,
                                  pack_polygon_batch)
    from ..analytics.st_functions import contains_points
    from ..scan.gscan import EDGE_EPS, EDGE_EPS2
    k = len(polygons)
    counts = np.zeros(k, dtype=np.int64)
    if k == 0 or data.n == 0:
        return counts
    kp = _poly_pad(k)
    edges, evalid, boxes = pack_polygon_batch(polygons, pad_to=kp)
    boxes64 = np.array([p.envelope.as_tuple() for p in polygons],
                       np.float64).reshape(k, 4)
    ecount = evalid.sum(axis=1).astype(np.int32)
    eps = float(np.float32(EDGE_EPS))
    bcs, brows = [], []
    for (xs, ys, order), off in zip(_xsorted(data), _offsets(data)):
        dev = xs.device
        _, _, los, widths = _contains_slab_setup(xs, boxes64)
        losp = np.zeros(kp, np.int32)
        widthsp = np.zeros(kp, np.int32)
        losp[:k] = los
        widthsp[:k] = widths
        dc, bc, br = kernels.contains_counts(
            xs, ys, order, torch.from_numpy(losp).to(dev),
            torch.from_numpy(widthsp).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(edges).to(dev), torch.from_numpy(ecount).to(dev),
            eps, EDGE_EPS2, band_cap)
        counts += dc.cpu().numpy()[:k]
        bcs.append(bc.cpu().numpy()[:k])
        br = br.cpu().numpy()[:k].astype(np.int64)
        brows.append(np.where(br >= 0, br + off, -1))
    bc = np.stack(bcs, axis=1)           # (k, shards) band counts
    hx, hy = data.host_x, data.host_y
    for j in np.flatnonzero(bc.sum(axis=1)):
        poly = polygons[j]
        if (bc[j] > band_cap).any():
            # a shard kept fewer band rows than it had: recount this
            # polygon exactly on the host over its bbox candidates
            xmin, ymin, xmax, ymax = poly.envelope.as_tuple()
            m = ((hx >= xmin) & (hx <= xmax)
                 & (hy >= ymin) & (hy <= ymax))
            counts[j] = int(contains_points(poly, hx[m], hy[m]).sum())
            continue
        rows = np.concatenate([b[j] for b in brows])
        rows = rows[(rows >= 0) & (rows < data.n)]
        counts[j] += int(contains_points(poly, hx[rows], hy[rows]).sum())
    return counts
