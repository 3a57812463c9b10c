"""Scan-time aggregations: density, BIN encoding, sampling.

Analogs of the reference's aggregating iterators (index/iterators/:
DensityScan.scala:30, BinAggregatingScan.scala:22,
SamplingIterator.scala:22). The density grid runs on the device as the
hand kernel ``kernels.density_grid`` (csrc/density.cu); BIN encoding and
sampling are numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import kernels

__all__ = ["density_grid", "density_scalars", "density_upload",
           "encode_bin_records", "encode_bin_batch", "decode_bin_records",
           "merge_sorted_bin_chunks", "sample_mask"]


def density_scalars(bbox, width: int, height: int):
    """(xmin, ymin, sx, sy) as np.float32: the bbox corner and the
    pixels per unit, computed in float64 and rounded to f32 once (a
    degenerate bbox side gives a scale of 0)."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    sx = width / (xmax - xmin) if xmax > xmin else 0.0
    sy = height / (ymax - ymin) if ymax > ymin else 0.0
    return np.float32(xmin), np.float32(ymin), np.float32(sx), np.float32(sy)


def density_upload(x, y, mask, weights, device):
    """The kernel's inputs on ``device``: x and y rounded to nearest
    f32 from float64, the weights as f32 (None: unit weights), the mask
    as bool."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)
    return (up(x, np.float32), up(y, np.float32),
            None if weights is None else up(weights, np.float32),
            up(mask, np.bool_))


def density_grid(x: np.ndarray, y: np.ndarray, mask: np.ndarray,
                 bbox: tuple[float, float, float, float],
                 width: int, height: int,
                 weights: np.ndarray | None = None,
                 device=None) -> np.ndarray:
    """Weighted 2-D histogram over the pixel grid (DensityScan analog:
    GridSnap pixel binning + weight accumulation), as a float32
    (height, width) array. Runs on ``device`` (None means CUDA)."""
    xmin, ymin, sx, sy = density_scalars(bbox, width, height)
    xt, yt, wt, mt = density_upload(x, y, mask, weights,
                                    resolve_device(device))
    grid = kernels.density_grid(xt, yt, wt, mt, xmin, ymin, sx, sy,
                                width, height)
    return grid.cpu().numpy()


def _id_hashes(ids: np.ndarray) -> np.ndarray:
    """Track-id hash codes, matching java String.hashCode semantics
    (BinaryOutputEncoder uses id.hashCode,
    utils/bin/BinaryOutputEncoder.scala:58)."""
    out = np.zeros(len(ids), dtype=np.int64)
    for i, s in enumerate(ids):
        h = 0
        for ch in str(s):
            h = (31 * h + ord(ch)) & 0xFFFFFFFF
        out[i] = h if h < 0x80000000 else h - 0x100000000
    return out.astype(np.int32)


def encode_bin_records(ids: np.ndarray, x: np.ndarray, y: np.ndarray,
                       millis: np.ndarray,
                       labels: np.ndarray | None = None,
                       track_values: np.ndarray | None = None,
                       sort: bool = False) -> bytes:
    """Encode the 16-byte (or 24-byte labeled) BIN format:
    [track_hash:i32][seconds:i32][lat:f32][lon:f32]([label:8bytes]) —
    little-endian, matching BinaryOutputEncoder's record layout.

    track_values overrides the per-record track id source (the
    BIN_TRACK hint attribute); default is the feature id.
    """
    n = len(ids)
    track = _id_hashes(track_values if track_values is not None else ids)
    secs = (np.asarray(millis, np.int64) // 1000).astype(np.int32)
    if sort:
        order = np.argsort(secs, kind="stable")
        track, secs = track[order], secs[order]
        x, y = np.asarray(x)[order], np.asarray(y)[order]
        if labels is not None:
            labels = np.asarray(labels)[order]
    if labels is None:
        rec = np.empty(n, dtype=[("track", "<i4"), ("secs", "<i4"),
                                 ("lat", "<f4"), ("lon", "<f4")])
    else:
        rec = np.empty(n, dtype=[("track", "<i4"), ("secs", "<i4"),
                                 ("lat", "<f4"), ("lon", "<f4"),
                                 ("label", "S8")])
        rec["label"] = np.asarray([str(lb)[:8].encode() for lb in labels])
    rec["track"] = track
    rec["secs"] = secs
    rec["lat"] = np.asarray(y, np.float32)
    rec["lon"] = np.asarray(x, np.float32)
    return rec.tobytes()


def encode_bin_batch(sft, ids: np.ndarray, batch,
                     track: str | None = None,
                     label: str | None = None,
                     sort: bool = False) -> bytes:
    """BIN-encode one FeatureBatch of a point schema: the point
    coordinates, dtg millis and track/label attribute values over
    ``encode_bin_records``."""
    if batch is None or not batch.n:
        return b""
    col = batch.col(sft.geom_field)
    dtg = sft.dtg_field
    millis = (batch.col(dtg).millis if dtg
              else np.zeros(batch.n, dtype=np.int64))
    track_vals = None
    if track is not None and track != "id":
        tc = batch.col(track)
        track_vals = np.array([tc.value(i) for i in range(batch.n)],
                              dtype=object)
    labels = None
    if label is not None:
        lc = batch.col(label)
        labels = np.array([lc.value(i) for i in range(batch.n)],
                          dtype=object)
    return encode_bin_records(np.asarray(ids), col.x, col.y, millis,
                              labels=labels, track_values=track_vals,
                              sort=sort)


def merge_sorted_bin_chunks(chunks: list[bytes],
                            labeled: bool = False) -> bytes:
    """Merge time-sorted BIN chunks into one sorted stream — the
    BinSorter client reduce (index/utils/bin/BinSorter.scala:16): one
    stable argsort over the concatenated seconds column."""
    if not chunks:
        return b""
    recs = [decode_bin_records(c, labeled) for c in chunks]
    allr = np.concatenate(recs)
    return allr[np.argsort(allr["secs"], kind="stable")].tobytes()


def decode_bin_records(data: bytes, labeled: bool = False) -> np.ndarray:
    if labeled:
        dt = [("track", "<i4"), ("secs", "<i4"), ("lat", "<f4"),
              ("lon", "<f4"), ("label", "S8")]
    else:
        dt = [("track", "<i4"), ("secs", "<i4"), ("lat", "<f4"),
              ("lon", "<f4")]
    return np.frombuffer(data, dtype=dt)


def sample_mask(n: int, rate: float, by: np.ndarray | None = None,
                seed: int = 0) -> np.ndarray:
    """1-in-k sampling mask (SamplingIterator): keeps every k-th feature
    overall, or every k-th per `by` group (the SAMPLE_BY attribute)."""
    if rate >= 1.0:
        return np.ones(n, dtype=bool)
    k = max(1, int(round(1.0 / max(rate, 1e-9))))
    if by is None:
        return (np.arange(n) % k) == 0
    # per-group modulo: order within group via stable argsort
    by = np.asarray(by)
    order = np.argsort(by, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    grp = by[order]
    new_grp = np.empty(n, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = grp[1:] != grp[:-1]
    # position within each group
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(new_grp, idx, 0))
    rank[order] = idx - start
    return (rank % k) == 0
