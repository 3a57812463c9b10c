"""TubeSelect: find features within a space-time "tube" around a track
(geomesa-process tube/TubeSelectProcess.scala:37).

The reference buffers and time-bins the input track (TubeBuilder:36,
with line-gap interpolation) and issues one spatio-temporal query per
bin. ``TubeBuilder`` makes those (bbox, time-interval) pairs on the
host; ``tube_select_mask`` evaluates them in one pass of the tube kernel
(``scan/kernels.tube_mask``, ``csrc/tube.cu``; the JAX package's
``_tube_kernel``): a row matches if it falls in box_i AND interval_i for
some pair i, by the scan's two-float and (day, ms) compares.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scan import kernels
from ..scan.zscan import MILLIS_PER_DAY, split_two_float

__all__ = ["TubeBuilder", "tube_select_mask", "tube_select_rows",
           "tube_tables"]


class TubeBuilder:
    """Discretize a track into (bbox, time-interval) tube segments.

    bin_gap interpolation: consecutive track points further apart than
    max_bins get intermediate segments (LineGapFill analog).
    """

    def __init__(self, buffer_deg: float, bin_millis: int,
                 max_bins: int = 256):
        self.buffer = float(buffer_deg)
        self.bin_millis = int(bin_millis)
        self.max_bins = max_bins

    def build(self, xs, ys, millis) -> tuple[np.ndarray, np.ndarray]:
        """Track points -> (boxes (k,4) f64, intervals (k,2) i64).

        Each time bin covered by the track gets a box around the track's
        interpolated position(s) in that bin.
        """
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        ms = np.asarray(millis, np.int64)
        order = np.argsort(ms, kind="stable")
        xs, ys, ms = xs[order], ys[order], ms[order]
        bins: dict[int, list[tuple[float, float]]] = {}

        def add(b, x, y):
            bins.setdefault(int(b), []).append((float(x), float(y)))

        for i in range(len(xs)):
            add(ms[i] // self.bin_millis, xs[i], ys[i])
            if i + 1 < len(xs):
                b0 = ms[i] // self.bin_millis
                b1 = ms[i + 1] // self.bin_millis
                gap = int(b1 - b0)
                if 1 < gap <= self.max_bins:
                    # linear interpolation across the gap (LineGapFill)
                    for s in range(1, gap):
                        t = s / gap
                        add(b0 + s, xs[i] + t * (xs[i + 1] - xs[i]),
                            ys[i] + t * (ys[i + 1] - ys[i]))

        boxes = []
        intervals = []
        for b in sorted(bins):
            pts = np.array(bins[b])
            boxes.append((pts[:, 0].min() - self.buffer,
                          pts[:, 1].min() - self.buffer,
                          pts[:, 0].max() + self.buffer,
                          pts[:, 1].max() + self.buffer))
            intervals.append((b * self.bin_millis,
                              (b + 1) * self.bin_millis - 1))
        return np.array(boxes, np.float64), np.array(intervals, np.int64)


def tube_tables(boxes, intervals) -> tuple[np.ndarray, np.ndarray]:
    """The tube kernel's tables of K pairs: (K, 8) f32 two-float box
    edges [xmin_hi, xmin_lo, xmax_hi, xmax_lo, ymin_hi, ymin_lo, ymax_hi,
    ymax_lo] and (K, 4) int32 [day_lo, ms_lo, day_hi, ms_hi], the
    inclusive millis split with floor division (a negative millis, before
    1970, has a negative day and a non-negative ms)."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    iv = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    if len(boxes) != len(iv):
        raise ValueError("one interval per box")
    bx = np.empty((len(boxes), 8), dtype=np.float32)
    for j, c in enumerate((0, 2, 1, 3)):   # xmin, xmax, ymin, ymax
        bx[:, 2 * j], bx[:, 2 * j + 1] = split_two_float(boxes[:, c])
    days = iv // MILLIS_PER_DAY
    if len(iv) and (days.min() < -2**31 or days.max() >= 2**31):
        raise ValueError("an interval's day falls outside int32")
    tm = np.stack([days[:, 0], iv[:, 0] % MILLIS_PER_DAY,
                   days[:, 1], iv[:, 1] % MILLIS_PER_DAY],
                  axis=1).astype(np.int32)
    return bx, tm


def _tube_mask(data, boxes, intervals):
    bx, tm = tube_tables(boxes, intervals)
    return kernels.tube_mask(data.cols, data.n,
                             torch.from_numpy(bx).to(data.device),
                             torch.from_numpy(tm).to(data.device))


def tube_select_mask(data, boxes, intervals) -> np.ndarray:
    """Tube membership of the ``data.n`` rows of ``data`` (a ScanData),
    as a host bool mask: the tube kernel over the columns on their
    device, against the K (box, inclusive millis interval) pairs (any
    order; K = 0 matches nothing). Capacity rows past n never match."""
    return _tube_mask(data, boxes, intervals).cpu().numpy()


def tube_select_rows(data, boxes, intervals) -> np.ndarray:
    """The rows of ``data`` in the tube, ascending, as host int64: the
    mask of ``tube_select_mask`` is reduced to its set rows where it lies
    (torch.nonzero), so only those are copied to the host."""
    return torch.nonzero(_tube_mask(data, boxes,
                                    intervals)).flatten().cpu().numpy()
