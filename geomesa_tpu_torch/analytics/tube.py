"""TubeSelect: find features within a space-time "tube" around a track
(geomesa-process tube/TubeSelectProcess.scala:37).

The reference buffers and time-bins the input track (TubeBuilder:36,
with line-gap interpolation) and issues one spatio-temporal query per
bin. ``TubeBuilder`` makes those (bbox, time-interval) pairs on the
host. Their device program (a row matches if it falls in box_i AND
interval_i for some i; the JAX package's ``_tube_kernel``) is the next
slice of the port (ROADMAP.md section 6, queue 2 row K4), so
``tube_select_mask`` raises until then.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TubeBuilder", "tube_select_mask"]


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


def tube_select_mask(data, boxes: np.ndarray,
                     intervals: np.ndarray) -> np.ndarray:
    """Tube membership of every row of ``data`` (a ScanData): the paired
    (box, interval) kernel belongs to the tube slice."""
    raise NotImplementedError(
        "tube select's paired (box, interval) kernel is not in the "
        "PyTorch port yet; it belongs to the tube slice (ROADMAP.md "
        "section 6, queue 2 row K4)")
