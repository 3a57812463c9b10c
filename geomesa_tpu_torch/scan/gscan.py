"""Device geometry scans: the extent tristate and point-in-polygon.

Extent tristate (the XZ-index scan analog). An extent schema keeps its
rows' bounding boxes on the device, rounded outward to f32
(``build_extent_data``), and one kernel (``extent_tristate``,
csrc/extent.cu) classifies every row against the query's envelopes:

- OUT:   the box is surely disjoint from every envelope, or the row is
         null, or its (day, ms) lies outside every interval;
- IN:    the box lies surely inside an envelope (a geometry is always
         inside its own box, so it surely intersects);
- MAYBE: the box meets an envelope's boundary; only these rows go to the
         exact float64 predicate on the host.

Each query envelope is rounded outward (for OUT) and inward (for IN) to
f32 (``extent_query``, with ``_round_out``/``_round_in`` on the host),
so the states are right in exact f64 terms by construction.

Point-in-polygon. A crossing-number test of points against a polygon's
packed edges (the ``pip_mask`` kernel, csrc/geom.cu), with an
uncertainty band: points within EDGE_EPS of an edge, where the float32
verdict cannot be trusted, are re-checked exactly in float64 on the
host. That makes the exact INTERSECTS/WITHIN residual of a point schema
exact while the inner loop runs on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analytics.st_functions import contains_points
from . import kernels
from .zscan import MILLIS_PER_DAY

__all__ = ["EDGE_EPS", "EDGE_EPS2", "PackedPolygon", "pack_polygon",
           "packed_polygon_from_numpy", "pip_points",
           "points_in_polygon_device", "points_in_polygon",
           "ExtentScanData", "ExtentQuery", "build_extent_data",
           "extent_query", "extent_tristate", "OUT", "MAYBE", "IN"]

# uncertainty half-band (degrees) of the f32 point-in-polygon kernel;
# ~11 m at the equator, generous against the f32 ulp (~1.5e-5 deg at
# lon 180)
EDGE_EPS = 1e-4
EDGE_EPS2 = float(np.float32(EDGE_EPS * EDGE_EPS))


OUT, MAYBE, IN = 0, 1, 2


def _round_out(lo: np.ndarray, hi: np.ndarray):
    """Round [lo, hi] f64 bounds outward to f32."""
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > lo,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _round_in(lo: np.ndarray, hi: np.ndarray):
    """Round [lo, hi] f64 bounds inward to f32 (may become empty)."""
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) < lo,
                    np.nextafter(lo32, np.float32(np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) > hi,
                    np.nextafter(hi32, np.float32(-np.inf)), hi32)
    return lo32, hi32


@dataclasses.dataclass
class ExtentScanData:
    """An extent schema's rows on a device: ``bounds`` (n, 4) f32
    [xmin ymin xmax ymax] rounded outward (zeros for a null row),
    ``valid`` bool[n] (False for a null or empty geometry), and ``times``
    (n, 2) int32 [day, ms] or None for a schema with no date."""
    bounds: torch.Tensor
    valid: torch.Tensor
    times: torch.Tensor | None
    n: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.bounds, self.valid, self.times)
                   if t is not None)


def build_extent_data(bounds: np.ndarray, millis: np.ndarray | None,
                      device) -> ExtentScanData:
    """bounds: (n, 4) f64 [xmin ymin xmax ymax], NaN rows for nulls;
    millis: int64[n] or None. The rounding and the floor-division (day,
    ms) split run on the host, then one copy each to ``device``."""
    bounds = np.asarray(bounds, np.float64).reshape(-1, 4)
    valid = ~np.isnan(bounds[:, 0])
    safe = np.where(valid[:, None], bounds, 0.0)
    xmin, xmax = _round_out(safe[:, 0], safe[:, 2])
    ymin, ymax = _round_out(safe[:, 1], safe[:, 3])
    table = np.ascontiguousarray(np.stack([xmin, ymin, xmax, ymax], axis=1))
    times = None
    if millis is not None:
        millis = np.asarray(millis, np.int64)
        day = (millis // MILLIS_PER_DAY).astype(np.int32)
        ms = (millis - day.astype(np.int64) * MILLIS_PER_DAY).astype(np.int32)
        times = torch.from_numpy(
            np.ascontiguousarray(np.stack([day, ms], axis=1))).to(device)
    return ExtentScanData(torch.from_numpy(table).to(device),
                          torch.from_numpy(valid).to(device), times,
                          len(bounds))


@dataclasses.dataclass
class ExtentQuery:
    """The query's envelopes at outward and inward f32 rounding, (K, 4)
    each, and its inclusive intervals as (day, ms) int32 bounds (B, 4)
    [day_lo ms_lo day_hi ms_hi]: only the real boxes and intervals, no
    padded slots. No interval means no time constraint. The tables move
    to a device on first use there."""
    outer: np.ndarray
    inner: np.ndarray
    intervals: np.ndarray

    def __post_init__(self):
        self._tables: dict = {}

    def tables(self, device):
        """(outer, inner, intervals) tensors on ``device``, uploaded once."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.outer, self.inner, self.intervals))
        return self._tables[key]


def extent_query(boxes_f64, intervals_ms=None) -> ExtentQuery:
    """An ExtentQuery from (xmin, ymin, xmax, ymax) f64 boxes and
    inclusive (lo, hi) millis intervals."""
    boxes_f64 = list(boxes_f64)
    outer = np.zeros((len(boxes_f64), 4), np.float32)
    inner = np.zeros((len(boxes_f64), 4), np.float32)
    for i, (xmin, ymin, xmax, ymax) in enumerate(boxes_f64):
        xlo, xhi = _round_out(np.float64(xmin), np.float64(xmax))
        ylo, yhi = _round_out(np.float64(ymin), np.float64(ymax))
        outer[i] = (xlo, ylo, xhi, yhi)
        xlo, xhi = _round_in(np.float64(xmin), np.float64(xmax))
        ylo, yhi = _round_in(np.float64(ymin), np.float64(ymax))
        inner[i] = (xlo, ylo, xhi, yhi)
    intervals_ms = list(intervals_ms or [])
    times = np.zeros((len(intervals_ms), 4), np.int32)
    for i, (lo, hi) in enumerate(intervals_ms):
        lo, hi = int(lo), int(hi)
        times[i] = (lo // MILLIS_PER_DAY, lo % MILLIS_PER_DAY,
                    hi // MILLIS_PER_DAY, hi % MILLIS_PER_DAY)
    return ExtentQuery(outer, inner, times)


def extent_tristate(data: ExtentScanData, q: ExtentQuery) -> torch.Tensor:
    """int8[n] on the data's device: 0 OUT, 1 MAYBE (the host's exact
    check), 2 IN. The time test is exact (integer compares), so it never
    makes a row MAYBE."""
    outer, inner, intervals = q.tables(data.bounds.device)
    return kernels.extent_tristate(data.bounds, data.valid, data.times,
                                   outer, inner, intervals)


@dataclasses.dataclass
class PackedPolygon:
    """One (multi)polygon's rings as an edge table on a device.

    edges: (E, 4) f32 [x0 y0 x1 y1], holes included (crossing-number
    parity handles them uniformly), with no padding; ``host`` keeps the
    geometry for the exact band recheck."""
    edges: torch.Tensor
    host: object


def _edges(poly) -> np.ndarray:
    """(E, 4) f64 edges of a Polygon/MultiPolygon's rings."""
    rings: list[np.ndarray] = []
    for p in getattr(poly, "parts", [poly]):
        rings.append(np.asarray(p.shell, np.float64))
        for h in getattr(p, "holes", []):
            rings.append(np.asarray(h, np.float64))
    segs = []
    for ring in rings:
        a = ring[:-1] if np.allclose(ring[0], ring[-1]) else ring
        segs.append(np.concatenate([a, np.roll(a, -1, axis=0)], axis=1))
    return np.concatenate(segs, axis=0) if segs else np.zeros((0, 4))


def pack_polygon(poly, device) -> PackedPolygon:
    """Pack a Polygon/MultiPolygon's rings into an f32 edge table."""
    edges = np.ascontiguousarray(_edges(poly).astype(np.float32))
    return PackedPolygon(torch.from_numpy(edges).to(device), poly)


def packed_polygon_from_numpy(edges: np.ndarray, edge_valid: np.ndarray,
                              host, device) -> PackedPolygon:
    """A PackedPolygon from an edge buffer fetched as numpy (e.g. the JAX
    package's padded (E, 4) f32 edges and their validity), keeping the
    valid edges as they are."""
    e = np.ascontiguousarray(np.asarray(edges, np.float32)[
        np.asarray(edge_valid, bool)])
    return PackedPolygon(torch.from_numpy(e).to(device), host)


def pip_points(px: np.ndarray, py: np.ndarray):
    """The kernel's f32 points: f64 coordinates rounded to nearest (not
    the round-down hi words of the scan columns, which are other
    points)."""
    return (np.asarray(px, np.float64).astype(np.float32),
            np.asarray(py, np.float64).astype(np.float32))


def points_in_polygon_device(px: np.ndarray, py: np.ndarray,
                             packed: PackedPolygon
                             ) -> tuple[np.ndarray, np.ndarray]:
    """The kernel over host f64 points; returns (inside, band_idx).

    ``inside`` is right except at the rows ``band_idx`` (within
    EDGE_EPS of an edge), which the caller re-evaluates with its exact
    host predicate (so open/closed boundary semantics are the caller's).
    """
    dev = packed.edges.device
    px32, py32 = (torch.from_numpy(a).to(dev) for a in pip_points(px, py))
    inside, band = kernels.pip_mask(px32, py32, packed.edges, EDGE_EPS2)
    return inside.cpu().numpy(), np.flatnonzero(band.cpu().numpy())


def points_in_polygon(px: np.ndarray, py: np.ndarray, poly,
                      device) -> np.ndarray:
    """Exact closed-boundary point-in-polygon: the kernel, then the host
    float64 recheck of the band rows (contains_points semantics)."""
    inside, band_idx = points_in_polygon_device(
        px, py, pack_polygon(poly, device))
    if len(band_idx):
        inside[band_idx] = contains_points(poly, np.asarray(px)[band_idx],
                                           np.asarray(py)[band_idx])
    return inside
