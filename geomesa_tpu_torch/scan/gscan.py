"""Device point-in-polygon (the JAX package's scan/gscan.py, its
point-in-polygon part).

A crossing-number test of points against a polygon's packed edges (the
``pip_mask`` kernel, csrc/geom.cu), with an uncertainty band: points
within EDGE_EPS of an edge, where the float32 verdict cannot be
trusted, are re-checked exactly in float64 on the host. That makes the
exact INTERSECTS/WITHIN residual of a point schema exact while the
inner loop runs on the device. The extent tristate of that module
(``_tristate_body``) belongs to the extent (XZ) slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analytics.st_functions import contains_points
from . import kernels

__all__ = ["EDGE_EPS", "EDGE_EPS2", "PackedPolygon", "pack_polygon",
           "packed_polygon_from_numpy", "pip_points",
           "points_in_polygon_device", "points_in_polygon"]

# uncertainty half-band (degrees) of the f32 point-in-polygon kernel;
# ~11 m at the equator, generous against the f32 ulp (~1.5e-5 deg at
# lon 180)
EDGE_EPS = 1e-4
EDGE_EPS2 = float(np.float32(EDGE_EPS * EDGE_EPS))


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
