"""GeoHash: base-32 spatial hashing + spiral KNN iteration.

Analog of the reference's geohash package (geomesa-utils/.../geohash/
GeoHash.scala:25,101 — encode/decode at arbitrary bit precision;
GeohashUtils; iterators) and the KNN process machinery
(geomesa-process/.../knn/GeoHashSpiral.scala:53,80 — a priority queue of
geohash cells ordered by distance to the query point, with touching-cell
expansion; NearestNeighbors bounded PQ).

Encoding is vectorized over numpy: a geohash is the bit-interleave of
normalized lon (even bits, from the top) and lat (odd bits), rendered
base-32. Reuses the Z2 bit-spreading of the port's own curves/zorder.py
— a geohash IS a z-order prefix with lon first. Host numpy: the spiral's
cells reach the card only as the BBOX queries a caller runs per cell.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from ..curves.zorder import z2_split

__all__ = ["GeoHash", "encode", "decode_bbox", "decode", "neighbors",
           "covering", "GeoHashSpiral", "BoundedNearestNeighbors",
           "precision_for_radius"]

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_DECODE32 = {c: i for i, c in enumerate(_BASE32)}


def encode(lon, lat, precision: int = 9):
    """Vectorized geohash of `precision` base-32 chars (5 bits each).

    GeoHash.scala builds the same lon-first interleave; here both
    coordinate arrays normalize to 30-bit ints, z-interleave via the
    shared bit-spread kernel, and the top 5*precision bits render as
    base-32 strings.
    """
    bits = 5 * precision
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    scalar = lon.ndim == 0
    nx = np.clip(((lon + 180.0) / 360.0 * (1 << 30)).astype(np.uint64),
                 0, (1 << 30) - 1)
    ny = np.clip(((lat + 90.0) / 180.0 * (1 << 30)).astype(np.uint64),
                 0, (1 << 30) - 1)
    # lon occupies the even bit positions counting from the top
    z = (z2_split(nx) << np.uint64(1)) | z2_split(ny)  # 60 bits, lon first
    z >>= np.uint64(60 - bits)
    codes = np.zeros(z.shape + (precision,), dtype=np.uint8)
    for i in range(precision):
        shift = np.uint64(5 * (precision - 1 - i))
        codes[..., i] = ((z >> shift) & np.uint64(31)).astype(np.uint8)
    lut = np.frombuffer(_BASE32.encode(), dtype=np.uint8)
    chars = lut[codes]
    out = chars.view(f"S{precision}").reshape(z.shape).astype(str)
    return str(out[()]) if scalar else out


def _to_bits(gh: str) -> tuple[int, int]:
    """geohash string -> (value, nbits)."""
    v = 0
    for c in gh:
        v = (v << 5) | _DECODE32[c.lower()]
    return v, 5 * len(gh)


def _deinterleave(v: int, nbits: int) -> tuple[int, int, int, int]:
    """(lon_bits, lat_bits, n_lon, n_lat) from a lon-first interleave."""
    lon = lat = 0
    n_lon = n_lat = 0
    for i in range(nbits):
        bit = (v >> (nbits - 1 - i)) & 1
        if i % 2 == 0:
            lon = (lon << 1) | bit
            n_lon += 1
        else:
            lat = (lat << 1) | bit
            n_lat += 1
    return lon, lat, n_lon, n_lat


def decode_bbox(gh: str,
                bits: int | None = None) -> tuple[float, float, float,
                                                  float]:
    """(xmin, ymin, xmax, ymax) of a geohash cell. ``bits`` truncates
    to the leading bit precision (the reference's arbitrary-bit
    GeoHash cells — base-32 rendering always carries a 5-bit multiple,
    the cell itself need not)."""
    v, nbits = _to_bits(gh)
    if bits is not None and 0 < bits < nbits:
        v >>= nbits - bits
        nbits = bits
    lon, lat, n_lon, n_lat = _deinterleave(v, nbits)
    wx = 360.0 / (1 << n_lon)
    wy = 180.0 / (1 << n_lat) if n_lat else 180.0
    xmin = -180.0 + lon * wx
    ymin = -90.0 + lat * wy
    return xmin, ymin, xmin + wx, ymin + wy


def decode(gh: str) -> tuple[float, float]:
    """Cell-center (lon, lat)."""
    xmin, ymin, xmax, ymax = decode_bbox(gh)
    return (xmin + xmax) / 2, (ymin + ymax) / 2


@dataclasses.dataclass(frozen=True)
class GeoHash:
    """A geohash cell (string + derived bbox)."""
    hash: str

    @property
    def bbox(self) -> tuple[float, float, float, float]:
        return decode_bbox(self.hash)

    @property
    def center(self) -> tuple[float, float]:
        return decode(self.hash)

    @property
    def precision(self) -> int:
        return len(self.hash)


def neighbors(gh: str) -> list[str]:
    """The up-to-8 touching cells at the same precision (antimeridian
    wraps in lon; poles clip in lat)."""
    xmin, ymin, xmax, ymax = decode_bbox(gh)
    cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
    wx, wy = xmax - xmin, ymax - ymin
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            ny = cy + dy * wy
            if ny <= -90.0 or ny >= 90.0:
                continue
            nx = cx + dx * wx
            if nx < -180.0:
                nx += 360.0
            elif nx > 180.0:
                nx -= 360.0
            out.append(encode(nx, ny, len(gh)))
    # dedupe preserving order (wraps can collide at coarse precision)
    seen: set = set()
    uniq = []
    for h in out:
        if h not in seen and h != gh:
            seen.add(h)
            uniq.append(h)
    return uniq


def covering(xmin: float, ymin: float, xmax: float, ymax: float,
             precision: int, max_cells: int = 4096) -> list[str]:
    """All geohash cells at `precision` intersecting the bbox
    (GeohashUtils.getGeohashesContainedByEnvelope-style enumeration)."""
    wx = 360.0 / (1 << math.ceil(5 * precision / 2))
    wy = 180.0 / (1 << (5 * precision // 2))
    eps = 1e-12
    # sample at the global grid's cell centers so boundary cells aren't
    # skipped when the bbox edge sits near a cell edge
    x0 = math.floor((xmin + 180.0) / wx) * wx - 180.0
    y0 = math.floor((ymin + 90.0) / wy) * wy - 90.0
    xs = np.arange(x0 + wx / 2, xmax + wx / 2 + eps, wx)
    ys = np.arange(y0 + wy / 2, ymax + wy / 2 + eps, wy)
    xs = np.clip(xs, -180 + eps, 180 - eps)
    ys = np.clip(ys, -90 + eps, 90 - eps)
    if len(xs) * len(ys) > max_cells:
        raise ValueError(f"bbox needs {len(xs) * len(ys)} cells at "
                         f"precision {precision} (max {max_cells})")
    gx, gy = np.meshgrid(xs, ys)
    cells = encode(gx.ravel(), gy.ravel(), precision)
    return sorted(set(cells.tolist()))


def precision_for_radius(radius_deg: float) -> int:
    """Smallest precision whose cell width is >= radius (the spiral's
    auto-sizing, GeoHashSpiral.scala — cells comparable to the search
    radius keep the PQ small)."""
    for p in range(9, 0, -1):
        wx = 360.0 / (1 << math.ceil(5 * p / 2))
        if wx >= radius_deg:
            return p
    return 1


def _dist2_to_bbox(x: float, y: float,
                   bbox: tuple[float, float, float, float]) -> float:
    dx = max(bbox[0] - x, 0.0, x - bbox[2])
    dy = max(bbox[1] - y, 0.0, y - bbox[3])
    return dx * dx + dy * dy


class GeoHashSpiral:
    """Iterate geohash cells outward from a point in distance order
    (knn/GeoHashSpiral.scala:53,80): a PQ keyed by min-distance from the
    query point to the cell, seeded with the containing cell, expanding
    through touching neighbors. ``update_max_distance`` prunes cells
    beyond the current kth-neighbor distance (PQ cut-off)."""

    def __init__(self, x: float, y: float, precision: int):
        self.x, self.y = x, y
        self.precision = precision
        seed = encode(x, y, precision)
        self._pq: list[tuple[float, str]] = [(0.0, seed)]
        self._seen = {seed}
        self._max_d2 = math.inf

    def update_max_distance(self, d: float):
        self._max_d2 = min(self._max_d2, d * d)

    def __iter__(self):
        return self

    def __next__(self) -> str:
        while self._pq:
            d2, gh = heapq.heappop(self._pq)
            if d2 > self._max_d2:
                break
            for nb in neighbors(gh):
                if nb not in self._seen:
                    self._seen.add(nb)
                    nd2 = _dist2_to_bbox(self.x, self.y, decode_bbox(nb))
                    if nd2 <= self._max_d2:
                        heapq.heappush(self._pq, (nd2, nb))
            return gh
        raise StopIteration


class BoundedNearestNeighbors:
    """Bounded max-heap of (distance, id) pairs (knn/NearestNeighbors)."""

    def __init__(self, k: int):
        self.k = k
        self._heap: list[tuple[float, object]] = []  # (-dist, id)

    def offer(self, dist: float, item):
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, (-dist, item))
        elif dist < -self._heap[0][0]:
            heapq.heapreplace(self._heap, (-dist, item))

    @property
    def max_distance(self) -> float:
        return -self._heap[0][0] if len(self._heap) == self.k else math.inf

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.k

    def result(self) -> list[tuple[float, object]]:
        return sorted((-d, i) for d, i in self._heap)
