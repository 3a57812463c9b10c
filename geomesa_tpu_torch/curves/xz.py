"""XZ-ordering curves for geometries with spatial extent (XZ2 / XZ3).

Implements Böhm, Klump & Kriegel's 'XZ-Ordering: A Space-Filling Curve
for Objects with Spatial Extension', matching the reference's semantics
(geomesa-z3/.../curve/XZ2SFC.scala:24, XZ3SFC.scala:26):

- an object is indexed by its bounding box: the sequence-code *length*
  is chosen so an "enlarged" (2x) quad/oct cell covers the box
  (XZ2SFC.scala:55-80), then the cell's lower-left corner path encodes
  as an integer sequence code (Definition 2; XZ2SFC.scala:263-286).
- query ranges BFS the quad/oct tree, testing each *extended* element
  (upper bounds grown by one side length) against the query windows;
  contained elements emit their whole subtree interval (Lemma 3),
  partial elements emit a single code and recurse (XZ2SFC.scala:146-252).

Generic over dims: dims=2 => quadtree (base 4), dims=3 => octree (base 8).
``index`` is vectorized over numpy arrays of boxes (one g-step loop,
vectorized across elements); ``ranges`` is a vectorized level-wise BFS.
Sequence codes fit comfortably in int64 for the default g=12
(XZSFC.DefaultPrecision, XZSFC.scala:13).
"""

from __future__ import annotations

import numpy as np

from .timebin import TimePeriod, max_offset
from .zranges import DEFAULT_MAX_RANGES, merge_ranges

__all__ = ["XZSFC", "XZ2SFC", "XZ3SFC", "xz2sfc", "xz3sfc", "DEFAULT_G"]

DEFAULT_G = 12  # XZSFC.DefaultPrecision


class XZSFC:
    """Generic N-dimensional XZ curve over user-space bounds."""

    def __init__(self, g: int, bounds: list[tuple[float, float]]):
        if not (0 < g < 20):
            raise ValueError("g must be in (0, 20) to keep codes in int64")
        self.g = int(g)
        self.dims = len(bounds)
        self.base = 2 ** self.dims
        self.lo = np.array([b[0] for b in bounds], dtype=np.float64)
        self.hi = np.array([b[1] for b in bounds], dtype=np.float64)
        self.size = self.hi - self.lo
        # subtree_size[l] = (base^(g-l) - 1) / (base - 1): the number of
        # codes in a full subtree below a level-l cell (Lemma 3 term)
        p = np.arange(self.g + 2, dtype=np.int64)
        self._subtree = ((self.base ** np.maximum(self.g - p + 1, 0) - 1)
                         // (self.base - 1)).astype(np.int64)
        # step_size[i] = (base^(g-i) - 1)/(base-1), used in the code sum
        self._step = ((self.base ** (self.g - np.arange(self.g, dtype=np.int64)) - 1)
                      // (self.base - 1)).astype(np.int64)

    # -- normalization ----------------------------------------------------

    def _normalize(self, mins, maxs, lenient: bool):
        """User space box corners -> [0,1]^dims. mins/maxs: (dims, n)."""
        mins = np.asarray(mins, dtype=np.float64).reshape(self.dims, -1)
        maxs = np.asarray(maxs, dtype=np.float64).reshape(self.dims, -1)
        if bool(np.any(mins > maxs)):
            raise ValueError("bounds must be ordered (min <= max)")
        lo, hi = self.lo[:, None], self.hi[:, None]
        if lenient:
            mins = np.clip(mins, lo, hi)
            maxs = np.clip(maxs, lo, hi)
        elif bool(np.any((mins < lo) | (maxs > hi))):
            raise ValueError("value(s) out of bounds for xz index")
        size = self.size[:, None]
        return (mins - lo) / size, (maxs - lo) / size

    # -- indexing ---------------------------------------------------------

    def index(self, mins, maxs, lenient: bool = False) -> np.ndarray:
        """Vectorized: box corners (dims, n) or per-dim scalars -> codes (n,).

        Mirrors XZ2SFC.index (XZ2SFC.scala:55-80): pick the sequence
        length from the box extent, then encode the min corner.
        """
        nmin, nmax = self._normalize(mins, maxs, lenient)
        n = nmin.shape[1]

        max_dim = np.max(nmax - nmin, axis=0)
        with np.errstate(divide="ignore"):
            # maxDim == 0 (points) -> l1 = +inf -> clamps to g
            l1 = np.floor(np.log(max_dim) / np.log(0.5))
        l1 = np.where(np.isfinite(l1), l1, self.g).astype(np.int64)
        l1 = np.minimum(l1, self.g)

        w2 = np.power(0.5, (l1 + 1).astype(np.float64))  # width at l1+1
        fits = np.ones(n, dtype=bool)
        for d in range(self.dims):
            cell_start = np.floor(nmin[d] / w2) * w2
            fits &= nmax[d] <= cell_start + 2 * w2
        length = np.where(l1 >= self.g, self.g, np.where(fits, l1 + 1, l1))

        return self._sequence_code(nmin, length)

    def _sequence_code(self, corner: np.ndarray, length) -> np.ndarray:
        """Vectorized Definition-2 sequence code of point `corner` (dims, n)
        with per-element code `length`."""
        length = np.broadcast_to(np.asarray(length, dtype=np.int64),
                                 corner.shape[1:])
        lo = np.zeros_like(corner)
        hi = np.ones_like(corner)
        cs = np.zeros(corner.shape[1], dtype=np.int64)
        for i in range(self.g):
            active = i < length
            center = (lo + hi) * 0.5
            ge = corner >= center            # (dims, n) bools
            q = np.zeros(corner.shape[1], dtype=np.int64)
            for d in range(self.dims):
                q += ge[d].astype(np.int64) << d
            cs = np.where(active, cs + 1 + q * self._step[i], cs)
            hi = np.where(ge, hi, center)
            lo = np.where(ge, center, lo)
        return cs

    # -- query ranges -----------------------------------------------------

    def ranges(self, windows, max_ranges: int | None = None) -> np.ndarray:
        """Covering sequence-code ranges for OR'd query windows.

        windows: iterable of (mins..., maxs...) user-space tuples, e.g.
        (xmin, ymin, xmax, ymax) for dims=2 (same layout as the
        reference's ranges()). Returns int64 [n, 3]: [lo, hi, contained]
        where contained=1 means every object in the range genuinely
        intersects the window (no exact-geometry recheck needed).
        """
        if max_ranges is None:
            # practical reference usage always passes SCAN_RANGES_TARGET
            # (XZ2IndexKeySpace.scala:71); an unlimited 3-D BFS explodes
            # (boundary-surface cells grow 4x per level)
            max_ranges = DEFAULT_MAX_RANGES
        wins = []
        for w in windows:
            mins = np.array(w[:self.dims], dtype=np.float64)
            maxs = np.array(w[self.dims:], dtype=np.float64)
            nmin, nmax = self._normalize(mins[:, None], maxs[:, None], False)
            wins.append((nmin[:, 0], nmax[:, 0]))
        if not wins:
            return np.empty((0, 3), dtype=np.int64)
        wmin = np.stack([w[0] for w in wins], axis=1)  # (dims, nw)
        wmax = np.stack([w[1] for w in wins], axis=1)

        # note: sequence code 0 (length-0 code) is unreachable — at l1=0
        # the level-1 fit predicate always passes, so codes start at 1;
        # large geometries are covered via the partial single codes the
        # BFS emits along its path.
        out_lo: list[np.ndarray] = []
        out_hi: list[np.ndarray] = []
        out_cont: list[np.ndarray] = []

        # frontier: integer cell coords at the current level, (dims, n)
        frontier = np.zeros((self.dims, 1), dtype=np.int64)
        codes = np.zeros(1, dtype=np.int64)  # seq code of each frontier cell
        # descend: children of the root are level 1
        frontier, codes = self._children(frontier, codes, 0)
        level = 1
        n_emitted = 0

        while frontier.shape[1] > 0:
            w = 0.5 ** level
            cell_lo = frontier * w                        # (dims, n)
            cell_ext = (frontier + 2) * w                 # extended upper bound
            # test each cell against each window: (dims, n, nw)
            contained = ((wmin[:, None, :] <= cell_lo[:, :, None])
                         & (wmax[:, None, :] >= cell_ext[:, :, None])).all(axis=0).any(axis=1)
            overlapped = ((wmax[:, None, :] >= cell_lo[:, :, None])
                          & (wmin[:, None, :] <= cell_ext[:, :, None])).all(axis=0).any(axis=1)
            partial = overlapped & ~contained

            if contained.any():
                c = codes[contained]
                out_lo.append(c)
                out_hi.append(c + self._subtree[level])
                out_cont.append(np.ones(len(c), dtype=np.int64))
                n_emitted += len(c)

            if not partial.any():
                break

            if level >= self.g or n_emitted + int(partial.sum()) > max_ranges:
                # bottom out: emit whole subtree intervals for partials
                # (XZ2SFC.scala:221-231), flagged as not-contained
                c = codes[partial]
                out_lo.append(c)
                out_hi.append(c + self._subtree[level])
                out_cont.append(np.zeros(len(c), dtype=np.int64))
                break

            # partial cells emit their single code and recurse
            c = codes[partial]
            out_lo.append(c)
            out_hi.append(c.copy())
            out_cont.append(np.zeros(len(c), dtype=np.int64))
            n_emitted += len(c)
            frontier, codes = self._children(frontier[:, partial], c, level)
            level += 1

        if not out_lo:
            return np.empty((0, 3), dtype=np.int64)
        stacked = np.stack([np.concatenate(out_lo), np.concatenate(out_hi),
                            np.concatenate(out_cont)], axis=1)
        return merge_ranges(stacked)

    def _children(self, frontier: np.ndarray, codes: np.ndarray, level: int):
        """All 2^dims children of each frontier cell, with their codes.

        A child with per-dim high-bits q enters at level+1; its code is
        parent + 1 + q * step[level] (sequenceCode's i=level term).
        """
        n = frontier.shape[1]
        offsets = np.indices((2,) * self.dims).reshape(self.dims, -1)  # (dims, base)
        child = (frontier[:, :, None] * 2 + offsets[:, None, :]).reshape(self.dims, -1)
        q = np.zeros(self.base, dtype=np.int64)
        for d in range(self.dims):
            q += offsets[d].astype(np.int64) << d
        ccodes = (codes[:, None] + 1 + q[None, :] * self._step[level]).reshape(-1)
        return child, ccodes


class XZ2SFC(XZSFC):
    """2-D XZ curve over lon/lat (XZ2SFC.scala:24)."""

    def __init__(self, g: int = DEFAULT_G):
        super().__init__(g, [(-180.0, 180.0), (-90.0, 90.0)])

    def index_boxes(self, xmin, ymin, xmax, ymax, lenient: bool = False):
        return self.index(np.stack([np.atleast_1d(np.asarray(xmin, np.float64)),
                                    np.atleast_1d(np.asarray(ymin, np.float64))]),
                          np.stack([np.atleast_1d(np.asarray(xmax, np.float64)),
                                    np.atleast_1d(np.asarray(ymax, np.float64))]),
                          lenient)


class XZ3SFC(XZSFC):
    """3-D XZ curve over lon/lat/time-offset (XZ3SFC.scala:26)."""

    def __init__(self, g: int = DEFAULT_G,
                 period: TimePeriod | str = TimePeriod.WEEK):
        period = TimePeriod.parse(period)
        self.period = period
        super().__init__(g, [(-180.0, 180.0), (-90.0, 90.0),
                             (0.0, float(max_offset(period)))])

    def index_boxes(self, xmin, ymin, tmin, xmax, ymax, tmax,
                    lenient: bool = False):
        mk = lambda *a: np.stack([np.atleast_1d(np.asarray(v, np.float64)) for v in a])
        return self.index(mk(xmin, ymin, tmin), mk(xmax, ymax, tmax), lenient)


_XZ2_CACHE: dict[int, XZ2SFC] = {}
_XZ3_CACHE: dict[tuple[int, TimePeriod], XZ3SFC] = {}


def xz2sfc(g: int = DEFAULT_G) -> XZ2SFC:
    if g not in _XZ2_CACHE:
        _XZ2_CACHE[g] = XZ2SFC(g)
    return _XZ2_CACHE[g]


def xz3sfc(g: int = DEFAULT_G, period: TimePeriod | str = TimePeriod.WEEK) -> XZ3SFC:
    key = (g, TimePeriod.parse(period))
    if key not in _XZ3_CACHE:
        _XZ3_CACHE[key] = XZ3SFC(g, period)
    return _XZ3_CACHE[key]
