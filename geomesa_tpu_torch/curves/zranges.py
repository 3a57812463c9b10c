"""Z-range decomposition: query box -> list of contiguous z-key ranges.

Equivalent in coverage to sfcurve's ``zranges`` divide-and-conquer (used
by the reference at Z3SFC.scala:54-62 / Z2SFC.scala via ``Z3.zranges``):
decompose an axis-aligned box in normalized integer space into at most
``max_ranges`` inclusive ``[zlo, zhi]`` intervals whose union covers every
z key inside the box (over-approximation is allowed and expected — an
exact filter always runs downstream).

Implementation is a level-by-level BFS over z-prefix cells: at level L
each cell is a 2^dims-ary hypercube of side 2^(maxbits-L);
fully-contained cells emit their whole z interval, partially-overlapping
cells split. ``zranges`` runs it in the native library
(``native/src/zrange.cpp``); ``zranges_plain`` is its numpy twin, every
cell test of a level one array op, and gives the same ranges bit for
bit.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import native
from . import zorder

__all__ = ["zranges", "zranges_plain", "merge_ranges", "DEFAULT_MAX_RANGES"]

# the reference's `geomesa.scan.ranges.target` default (QueryProperties.scala:18)
DEFAULT_MAX_RANGES = 2000


def merge_ranges(ranges: np.ndarray) -> np.ndarray:
    """Sort and coalesce overlapping/adjacent inclusive [lo, hi] ranges.
    A third column, where there is one, is a flag AND-ed across the merged
    ranges (the XZ curves' 'contained' flag, XZ2SFC.scala:236-252)."""
    if len(ranges) == 0:
        return ranges.reshape(0, ranges.shape[1] if ranges.ndim == 2 else 2)
    ranges = ranges[np.argsort(ranges[:, 0], kind="stable")]
    los, his = ranges[:, 0], ranges[:, 1]
    # a range starts a new group if its lo > running max(hi)+1 of all before
    # it; at each group's last element the running max equals the group max
    running = np.maximum.accumulate(his)
    new_group = np.empty(len(ranges), dtype=bool)
    new_group[0] = True
    # subtract instead of `running + 1`: hi can be 2^63-1 (full z3
    # domain) and +1 would wrap; z keys are >= 0 so the difference fits
    new_group[1:] = los[1:] - running[:-1] > 1
    last = np.empty(len(ranges), dtype=bool)
    last[-1] = True
    last[:-1] = new_group[1:]
    out = np.stack([los[new_group], running[last]], axis=1)
    if ranges.shape[1] > 2:
        group = np.cumsum(new_group) - 1
        flags = np.ones(len(out), dtype=ranges.dtype)
        np.minimum.at(flags, group, ranges[:, 2])
        out = np.concatenate([out, flags[:, None]], axis=1)
    return out


def _interleave(coords: np.ndarray, dims: int) -> np.ndarray:
    """Interleave per-dim int arrays (coords[d] gets bit offset d)."""
    if dims == 2:
        return zorder.z2_encode(coords[0], coords[1]).astype(np.int64)
    if dims == 3:
        return zorder.z3_encode(coords[0], coords[1], coords[2]).astype(np.int64)
    raise ValueError(f"unsupported dims: {dims}")


# the native output buffer, reused per thread: concurrent store queries
# must not write into one buffer
_scratch = threading.local()


def zranges(lows, highs, max_bits: int, *, precision: int = 64,
            max_ranges: int | None = None) -> np.ndarray:
    """``zranges_plain``'s decomposition, run by the native library."""
    lows = np.ascontiguousarray(lows, dtype=np.int64)
    highs = np.ascontiguousarray(highs, dtype=np.int64)
    dims = len(lows)
    if max_ranges is None:
        max_ranges = DEFAULT_MAX_RANGES
    max_level = min(max_bits, max(1, precision // dims))
    if np.any(highs < lows):
        return np.empty((0, 2), dtype=np.int64)
    if dims not in (2, 3) or len(highs) != dims:
        raise ValueError(f"unsupported dims: {dims}")
    lib = native.library()
    # the budget lets the last level's partial cells through, so at most
    # about 2 * max_ranges ranges come out; a larger buffer is a retry
    cap = 4 * int(max_ranges) + 64
    while True:
        out = getattr(_scratch, "buf", None)
        if out is None or len(out) < cap:
            out = _scratch.buf = np.empty((cap, 2), dtype=np.int64)
        n = lib.geomesa_zranges(
            native.ptr(lows, native.I64P), native.ptr(highs, native.I64P),
            dims, max_bits, max_level, int(max_ranges),
            native.ptr(out, native.I64P), len(out))
        if n >= 0:
            return out[:n].copy()
        cap = 4 * len(out)


def zranges_plain(lows, highs, max_bits: int, *, precision: int = 64,
                  max_ranges: int | None = None) -> np.ndarray:
    """Decompose box [lows[d], highs[d]] (inclusive, normalized-int space)
    into covering z ranges.

    Args:
      lows / highs: per-dimension inclusive int bounds (len = dims).
      max_bits: bits per dimension (21 for z3, 31 for z2).
      precision: total z bits to recurse to (sfcurve arg); max recursion
        level is ``precision // dims``.
      max_ranges: soft cap on the number of returned ranges; when the BFS
        frontier would exceed it, remaining partial cells emit covering
        ranges. ``None`` -> DEFAULT_MAX_RANGES.

    Returns: int64 array [n, 2] of inclusive [zlo, zhi], sorted + merged.
    """
    lows = np.asarray(lows, dtype=np.int64)
    highs = np.asarray(highs, dtype=np.int64)
    dims = len(lows)
    if max_ranges is None:
        max_ranges = DEFAULT_MAX_RANGES
    max_level = min(max_bits, max(1, precision // dims))
    if np.any(highs < lows):
        return np.empty((0, 2), dtype=np.int64)

    # BFS frontier: cell origin coords in units of current cell size,
    # shape (dims, ncells). Start from the root cell.
    frontier = np.zeros((dims, 1), dtype=np.int64)
    emitted: list[np.ndarray] = []

    for level in range(0, max_level + 1):
        if frontier.shape[1] == 0:
            break
        shift = max_bits - level           # log2(cell side)
        side = np.int64(1) << shift
        cell_lo = frontier * side                  # (dims, n) inclusive
        cell_hi = cell_lo + (side - 1)
        lo_b = lows[:, None]
        hi_b = highs[:, None]
        disjoint = ((cell_hi < lo_b) | (cell_lo > hi_b)).any(axis=0)
        contained = ((cell_lo >= lo_b) & (cell_hi <= hi_b)).all(axis=0)
        partial = ~(disjoint | contained)

        def cell_ranges(mask):
            zlo = _interleave(frontier[:, mask] * side, dims)
            # python-int arithmetic: (1 << 63) - 1 still fits int64, but
            # computing it in int64 would overflow mid-expression
            span = np.int64((1 << (dims * shift)) - 1)
            return np.stack([zlo, zlo + span], axis=1)

        if contained.any():
            emitted.append(cell_ranges(contained))

        n_partial = int(partial.sum())
        if n_partial == 0:
            break
        budget_blown = (sum(len(e) for e in emitted)
                        + n_partial * (2 ** dims) > max_ranges)
        if level == max_level or budget_blown:
            emitted.append(cell_ranges(partial))
            break
        # split each partial cell into its 2^dims children
        children = frontier[:, partial] * 2            # (dims, n)
        offsets = np.indices((2,) * dims).reshape(dims, -1)  # (dims, 2^dims)
        frontier = (children[:, :, None] + offsets[:, None, :]).reshape(dims, -1)

    if not emitted:
        return np.empty((0, 2), dtype=np.int64)
    return merge_ranges(np.concatenate(emitted, axis=0))
