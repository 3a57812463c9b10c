"""Z-prefix range partitioning: which shard group owns a feature.

The reference scales by splitting the z-ordered keyspace into tablets
and assigning tablet ranges to region servers (PAPER.md L4 splitter;
``GeoMesaFeatureIndex.getSplits`` precomputes the split points from the
curve). The cluster tier does the same thing one level up: the 62-bit
z2 keyspace is range-partitioned by its top ``PREFIX_BITS`` bits into
a sorted list of *segments* — half-open prefix ranges, each owned by
one group — and a feature belongs to the group whose segment covers
its z-prefix.

Properties the coordinator relies on:

- **deterministic**: ownership is a pure function of (geometry,
  topology) — any client holding the same epoch computes the same
  routing with no metadata service.
- **disjoint + covering**: every prefix has exactly one owner, so
  scatter-gather merges are exact set unions (no dedup pass).
- **range-shaped**: a group's ownership is a short list of contiguous
  z ranges, so a down group's *missing data* is describable to callers
  as explicit z-ranges (the partial-results contract) and shard
  split/migration is a range handoff.
- **versioned**: the boundary list is stamped with an ``epoch``;
  instances are immutable, and a reshard builds the successor topology
  with ``with_move`` (epoch + 1) so the coordinator's flip is a single
  reference swap and a plan or result can name the topology it was
  computed under.

The default topology (epoch 0) is the uniform ceil-div split — group
``g`` owns ``[ceil(g*P/n), ceil((g+1)*P/n))`` — which routes
bit-identically to the pre-reshard partitioner, so the
``geomesa.reshard.enabled=false`` kill switch restores old behavior
exactly.

Features without a usable geometry (no geom field, or a null geometry,
which normalizes to bin 0 deterministically) route by a stable hash of
the feature id — NOT ``hash()``, which is per-process salted. Id-hash
routing depends only on ``n_groups`` (fixed across resharding), so
geometry-less rows never move in a boundary flip.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..curves import zorder
from ..curves.sfc import Z2SFC

__all__ = ["ZPrefixPartitioner", "PREFIX_BITS"]

# top bits of the z2 key that drive ownership: 16 bits = 65536 split
# points, plenty of resolution for any realistic group count while
# keeping range descriptions human-readable
PREFIX_BITS = 16

_Z2_BITS = 2 * zorder.Z2_BITS          # 62-bit z2 keys
_SHIFT = np.uint64(_Z2_BITS - PREFIX_BITS)
_N_PREFIXES = 1 << PREFIX_BITS


def _uniform_segments(n_groups: int) -> tuple[list[int], list[int]]:
    """The epoch-0 ceil-div boundary list: group ``g`` starts at
    ``ceil(g*P/n)`` (zero-width groups dropped — only possible when
    ``n_groups`` exceeds the prefix space)."""
    starts, owners = [], []
    for g in range(n_groups):
        lo = -(-g * _N_PREFIXES // n_groups)          # ceil div
        hi = -(-(g + 1) * _N_PREFIXES // n_groups)
        if hi > lo:
            starts.append(lo)
            owners.append(g)
    return starts, owners


class ZPrefixPartitioner:
    """Range-partition the z2 prefix space across ``n_groups``.

    ``ZPrefixPartitioner(n)`` builds the uniform epoch-0 topology;
    ``with_move`` derives a successor with an arbitrary prefix range
    reassigned (epoch + 1). Instances are immutable — the coordinator
    flips topology by swapping the partitioner reference.
    """

    def __init__(self, n_groups: int, starts=None, owners=None,
                 epoch: int = 0):
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        self.n_groups = int(n_groups)
        self._sfc = Z2SFC()
        if starts is None:
            starts, owners = _uniform_segments(self.n_groups)
        s = np.asarray(list(starts), dtype=np.int64)
        o = np.asarray(list(owners), dtype=np.int64)
        if len(s) != len(o) or not len(s):
            raise ValueError("starts/owners must be same nonzero length")
        if s[0] != 0:
            raise ValueError("first segment must start at prefix 0")
        if len(s) > 1 and not bool(np.all(np.diff(s) > 0)):
            raise ValueError("segment starts must strictly increase")
        if bool(np.any((o < 0) | (o >= self.n_groups))):
            raise ValueError("segment owner out of range")
        if s[-1] >= _N_PREFIXES:
            raise ValueError("segment start beyond prefix space")
        self._starts = s
        self._owners = o
        self.epoch = int(epoch)
        u_starts, u_owners = _uniform_segments(self.n_groups)
        self._uniform = (len(s) == len(u_starts)
                         and bool(np.array_equal(s, u_starts))
                         and bool(np.array_equal(o, u_owners)))

    # -- ownership ---------------------------------------------------------

    def _owners_of_prefixes(self, prefix: np.ndarray) -> np.ndarray:
        if self._uniform:
            # the closed form IS the ceil-div segment lookup
            # (floor(p*n/P) == g iff p in [ceil(gP/n), ceil((g+1)P/n)))
            return (prefix * self.n_groups) >> PREFIX_BITS
        idx = np.searchsorted(self._starts, prefix, side="right") - 1
        return self._owners[idx]

    def owner_of(self, prefix: int) -> int:
        """Owning group of one z prefix."""
        if not 0 <= prefix < _N_PREFIXES:
            raise ValueError(f"prefix {prefix} out of range")
        return int(self._owners_of_prefixes(
            np.asarray([prefix], dtype=np.int64))[0])

    def owners_xy(self, x, y) -> np.ndarray:
        """Owning group index per coordinate pair (vectorized)."""
        z = np.asarray(self._sfc.index(x, y, lenient=True)).astype(np.uint64)
        prefix = (z >> _SHIFT).astype(np.int64)
        return self._owners_of_prefixes(prefix)

    def owners_ids(self, ids) -> np.ndarray:
        """Stable id-hash routing for features without a geometry
        (crc32, not the per-process-salted ``hash()``). Depends only on
        ``n_groups``, never on the boundary list — geometry-less rows
        stay put across reshards."""
        return np.fromiter(
            (zlib.crc32(str(i).encode()) % self.n_groups for i in ids),
            dtype=np.int64, count=len(ids))

    def owners_for_batch(self, sft, batch) -> np.ndarray:
        """Owning group per row of a feature batch: point geometries by
        their coordinates, extent geometries by their bbox centroid,
        geometry-less schemas by id hash."""
        geom = sft.geom_field
        if geom is None:
            return self.owners_ids(batch.ids)
        col = batch.col(geom)
        if hasattr(col, "x"):                      # PointColumn
            return self.owners_xy(np.asarray(col.x, np.float64),
                                  np.asarray(col.y, np.float64))
        bounds = np.asarray(col.bounds, np.float64)  # GeometryColumn
        cx = (bounds[:, 0] + bounds[:, 2]) * 0.5
        cy = (bounds[:, 1] + bounds[:, 3]) * 0.5
        bad = ~np.isfinite(cx) | ~np.isfinite(cy)
        owners = self.owners_xy(np.where(bad, 0.0, cx),
                                np.where(bad, 0.0, cy))
        if bad.any():                               # null geometries
            owners[bad] = self.owners_ids(batch.ids[bad])
        return owners

    # -- topology ----------------------------------------------------------

    def segments(self) -> list[dict]:
        """The full boundary list, in prefix order: one entry per
        contiguous owned range."""
        out = []
        for i in range(len(self._starts)):
            lo = int(self._starts[i])
            hi = (int(self._starts[i + 1]) if i + 1 < len(self._starts)
                  else _N_PREFIXES)
            out.append({"group": int(self._owners[i]),
                        "prefix_lo": lo, "prefix_hi": hi,
                        "z_lo": lo << (_Z2_BITS - PREFIX_BITS),
                        "z_hi": hi << (_Z2_BITS - PREFIX_BITS)})
        return out

    def owned_prefix_ranges(self, group: int) -> list[tuple[int, int]]:
        """Every ``[lo, hi)`` prefix range ``group`` owns (possibly
        empty after its whole range migrated away, possibly several
        after fragmented moves)."""
        if not 0 <= group < self.n_groups:
            raise ValueError(f"group {group} out of range")
        return [(s["prefix_lo"], s["prefix_hi"])
                for s in self.segments() if s["group"] == group]

    def with_move(self, prefix_lo: int, prefix_hi: int,
                  dst_group: int) -> "ZPrefixPartitioner":
        """The successor topology (epoch + 1) with prefixes
        ``[prefix_lo, prefix_hi)`` reassigned to ``dst_group`` —
        adjacent same-owner segments coalesced."""
        if not 0 <= prefix_lo < prefix_hi <= _N_PREFIXES:
            raise ValueError(f"bad prefix range [{prefix_lo}, "
                             f"{prefix_hi})")
        if not 0 <= dst_group < self.n_groups:
            raise ValueError(f"dst group {dst_group} out of range")
        pts = sorted({int(p) for p in self._starts}
                     | {int(prefix_lo), int(prefix_hi)})
        starts, owners = [], []
        for p in pts:
            if p >= _N_PREFIXES:
                continue
            o = (int(dst_group) if prefix_lo <= p < prefix_hi
                 else self.owner_of(p))
            if owners and owners[-1] == o:
                continue                            # coalesce
            starts.append(p)
            owners.append(o)
        return ZPrefixPartitioner(self.n_groups, starts=starts,
                                  owners=owners, epoch=self.epoch + 1)

    # -- range descriptions ------------------------------------------------

    def prefix_range(self, group: int) -> tuple[int, int]:
        """The half-open prefix range ``[lo, hi)`` covering everything
        ``group`` owns — exact when the ownership is one contiguous
        segment (always true at epoch 0), the convex hull when a
        reshard fragmented it, ``(0, 0)`` when the group owns
        nothing."""
        ranges = self.owned_prefix_ranges(group)
        if not ranges:
            return 0, 0
        return ranges[0][0], ranges[-1][1]

    def z_range(self, group: int) -> dict:
        """Human/JSON-facing description of a group's owned z range —
        what a partial result reports as *missing* when the group is
        unreachable. ``prefix_lo``/``prefix_hi`` are the hull (see
        ``prefix_range``); ``ranges`` lists each owned segment exactly
        when the ownership is fragmented."""
        lo, hi = self.prefix_range(group)
        out = {"group": group,
               "prefix_lo": lo, "prefix_hi": hi,
               "z_lo": lo << (_Z2_BITS - PREFIX_BITS),
               "z_hi": hi << (_Z2_BITS - PREFIX_BITS)}
        ranges = self.owned_prefix_ranges(group)
        if len(ranges) != 1:
            out["ranges"] = [
                {"z_lo": a << (_Z2_BITS - PREFIX_BITS),
                 "z_hi": b << (_Z2_BITS - PREFIX_BITS)}
                for a, b in ranges]
        return out

    def describe(self) -> list[dict]:
        return [self.z_range(g) for g in range(self.n_groups)]

    # -- leg pruning ---------------------------------------------------------

    def covering_ranges(self, boxes) -> np.ndarray:
        """Inclusive ``[z_lo, z_hi]`` z2 ranges covering the bbox union
        at prefix granularity (``precision=PREFIX_BITS`` stops the
        covering BFS exactly at the ownership cell size — finer ranges
        cannot change which groups intersect). Boxes clamp to world
        bounds first: the normalizers treat out-of-range lows as caller
        error, and an over-wide query box must still cover."""
        clamped = []
        for (xmin, ymin, xmax, ymax) in boxes:
            clamped.append((max(float(xmin), -180.0),
                            max(float(ymin), -90.0),
                            min(float(xmax), 180.0),
                            min(float(ymax), 90.0)))
        return self._sfc.ranges(clamped, precision=PREFIX_BITS)

    def groups_for_ranges(self, ranges) -> list[int]:
        """Group indices whose owned segments can intersect any of the
        inclusive covering ranges — the legs a scatter must contact;
        every other group provably holds no matching rows (point
        schemas route by the same curve the ranges cover). Intersection
        is per-segment, never against the hull, so a fragmented group
        prunes exactly."""
        r = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
        out: set[int] = set()
        if not len(r):
            return []
        for seg in self.segments():
            if seg["group"] in out:
                continue
            if bool(np.any((r[:, 0] < seg["z_hi"])
                           & (r[:, 1] >= seg["z_lo"]))):
                out.add(seg["group"])
        return sorted(out)
