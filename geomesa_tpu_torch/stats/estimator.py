"""Stats-based selectivity estimation for the cost decider.

Analog of StatsBasedEstimator (index/stats/StatsBasedEstimator.scala:27):
estimate the number of features matching a filter from maintained
sketches -- Count for totals, Z3Histogram for spatio-temporal
selectivity, count-min Frequency sketches of the indexed attributes for
equality selectivity. Host numpy; the estimates equal the JAX
package's on the same writes.
"""

from __future__ import annotations

import numpy as np

from ..curves import timebin, z3sfc
from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import extract_geometries, extract_intervals
from .sketches import CountStat, Frequency, Z3Histogram

__all__ = ["StatsEstimator", "DataStoreStats"]


class StatsEstimator:
    """Wraps maintained sketches; answers estimate_count(filter)."""

    def __init__(self, sft: SimpleFeatureType):
        self.sft = sft
        self.count = CountStat()
        self.z3: Z3Histogram | None = None
        if sft.is_points and sft.dtg_field is not None:
            self.z3 = Z3Histogram(sft.geom_field, sft.dtg_field,
                                  sft.z3_interval)
        # per-INDEXED-attribute count-min sketches, auto-maintained on
        # write: equality selectivity feeds attr-vs-z strategy costs
        # (StatsBasedEstimator.scala:27 composes per-attribute
        # estimates the same way)
        self.attr_freq: dict[str, Frequency] = {}
        # box-tuple -> coarse-cell indices (see _cells_for_boxes)
        self._cells_cache: dict[tuple, np.ndarray] = {}
        # lazily-built per-cell spatial bounds (see _cell_bounds)
        self._cell_bounds_arr: tuple | None = None

    # write-side stats sample cap: the z3 histogram only ever feeds
    # RATIO estimates (mass / total_mass), so a strided subsample keeps
    # selectivity unbiased while the write path stays O(sample) — a
    # 100M-row ingest must not pay a full z3 re-encode for stats
    # (the reference's stats are likewise approximate sketches)
    _Z3_SAMPLE = 1_000_000

    def observe(self, batch) -> None:
        self.count.observe(batch)
        # ONE strided sub-batch shared by every sketch; weight = stride
        # keeps masses comparable across differently-sampled batches (a
        # small unsampled batch must not outweigh a large strided one)
        step = 1
        sub = batch
        if batch.n > self._Z3_SAMPLE:
            step = batch.n // self._Z3_SAMPLE + 1
            sub = batch.take(np.arange(0, batch.n, step, dtype=np.int64))
        for a in self.sft.attributes:
            # no equality sketch of a geometry (the JAX package's write
            # fails on an indexed Point attribute here)
            if (not a.indexed or a.name not in batch.columns
                    or a.is_geometry):
                continue
            fr = self.attr_freq.setdefault(a.name, Frequency(a.name))
            fr.observe(sub, weight=step)
        if self.z3 is not None:
            self.z3.observe(sub, weight=step)

    def estimate_count(self, f: ast.Filter) -> int | None:
        """Estimated matching features, or None if not estimable."""
        total = self.count.count
        if total == 0:
            return 0
        if isinstance(f, ast.Include):
            return total
        if isinstance(f, ast.Exclude):
            return 0
        rest, attr_sel = self._split_attr_equality(f)
        if rest is None:
            # every conjunct was a sketch-backed attribute equality:
            # estimable without any spatio-temporal bound
            return int(round(attr_sel * total))
        sel = self._spatio_temporal_selectivity(rest)
        if sel is None:
            return None
        if attr_sel is not None:
            sel *= attr_sel
        return int(round(sel * total))

    def _split_attr_equality(self, f: ast.Filter):
        """Factor sketch-backed ``attr = value`` conjuncts out of a
        top-level AND: returns ``(rest, attr_selectivity)`` where rest
        is the filter minus those conjuncts (None when nothing is
        left) and attr_selectivity their combined count-min selectivity
        (None when no conjunct had a sketch — behavior then matches
        the pre-composition estimator exactly). Independence is
        assumed across conjuncts, as the reference's estimator does."""
        conjuncts = (list(f.children) if isinstance(f, ast.And) else [f])
        sel = None
        rest = []
        for c in conjuncts:
            est = None
            if isinstance(c, ast.Compare) and c.op == ast.CompareOp.EQ:
                est = self.attr_equality_estimate(c.prop, c.value)
            if est is None:
                rest.append(c)
                continue
            frac = min(1.0, est / max(self.count.count, 1))
            sel = frac if sel is None else sel * frac
        if sel is None:
            return f, None
        if not rest:
            return None, sel
        return (ast.And(rest) if len(rest) > 1 else rest[0]), sel

    def _spatio_temporal_selectivity(self, f: ast.Filter) -> float | None:
        geom = self.sft.geom_field
        dtg = self.sft.dtg_field
        if geom is None:
            return None
        geoms = extract_geometries(f, geom)
        if geoms.disjoint:
            return 0.0
        has_temporal = False
        if dtg is not None:
            iv = extract_intervals(f, dtg)
            if iv.disjoint:
                return 0.0
            has_temporal = bool(iv) and any(
                b.lower.is_bounded or b.upper.is_bounded for b in iv)
        if geoms.is_empty and not has_temporal:
            # no spatio-temporal constraint: not estimable here (attr/id
            # strategies must fall back to their heuristic costs)
            return None
        if self.z3 is None or self.z3.is_empty:
            # envelope-area fallback
            if not geoms:
                return None
            area = sum((g.envelope.xmax - g.envelope.xmin)
                       * (g.envelope.ymax - g.envelope.ymin) for g in geoms)
            return min(1.0, area / (360.0 * 180.0))
        # z3-histogram estimate: fraction of mass in covered (bin, cell)s.
        # All aggregates (total / per-bin / per-cell masses) are
        # maintained incrementally on observe — per-query cost must stay
        # O(selected bins), never O(all bins x cells): a 10k-polygon join
        # issues 10k count queries through this estimate
        intervals = (extract_intervals(f, dtg) if dtg is not None
                     else None)
        boxes = [g.envelope for g in geoms] or None
        hist = self.z3
        total_mass = hist.total
        if total_mass == 0:
            return 0.0
        period = hist.period
        all_bins = True
        sel_bins: set[int] = set()
        if intervals and not intervals.disjoint and len(intervals):
            all_bins = False
            for b in intervals:
                if not (b.lower.is_bounded and b.upper.is_bounded):
                    all_bins = True
                    break
                bins, _, _ = timebin.bins_of_interval(
                    int(b.lower.value), int(b.upper.value), period)
                sel_bins.update(bins.tolist())
        cells = (None if boxes is None
                 else self._cells_for_boxes(hist, boxes))
        if all_bins:
            mass = (total_mass if cells is None
                    else int(hist.cell_mass[cells].sum()))
        elif cells is None:
            mass = sum(hist.bin_mass.get(b, 0) for b in sel_bins)
        else:
            mass = sum(int(arr[cells].sum()) for b in sel_bins
                       if (arr := hist.bins.get(b)) is not None)
        return mass / total_mass

    def attr_equality_estimate(self, attr: str, value) -> int | None:
        """Estimated rows matching ``attr = value`` from the maintained
        count-min sketch, scaled for write-side subsampling; None when
        no sketch exists (unindexed attribute / nothing observed)."""
        fr = self.attr_freq.get(attr)
        if fr is None or fr.total == 0:
            return None
        scale = max(self.count.count, 1) / fr.total
        return int(round(fr.count(value) * scale))

    def temporal_fraction(self, intervals) -> float | None:
        """Fraction of observed mass inside the date intervals (time-bin
        resolution, from the z3 histogram) — the cost-model view of the
        attribute index's secondary (value, date) narrowing. ``intervals``
        is a FilterValues of date Bounds; None when not estimable."""
        if (self.z3 is None or self.z3.is_empty
                or not intervals or intervals.disjoint):
            return None
        hist = self.z3
        total = hist.total
        if total == 0:
            return None
        from ..filters.helper import to_millis
        sel_bins: set[int] = set()
        for b in intervals:
            if not (b.lower.is_bounded and b.upper.is_bounded):
                return None
            try:
                lo, hi = to_millis(b.lower.value), to_millis(b.upper.value)
            except Exception:
                return None
            # bins_of_interval handles out-of-range intervals itself
            # (wholly pre-epoch -> no bins); pre-clamping here would
            # collapse them onto a spurious bin 0
            bins, _, _ = timebin.bins_of_interval(lo, hi, hist.period)
            sel_bins.update(bins.tolist())
        mass = sum(hist.bin_mass.get(b, 0) for b in sel_bins)
        return mass / total

    def _cell_bounds(self, hist: Z3Histogram) -> tuple:
        """Spatial bounds (x0, x1, y0, y1 arrays) of every coarse z cell,
        decoded once from each cell's z-prefix range: a prefix fixes the
        leading bits of each interleaved dimension, so the prefix-lo
        decode gives the cell's min bin and the prefix-hi decode its max
        bin per dimension (expanded by half a bin: denormalize returns
        bin centers)."""
        if self._cell_bounds_arr is None:
            sfc = z3sfc(hist.period)
            c = np.arange(hist.length, dtype=np.uint64)
            shift = np.uint64(hist._shift)
            z_lo = c << shift
            z_hi = ((c + np.uint64(1)) << shift) - np.uint64(1)
            xl, yl, _ = sfc.invert(z_lo)
            xh, yh, _ = sfc.invert(z_hi)
            hx = (sfc.lon.max - sfc.lon.min) / sfc.lon.bins / 2
            hy = (sfc.lat.max - sfc.lat.min) / sfc.lat.bins / 2
            self._cell_bounds_arr = (xl - hx, xh + hx, yl - hy, yh + hy)
        return self._cell_bounds_arr

    def _cells_for_boxes(self, hist: Z3Histogram, boxes) -> np.ndarray:
        """Indices of coarse z cells whose spatial extent intersects the
        boxes — a vectorized overlap test against precomputed per-cell
        bounds (replaces a per-query z-range decomposition: 10k-query
        joins pay this on every count)."""
        key = tuple(b.as_tuple() for b in boxes)
        cached = self._cells_cache.get(key)
        if cached is not None:
            return cached
        x0, x1, y0, y1 = self._cell_bounds(hist)
        mask = np.zeros(hist.length, dtype=bool)
        for b in boxes:
            xmin, ymin, xmax, ymax = b.as_tuple()
            mask |= (x1 >= xmin) & (x0 <= xmax) & (y1 >= ymin) & (y0 <= ymax)
        out = np.flatnonzero(mask)
        if len(self._cells_cache) >= 64:
            self._cells_cache.pop(next(iter(self._cells_cache)))
        self._cells_cache[key] = out
        return out


class DataStoreStats:
    """Per-type stats registry for a datastore (GeoMesaStats analog,
    index/stats/GeoMesaStats.scala:29): auto-maintained on write, used
    for cost estimation and exposed for stats queries."""

    def __init__(self):
        self._by_type: dict[str, StatsEstimator] = {}

    def ensure(self, sft: SimpleFeatureType) -> StatsEstimator:
        if sft.type_name not in self._by_type:
            self._by_type[sft.type_name] = StatsEstimator(sft)
        return self._by_type[sft.type_name]

    def get(self, type_name: str) -> StatsEstimator | None:
        return self._by_type.get(type_name)

    def observe(self, sft: SimpleFeatureType, batch) -> None:
        self.ensure(sft).observe(batch)

    def clear(self, type_name: str) -> None:
        self._by_type.pop(type_name, None)
