"""In-memory datastore of point schemas, with its scans on the GPU.

    write(batch) -> host columns (pending until the next read)
    query(q)     -> plan (splitter + cost decider over z3, z2, id,
                    attr:<name> and fullscan)
                 -> z3/z2: one of three tiers:
                    host-exact   z-index candidates evaluated in f64
                    gathered     scan kernel over the index candidates
                    dense        scan kernel over every row
                    -> exact f64 boundary patch of the kernel tiers
                    -> the exact geometry of a polygon predicate (the
                       point-in-polygon kernel on every candidate set,
                       then float64 on its band rows)
                 -> id: the fid set; attr: the sorted attribute index, or
                    the residual kernel when its bounds are too wide;
                    fullscan: every row
                 -> the secondary filter: the residual kernel over every
                    row when the candidates are dense, else f64 on the
                    host
                 -> sorted row ids
    query_batched(qs)
                 -> plan each query; the fusible ones of a type run as
                    ONE pass of the batched kernels (hits, boundary
                    candidates, compaction on the device), then the
                    per-query f64 patch; the rest go through query()

The device columns (two-float coordinates, (day, ms) times) live on
the store's device with power-of-two capacity; appends copy into that
capacity in place and rebuild with fresh headroom only when it runs out.

The schemas have a default Point geometry and Integer, Long, Float,
Double, Boolean, String, Date and Point attributes (``:index=true`` on
any). The filters are the ECQL grammar of ``filters/ecql.py`` with
polygon and multipolygon literals. What that leaves out raises
NotImplementedError naming its later slice (ROADMAP.md section 6).
"""

from __future__ import annotations

import functools
import threading

import numpy as np

from ..analytics.st_functions import contains_points
from ..features.batch import COLUMN_TYPES, FeatureBatch, PointColumn
from ..features.sft import SimpleFeatureType, parse_spec
from ..filters import ast
from ..filters.evaluate import evaluate
from ..filters.helper import (extract_attribute_bounds, extract_geometries,
                              extract_intervals, is_box, to_millis)
from ..geometry import MultiPolygon, Polygon
from ..index.api import Explainer, FilterStrategy, Query, QueryHints
from ..index.attr import AttributeKeyIndex
from ..index.planner import decide_strategy
from ..index.splitter import spatial_part
from ..index.zkeys import SCAN_BLOCK_THRESHOLD, ZKeyIndex, search_rows
from ..scan import gscan, residual, zscan
from ..utils.device import resolve_device
from ..utils.properties import SystemProperty
from .api import DataStore

__all__ = ["InMemoryDataStore", "QueryResult"]

# index-pruned candidate sets at or below this size evaluate exactly on
# the host in f64 instead of a device round trip; larger candidate sets
# ride the device kernels
HOST_SCAN_ROWS = SystemProperty("geomesa.scan.host.rows", "2000000")

_WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it belongs to the "
        f"{slice_name} slice (ROADMAP.md section 6)")


class QueryResult:
    """Result of a feature query: the matching ids in row order."""

    def __init__(self, rows: np.ndarray, ids: np.ndarray,
                 explain: Explainer, plan: FilterStrategy):
        self.rows = rows
        self.ids = ids
        self.explain = explain
        self.plan = plan

    @property
    def n(self) -> int:
        return len(self.rows)

    def __repr__(self) -> str:
        return f"QueryResult(n={self.n}, plan={self.plan.index})"


class _TypeState:
    """Per-feature-type storage: host batch + lazily built index.

    Writes land in a pending list; the first read flushes it with one
    concat. Once the index exists, a flush appends the delta to the
    device columns in place (within capacity) and merges it into the
    z-key sort orders instead of rebuilding them. The attribute indexes
    and the residual's device columns are built on first use and dropped
    on every flush."""

    def __init__(self, sft: SimpleFeatureType, device):
        self.sft = sft
        self.device = device
        self._batch: FeatureBatch | None = None
        self._pending: list[FeatureBatch] = []
        self._pending_n = 0
        self.scan_data: zscan.ScanData | None = None
        self.zindex: ZKeyIndex | None = None
        # hi parts of the coordinates on the host, for the boundary patch
        self.host_xhi: np.ndarray | None = None
        self.host_yhi: np.ndarray | None = None
        self.dirty = False
        self.attr_idx: dict[str, AttributeKeyIndex | None] = {}
        self.devcols: residual.DeviceColumns | None = None

    @property
    def n(self) -> int:
        return (0 if self._batch is None else self._batch.n) + self._pending_n

    @property
    def batch(self) -> FeatureBatch | None:
        self.flush()
        return self._batch

    def append(self, batch: FeatureBatch):
        self._pending.append(batch)
        self._pending_n += batch.n

    def _millis(self, batch: FeatureBatch) -> np.ndarray:
        dtg = self.sft.dtg_field
        return (batch.col(dtg).millis if dtg is not None
                else np.zeros(batch.n, dtype=np.int64))

    def flush(self):
        if not self._pending:
            return
        delta = FeatureBatch.concat_all(self._pending)
        can_merge = (self._batch is not None and not self.dirty
                     and self.scan_data is not None)
        self._batch = delta if self._batch is None else self._batch.concat(delta)
        self._pending = []
        self._pending_n = 0
        # the per-column caches cover the old rows only
        self.attr_idx.clear()
        self.devcols = None
        # pessimistically dirty: a failure below rebuilds on the next read
        self.dirty = True
        if not can_merge:
            return
        col = delta.col(self.sft.geom_field)
        dmillis = self._millis(delta)
        dxhi, dxlo = zscan.split_two_float(col.x)
        dyhi, dylo = zscan.split_two_float(col.y)
        data = zscan.extend_scan_data(self.scan_data, col.x, col.y, dmillis,
                                      xy_split=(dxhi, dxlo, dyhi, dylo))
        if data is None:
            # capacity exhausted: rebuild once with power-of-two headroom
            full = self._batch.col(self.sft.geom_field)
            data = zscan.build_scan_data(
                full.x, full.y, self._millis(self._batch), self.device,
                cap=zscan.next_pow2(self._batch.n + 1))
        self.scan_data = data
        self.host_xhi = np.concatenate([self.host_xhi, dxhi])
        self.host_yhi = np.concatenate([self.host_yhi, dyhi])
        self.zindex = self.zindex.extend(
            col.x, col.y, dmillis if self.sft.dtg_field else None)
        self.dirty = False

    def ensure_index(self):
        """(Re)build the device columns and the z-key index if writes
        happened since the last build."""
        self.flush()
        if not self.dirty and self.scan_data is not None:
            return
        col = self._batch.col(self.sft.geom_field)
        millis = self._millis(self._batch)
        xhi, xlo = zscan.split_two_float(col.x)
        yhi, ylo = zscan.split_two_float(col.y)
        self.scan_data = zscan.build_scan_data(
            col.x, col.y, millis, self.device,
            cap=zscan.next_pow2(self._batch.n), xy_split=(xhi, xlo, yhi, ylo))
        self.host_xhi, self.host_yhi = xhi, yhi
        self.zindex = ZKeyIndex(col.x, col.y,
                                millis if self.sft.dtg_field else None,
                                self.sft.z3_interval)
        self.dirty = False

    def attr_index(self, name: str) -> AttributeKeyIndex | None:
        """Sorted index of one column, built on first use; keyed (value,
        date) when the schema has a default date, so equality scans
        narrow by the filter's date bounds. None for a column type the
        index cannot sort (a point)."""
        self.flush()
        if name not in self.attr_idx:
            dtg = self.sft.dtg_field
            date_millis = (self.batch.col(dtg).millis
                           if dtg is not None and dtg != name else None)
            try:
                self.attr_idx[name] = AttributeKeyIndex(
                    self.batch.col(name), date_millis=date_millis)
            except TypeError:
                self.attr_idx[name] = None
        return self.attr_idx[name]

    def device_cols(self) -> residual.DeviceColumns:
        """The residual kernel's split columns on the store's device,
        uploaded per column on first use."""
        self.flush()
        if self.devcols is None:
            self.devcols = residual.DeviceColumns(self.batch, self.device)
        return self.devcols


def _synchronized(fn):
    """Serialize a store operation: reads mutate state too (pending
    flush, lazy index builds)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._op_lock:
            return fn(self, *args, **kwargs)
    return wrapper


class InMemoryDataStore(DataStore):
    """A GeoTools-DataStore-shaped API over device-resident columns.

    ``device=None`` means ``"cuda"``: the store runs on the GPU unless
    the caller asks for another device, and raises when CUDA is absent.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._op_lock = threading.RLock()
        self._types: dict[str, _TypeState] = {}

    # -- schema management -------------------------------------------------

    @_synchronized
    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        if sft.type_name in self._types:
            raise ValueError(f"schema {sft.type_name!r} already exists")
        if not sft.is_points:
            raise _later("a schema without a default Point geometry",
                         "extent-geometry (XZ) schemas")
        for a in sft.attributes:
            if a.type.name not in COLUMN_TYPES:
                raise _later(f"a {a.type} attribute ({a.name!r})",
                             "extent-geometry (XZ) schemas"
                             if a.is_geometry else "collection-type")
        self._types[sft.type_name] = _TypeState(sft, self.device)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._state(type_name).sft

    def get_type_names(self) -> list[str]:
        return sorted(self._types)

    def _state(self, type_name: str) -> _TypeState:
        if type_name not in self._types:
            raise KeyError(f"no such schema: {type_name}")
        return self._types[type_name]

    # -- writes --------------------------------------------------------------

    @_synchronized
    def write(self, type_name: str, batch: FeatureBatch):
        st = self._state(type_name)
        if batch.sft != st.sft:
            raise ValueError("batch schema does not match store schema")
        st.append(batch)

    @_synchronized
    def count(self, type_name: str) -> int:
        return self._state(type_name).n

    # -- queries -------------------------------------------------------------

    def _as_query(self, q: Query | str, type_name: str | None) -> Query:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        unknown = set(q.hints) - {QueryHints.QUERY_INDEX}
        if unknown:
            raise _later(f"query hints {sorted(unknown)}",
                         "sampling/density/stats/bin/arrow")
        return q

    @_synchronized
    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        explain = Explainer(explain_out)
        explain.push(lambda: f"Planning '{q.type_name}' filter={q.filter}")
        idx, strategy = self._matching_rows(q, st, explain)
        if q.max_features is not None:
            idx = idx[:q.max_features]
        ids = (st.batch.ids[idx] if st.batch is not None
               else np.empty(0, dtype=object))
        explain(f"Hits: {len(idx)}").pop()
        return QueryResult(idx, ids, explain, strategy)

    @_synchronized
    def query_batched(self, queries: list[Query],
                      explain_out=None) -> list[QueryResult]:
        """Micro-batched execution: evaluate several queries with ONE
        pass of the batched scan kernels and demultiplex per-query
        results.

        Queries whose plan cannot fuse (strategies other than z3/z2, a
        secondary residual filter, an exact geometry predicate) run
        through ``query()`` one by one, so the result list is exactly
        what per-query ``query()`` calls return, id for id, in input
        order. A type with fewer than two fusible queries, and a
        one-element list, go through ``query()`` entirely."""
        queries = [self._as_query(q, None) for q in queries]
        if len(queries) <= 1:
            return [self.query(q, explain_out=explain_out) for q in queries]
        results: list[QueryResult | None] = [None] * len(queries)
        groups: dict[str, list[int]] = {}
        for i, q in enumerate(queries):
            groups.setdefault(q.type_name, []).append(i)
        for tn, members in groups.items():
            st = self._types.get(tn)
            fused: dict[int, tuple] = {}
            for i in members:
                plan = (self._fusible_plan(queries[i], st, explain_out)
                        if st is not None and st.n > 0 else None)
                if plan is not None:
                    fused[i] = plan
            if len(fused) < 2:
                fused = {}
            for i in members:
                if i not in fused:
                    results[i] = self.query(queries[i],
                                            explain_out=explain_out)
            if not fused:
                continue
            rows_per_q = self._batched_scan_rows(st, list(fused.values()))
            for (i, (strategy, explain, _b, _iv)), idx in zip(fused.items(),
                                                               rows_per_q):
                q = queries[i]
                if q.max_features is not None:
                    idx = idx[:q.max_features]
                explain(f"Hits: {len(idx)}").pop()
                results[i] = QueryResult(idx, st.batch.ids[idx], explain,
                                         strategy)
        return results  # type: ignore[return-value]

    def _fusible_plan(self, q: Query, st: _TypeState, explain_out):
        """(strategy, explainer, boxes, intervals) when the query can run
        in the batched scan: a z3/z2 strategy with no secondary filter
        and no exact geometry predicate (a rectangular INTERSECTS or
        WITHIN goes through query(), as in the reference); else None."""
        _check_filter(q.filter)
        explain = Explainer(explain_out)
        explain.push(lambda: f"Batched '{q.type_name}' filter={q.filter}")
        strategy = decide_strategy(st.sft, q, _indices(st.sft), st.n,
                                   explain=explain)
        if strategy.index not in ("z3", "z2") or strategy.secondary is not None:
            return None
        boxes, intervals, needs_exact = _scan_inputs(st.sft, strategy)
        if needs_exact:
            return None
        return strategy, explain, boxes, intervals

    def _batched_scan_rows(self, st: _TypeState, plans) -> list[np.ndarray]:
        """One pass of the batched kernels over the stacked queries, then
        the per-query exact boundary patch on the candidates that the
        kernels compacted on the device (no per-query O(n) host work).
        ``plans`` are _fusible_plan's, all of one type."""
        st.ensure_index()
        sqs = [zscan.make_query(boxes, intervals)
               for _s, _e, boxes, intervals in plans]
        bq = zscan.stack_queries(sqs)
        hits, cands = zscan.batch_hit_rows(st.scan_data, bq)
        col = st.batch.col(st.sft.geom_field)
        millis = st._millis(st.batch)
        out = []
        for (_s, explain, _b, _iv), sq, rows, cand in zip(plans, sqs, hits,
                                                          cands):
            explain(f"Fused device scan: query {len(out) + 1} of "
                    f"{bq.n_queries}, "
                    f"{sq.n_boxes} box(es), {len(sq.host_intervals)} "
                    f"interval(s), n={st.n}")
            if len(cand):
                explain(f"Boundary recheck: {len(cand)} candidate(s)")
            rows = zscan.patch_hit_rows(rows, sq, col.x, col.y, millis, cand)
            out.append(rows.astype(np.int64))
        return out

    @_synchronized
    def query_count(self, q: Query | str,
                    type_name: str | None = None) -> int:
        """Count without gathering ids: the same row selection, then the
        length."""
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        idx, _ = self._matching_rows(q, st, Explainer())
        n = len(idx)
        return n if q.max_features is None else min(n, q.max_features)

    def _matching_rows(self, q: Query, st: _TypeState, explain: Explainer):
        _check_filter(q.filter)
        if st.n == 0:
            explain("Store is empty")
            return (np.empty(0, dtype=np.int64),
                    FilterStrategy("empty", None, None))
        strategy = decide_strategy(st.sft, q, _indices(st.sft), st.n,
                                   explain=explain)
        return self._execute(st, strategy, explain), strategy

    def _execute(self, st: _TypeState, strategy: FilterStrategy,
                 explain: Explainer) -> np.ndarray:
        """Run the chosen strategy; returns sorted matching row indices,
        in index space (an index-pruned scan never pays O(n) host work)."""
        if strategy.index == "empty":
            return np.empty(0, dtype=np.int64)
        if strategy.index in ("z3", "z2"):
            st.ensure_index()
            idx = self._device_scan(st, strategy, explain)
        elif strategy.index == "id":
            idx = np.flatnonzero(np.isin(
                st.batch.ids.astype(str),
                np.asarray(strategy.primary.ids, dtype=str)))
        elif strategy.index.startswith("attr:"):
            idx = self._attr_scan(st, strategy, explain)
        else:
            # fullscan: every row, the whole filter as the secondary
            idx = np.arange(st.n, dtype=np.int64)
        if strategy.secondary is not None:
            if len(idx):
                idx = self._apply_residual(st, strategy.secondary, idx,
                                           explain)
            explain(f"Residual filter applied: {strategy.secondary}")
        return idx

    def _apply_residual(self, st: _TypeState, f: ast.Filter,
                        idx: np.ndarray, explain: Explainer) -> np.ndarray:
        """The secondary filter: the residual kernel over every row when
        the candidates are a large share of the table (gathering them
        would cost more than re-reading the columns), the f64 host
        evaluator on the gathered candidates otherwise."""
        batch = st.batch
        if len(idx) * 4 > st.n and residual.is_compilable(f, batch):
            explain("Device residual scan (dense)")
            mask = residual.device_mask(f, batch, st.device_cols())
            return idx[mask[idx]]
        return idx[evaluate(f, batch.take(idx))]

    def _attr_scan(self, st: _TypeState, strategy: FilterStrategy,
                   explain: Explainer) -> np.ndarray:
        """Attribute-index scan: binary-searched candidate rows from the
        sorted column, then the exact primary on those rows (bounds
        over-approximate, e.g. a non-prefix LIKE); bounds too wide for
        that run the residual kernel over every row instead."""
        attr = strategy.index.split(":", 1)[1]
        aidx = st.attr_index(attr)
        rows = None
        narrowed = False
        if aidx is not None:
            bounds = extract_attribute_bounds(strategy.primary, attr)
            # secondary date tier: the residual's date bounds narrow the
            # equality slices of the (value, date) order
            dtg = st.sft.dtg_field
            intervals = []
            if (dtg is not None and strategy.secondary is not None
                    and aidx.sorted_millis is not None):
                intervals = _intervals_ms(strategy.secondary, dtg,
                                          lo_unbounded=-(2 ** 62))
            max_rows = int(float(SCAN_BLOCK_THRESHOLD.get()) * st.n)
            rows = aidx.candidates(bounds, max_rows=max_rows,
                                   intervals_ms=intervals)
            narrowed = bool(intervals) and any(
                aidx.is_point_bound(b) for b in bounds)
        if rows is None:
            if residual.is_compilable(strategy.primary, st.batch):
                explain(f"Attribute bounds too wide; dense device scan "
                        f"for {strategy.index}")
                return np.flatnonzero(residual.device_mask(
                    strategy.primary, st.batch, st.device_cols()))
            explain(f"Attribute bounds not range-scannable; "
                    f"host scan for {strategy.index}")
            return np.flatnonzero(evaluate(strategy.primary, st.batch))
        explain(f"Attribute index scan: {len(rows)} candidate row(s) "
                f"of {st.n}" + (" (date-narrowed)" if narrowed else ""))
        if not len(rows):
            return rows
        return rows[evaluate(strategy.primary, st.batch.take(rows))]

    def _device_scan(self, st: _TypeState, strategy: FilterStrategy,
                     explain: Explainer) -> np.ndarray:
        """The hot path: z-range index pruning -> host-exact tier, or
        the scan kernel over gathered candidates or every row, + exact
        boundary patch + the polygon predicate of INTERSECTS/WITHIN.
        Returns sorted row indices."""
        boxes, intervals, needs_exact = _scan_inputs(st.sft, strategy)
        block_cap = int(float(SCAN_BLOCK_THRESHOLD.get()) * st.n)
        host_cap = min(block_cap, int(HOST_SCAN_ROWS.get()))
        kind, rows = search_rows(st.zindex, strategy.index, boxes,
                                 intervals, host_cap, block_cap)
        if kind == "exact":
            explain(f"Index-pruned host scan: {len(rows)} hit(s) of {st.n}, "
                    f"{len(boxes)} box(es), {len(intervals)} interval(s)")
            idx = rows
        else:
            sq = zscan.make_query(boxes, intervals)
            if kind == "candidates":
                idx = self._scan_gathered(st, sq, rows, explain)
            else:
                idx = self._scan_dense(st, sq, explain)

        # polygon predicates are exact on their polygon, not its envelope
        if needs_exact:
            spatial_f, _ = spatial_part(strategy.primary, st.sft.geom_field)
            if len(idx) and spatial_f is not None:
                col = st.batch.col(st.sft.geom_field)
                keep = self._pip_residual(st, spatial_f, col, idx, explain)
                if keep is None:
                    keep = evaluate(spatial_f, st.batch.take(idx))
                idx = idx[keep]
            explain("Exact geometry predicate applied")
        return idx

    def _pip_residual(self, st: _TypeState, spatial_f, col: PointColumn,
                      candidates: np.ndarray, explain: Explainer):
        """The point-in-polygon kernel for the exact residual of a single
        INTERSECTS/WITHIN polygon, at any number of candidates (on an
        H100 this path beat the host's f64 crossing number from 100 to
        500k candidates: chip_smoke.py's pip_step); the band rows
        re-evaluated in f64. A bool keep mask over the candidates, or
        None where it does not apply."""
        if not (isinstance(spatial_f, (ast.Intersects, ast.Within))
                and isinstance(spatial_f.geom, (Polygon, MultiPolygon))):
            return None
        px, py = col.x[candidates], col.y[candidates]
        inside, band_idx = gscan.points_in_polygon_device(
            px, py, gscan.pack_polygon(spatial_f.geom, st.device))
        if len(band_idx):
            # the exact f64 predicate, boundary included, on the band rows
            inside[band_idx] = contains_points(
                spatial_f.geom, px[band_idx], py[band_idx])
        explain(f"Device point-in-polygon residual "
                f"({len(candidates)} candidates, {len(band_idx)} band)")
        return inside & col.valid[candidates]

    def _patch_mask(self, st: _TypeState, mask: np.ndarray, xhi, yhi, sel,
                    sq: zscan.ScanQuery, explain: Explainer) -> np.ndarray:
        """Exact f64 recheck of rows whose hi-cell touches a query bound;
        sel=None means full-table arrays, else a row subset (rows outside
        a pruned candidate set are provably outside the query in f64)."""
        cand = zscan.boundary_candidates(xhi, yhi, sq)
        if not len(cand):
            return mask
        col = st.batch.col(st.sft.geom_field)
        x, y, millis = col.x, col.y, st._millis(st.batch)
        if sel is not None:
            x, y, millis = x[sel], y[sel], millis[sel]
        explain(f"Boundary recheck: {len(cand)} candidate(s)")
        return zscan.exact_patch(mask, cand, x, y, millis, sq)

    def _scan_gathered(self, st: _TypeState, sq: zscan.ScanQuery,
                       rows: np.ndarray, explain: Explainer) -> np.ndarray:
        """Index-pruned candidate tier: the kernel over just the gathered
        rows + boundary patch on the subset."""
        explain(f"Index-pruned device scan: {len(rows)} candidate row(s) "
                f"of {st.n}, {sq.n_boxes} box(es), "
                f"{len(sq.host_intervals)} interval(s)")
        sub = zscan.scan_mask_at(st.scan_data, sq, rows)
        sub = self._patch_mask(st, sub, st.host_xhi[rows], st.host_yhi[rows],
                               rows, sq, explain)
        return np.sort(rows[sub]).astype(np.int64)

    def _scan_dense(self, st: _TypeState, sq: zscan.ScanQuery,
                    explain: Explainer) -> np.ndarray:
        """Dense tier: the kernel over every row + full-table boundary
        patch. The mask's copy to the host is the sync point."""
        explain(f"Device scan: {sq.n_boxes} box(es), "
                f"{len(sq.host_intervals)} interval(s), n={st.n}")
        mask = zscan.scan_mask(st.scan_data, sq)[:st.n].cpu().numpy()
        mask = self._patch_mask(st, mask, st.host_xhi, st.host_yhi, None,
                                sq, explain)
        return np.flatnonzero(mask)


def _scan_inputs(sft: SimpleFeatureType, strategy: FilterStrategy):
    """(boxes, intervals, needs_exact) of a z3/z2 strategy, for the
    scalar and the batched scan alike: the query envelopes (the whole
    world when the filter has none), the inclusive millis intervals (z3
    only), and whether an exact geometry predicate (INTERSECTS, WITHIN,
    a non-rectangular geometry) must re-check the scan's rows."""
    primary = (strategy.primary if strategy.primary is not None
               else ast.Include())
    geoms = extract_geometries(primary, sft.geom_field)
    boxes = [g.envelope.as_tuple() for g in geoms] or [_WHOLE_WORLD]
    intervals = (_intervals_ms(primary, sft.dtg_field)
                 if sft.dtg_field is not None and strategy.index == "z3"
                 else [])
    needs_exact = any(not is_box(g) for g in geoms) or any(
        isinstance(c, ast.SpatialPredicate) for c in ast.walk(primary))
    return boxes, intervals, needs_exact


def _indices(sft: SimpleFeatureType) -> list[str]:
    """The indexes a point schema has: z3 (with a default date), z2, id,
    and one attr:<name> per indexed attribute."""
    out = (["z3"] if sft.dtg_field is not None else []) + ["z2", "id"]
    return out + [f"attr:{a.name}" for a in sft.attributes if a.indexed]


def _intervals_ms(primary: ast.Filter, dtg: str,
                  lo_unbounded: int = 0) -> list[tuple[int, int]]:
    """Inclusive [lo, hi] epoch-millis intervals, with exclusive bounds
    moved in by one milli (FilterHelper.scala:267-307). ``lo_unbounded``
    is the open lower end: 0 for the z3 kernels (the index domain's
    floor), a large negative for raw-millis consumers."""
    out = []
    for b in extract_intervals(primary, dtg):
        lo = to_millis(b.lower.value) if b.lower.is_bounded else lo_unbounded
        hi = to_millis(b.upper.value) if b.upper.is_bounded else 2**62
        if b.lower.is_bounded and not b.lower.inclusive:
            lo += 1
        if b.upper.is_bounded and not b.upper.inclusive:
            hi -= 1
        out.append((lo, hi))
    return out


def _check_filter(f: ast.Filter):
    """Raise NotImplementedError for what the port does not run yet: a
    spatial predicate against another literal than a polygon or
    multipolygon (the parser already refuses DWITHIN and the relate
    operators)."""
    for c in ast.walk(f):
        if (isinstance(c, ast.SpatialPredicate)
                and not isinstance(c.geom, (Polygon, MultiPolygon))):
            raise _later(f"{c.op_name} against a {c.geom.geom_type}",
                         "extent-geometry")
