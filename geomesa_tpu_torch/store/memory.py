"""In-memory datastore of point schemas, with its scans on the GPU.

    write(batch, visibilities=None)
                 -> host columns (pending until the next read)
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
                 -> visibility (feature or attribute level, with the
                    leak guard), then SAMPLING / SAMPLE_BY
                 -> sort_by, max_features, the projection check
                 -> QueryResult: ids (gathered eagerly up to 100k hits),
                    and a lazy batch that copies columns on first read
                    (attribute-level redaction materializes it)
    query_batched(qs)
                 -> plan each query; the fusible ones of a type run as
                    ONE pass of the batched kernels (hits, boundary
                    candidates, compaction on the device), then the
                    per-query f64 patch, visibility, sampling and result
                    assembly; the rest go through query()
    density(...) -> the query, then the result's point and weight
                    columns as f32 on the device, binned and summed by
                    the density kernel
    bin_query(...)
                 -> the query, then the BIN records on the host
    delete(ids)  -> the rows dropped; the device columns, z-index and
                    attribute indexes rebuild on the next read
    remove_schema
                 -> the type and its device memory released

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

import dataclasses
import functools
import threading
import weakref
from typing import Any, Iterator

import numpy as np

from ..analytics.st_functions import contains_points
from ..features.batch import (COLUMN_TYPES, FeatureBatch, PointColumn,
                              StringColumn)
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
from ..scan.aggregations import density_grid, encode_bin_batch, sample_mask
from ..security import (evaluate_visibilities, parse_visibility,
                        validate_labels)
from ..security.visibility import distinct_labels
from ..utils.device import resolve_device
from ..utils.properties import SystemProperty
from .api import DataStore
from .common import sort_order

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


class _LazyBatch:
    """Deferred result materialization: the source batch snapshot (the
    columnar arrays are immutable — writes and deletes build new
    objects) plus the matched rows. The column copies happen only if a
    caller reads ``result.batch``; id-only consumers never pay them."""

    def __init__(self, source: FeatureBatch, idx: np.ndarray,
                 properties, row_order: bool = True):
        self.source = source
        self.idx = idx
        self.properties = properties
        # False when the caller reordered idx (sort_by): the endpoint
        # identity check below would misread a permutation as identity
        self.row_order = row_order
        self._mat: FeatureBatch | None = None

    def detach(self):
        """Break the pin on the source snapshot (the store calls this
        when data mutates): small results materialize; large ones stay
        lazy."""
        if self._mat is None and len(self.idx) <= 10_000:
            self.materialize()

    def column(self, name: str):
        """One column of the result, without copying the others."""
        if self._mat is not None:
            return self._mat.col(name)
        return self.source.col(name).take(self.idx)

    def materialize(self) -> FeatureBatch:
        if self._mat is not None:
            return self._mat
        if (self.row_order and self.properties is None
                and len(self.idx) == self.source.n
                and self.idx[0] == 0 and self.idx[-1] == self.source.n - 1):
            # full-table result in ascending row order: endpoint and
            # length checks imply identity, so the immutable source
            # snapshot IS the result
            self._mat = self.source
            return self._mat
        batch = self.source.take(self.idx)
        if self.properties is not None:
            cols = {p: batch.columns[p] for p in self.properties}
            batch = FeatureBatch(
                _project_sft(self.source.sft, self.properties),
                batch.ids, cols)
        self._mat = batch
        self.source = None  # release the snapshot pin
        return batch


class QueryResult:
    """Result of a feature query: the matching row ids (``rows``, in
    result order), the feature ids, and the result's columns.

    ``ids`` may be handed over as a thunk (gathered on first read) and
    ``batch`` as a _LazyBatch (copied on first read). ``batch`` is None
    when the type held no data at all; a zero-hit query still yields an
    (empty) batch."""

    def __init__(self, rows: np.ndarray, ids, batch, explain: Explainer,
                 plan: FilterStrategy):
        self.rows = rows
        self._ids = ids
        self._batch = batch          # FeatureBatch | None | _LazyBatch
        self.explain = explain
        self.plan = plan

    @property
    def ids(self) -> np.ndarray:
        if callable(self._ids):
            self._ids = self._ids()
        return self._ids

    @property
    def batch(self) -> FeatureBatch | None:
        if isinstance(self._batch, _LazyBatch):
            self._batch = self._batch.materialize()
        return self._batch

    @batch.setter
    def batch(self, value):
        self._batch = value

    def column(self, name: str):
        """One column of the result; a lazy batch copies only it."""
        if isinstance(self._batch, _LazyBatch):
            return self._batch.column(name)
        return self.batch.col(name)

    @property
    def n(self) -> int:
        return len(self.rows)

    def features(self) -> Iterator[dict[str, Any]]:
        if self.batch is None:
            return iter(())
        return (self.batch.feature(i) for i in range(self.batch.n))

    def __repr__(self) -> str:
        return f"QueryResult(n={self.n}, plan={self.plan.index})"


def _attr_vis_masks(vis_rows, n_attr: int, auths) -> np.ndarray:
    """(len(rows), n_attr) bool authorization matrix for
    attribute-level visibility labels (comma-joined per attribute;
    empty part = world-readable). Each distinct label is parsed once."""
    labels, inverse = distinct_labels(vis_rows)
    auth_set = set(auths)
    per = np.ones((len(labels), n_attr), dtype=bool)
    for k, v in enumerate(labels.tolist()):
        if v:
            parts = (v.split(",") + [""] * n_attr)[:n_attr]
            per[k] = [not p or parse_visibility(p).evaluate(auth_set)
                      for p in parts]
    return per[inverse.reshape(-1)]


def _null_cells(col, bad: np.ndarray):
    """Copy of a column with `bad` rows nulled (unauthorized
    attribute values at query time)."""
    if isinstance(col, StringColumn):
        codes = col.codes.copy()
        codes[bad] = -1
        return StringColumn(col.name, codes, col.vocab)
    return dataclasses.replace(col, valid=np.asarray(col.valid) & ~bad)


class _TypeState:
    """Per-feature-type storage: host batch + lazily built index.

    Writes land in a pending list; the first read flushes it with one
    concat. Once the index exists, a flush appends the delta to the
    device columns in place (within capacity) and merges it into the
    z-key sort orders instead of rebuilding them. The attribute indexes
    and the residual's device columns are built on first use and dropped
    on every flush. A delete drops every device and index structure;
    the next read rebuilds them from the kept rows."""

    def __init__(self, sft: SimpleFeatureType, device):
        self.sft = sft
        self.device = device
        self._batch: FeatureBatch | None = None
        # (batch, visibilities or None when no row has a label)
        self._pending: list[tuple[FeatureBatch, np.ndarray | None]] = []
        self._pending_n = 0
        self.scan_data: zscan.ScanData | None = None
        self.zindex: ZKeyIndex | None = None
        # hi parts of the coordinates on the host, for the boundary patch
        self.host_xhi: np.ndarray | None = None
        self.host_yhi: np.ndarray | None = None
        self.dirty = False
        self.attr_idx: dict[str, AttributeKeyIndex | None] = {}
        self.devcols: residual.DeviceColumns | None = None
        # per-feature visibility labels (None or "" = world-readable),
        # an object array aligned with the flushed batch; None while no
        # written row has a label (has_vis False), so unlabeled stores
        # keep no per-row objects. Attribute-level schemas store
        # comma-joined per-attribute labels in the same array.
        self._vis: np.ndarray | None = None
        self.has_vis = False
        # outstanding lazy results: on a mutation, small ones are
        # detached (materialized) so they stop pinning the old snapshot
        self.live_lazy: weakref.WeakSet = weakref.WeakSet()

    @property
    def n(self) -> int:
        return (0 if self._batch is None else self._batch.n) + self._pending_n

    @property
    def batch(self) -> FeatureBatch | None:
        self.flush()
        return self._batch

    @property
    def vis(self) -> np.ndarray | None:
        """The flushed rows' visibility labels (None: no row has one)."""
        self.flush()
        return self._vis

    def append(self, batch: FeatureBatch, visibilities=None):
        # validate everything BEFORE mutating: a failed write must not
        # leave batch and labels misaligned
        vis = None
        if visibilities is not None:
            vis = np.asarray(visibilities, dtype=object)
            if len(vis) != batch.n:
                raise ValueError("visibilities length mismatch")
            distinct = set(v for v in vis.tolist() if v)
            validate_labels(self.sft, distinct)  # raises on malformed
            if distinct:
                self.has_vis = True
            else:
                vis = None
        self._pending.append((batch, vis))
        self._pending_n += batch.n
        self._detach_live()

    def _detach_live(self):
        for lb in list(self.live_lazy):
            lb.detach()
        self.live_lazy.clear()

    def _millis(self, batch: FeatureBatch) -> np.ndarray:
        dtg = self.sft.dtg_field
        return (batch.col(dtg).millis if dtg is not None
                else np.zeros(batch.n, dtype=np.int64))

    def flush(self):
        if not self._pending:
            return
        delta = FeatureBatch.concat_all([b for b, _ in self._pending])
        can_merge = (self._batch is not None and not self.dirty
                     and self.scan_data is not None)
        old_n = 0 if self._batch is None else self._batch.n
        if self._vis is not None or any(v is not None
                                        for _, v in self._pending):
            self._vis = np.concatenate(
                [self._vis if self._vis is not None
                 else np.full(old_n, None, dtype=object)]
                + [np.full(b.n, None, dtype=object) if v is None else v
                   for b, v in self._pending])
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

    def delete(self, ids: set[str]):
        """Drop the rows with these feature ids. The device columns,
        z-index, host split, attribute indexes and residual columns go
        too (the in-place append path assumes rows only grow); the next
        read rebuilds them from the kept rows."""
        self._detach_live()
        self.flush()
        if self._batch is None:
            return
        keep = ~np.isin(self._batch.ids.astype(str), list(ids))
        self._batch = self._batch.take(np.flatnonzero(keep))
        if self._vis is not None:
            self._vis = self._vis[keep]
        self.scan_data = None
        self.zindex = None
        self.host_xhi = self.host_yhi = None
        self.attr_idx.clear()
        self.devcols = None
        self.dirty = True

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

    @_synchronized
    def remove_schema(self, type_name: str):
        """Drop a type and its rows. Its device tensors lose their last
        reference here, so their memory returns to the allocator."""
        st = self._types.pop(type_name, None)
        if st is not None:
            # outstanding small lazy results must not pin the dropped
            # column snapshot
            st._detach_live()

    # -- writes --------------------------------------------------------------

    @_synchronized
    def write(self, type_name: str, batch: FeatureBatch, visibilities=None):
        """Append a batch; ``visibilities`` gives one label per row (None
        or "" for world-readable; per-attribute, comma-joined, when the
        schema's visibility level is 'attribute')."""
        st = self._state(type_name)
        if batch.sft != st.sft:
            raise ValueError("batch schema does not match store schema")
        st.append(batch, visibilities)

    @_synchronized
    def delete(self, type_name: str, ids):
        """Remove the features with these ids."""
        self._state(type_name).delete(set(map(str, ids)))

    @_synchronized
    def count(self, type_name: str) -> int:
        return self._state(type_name).n

    # -- queries -------------------------------------------------------------

    def _as_query(self, q: Query | str, type_name: str | None) -> Query:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        unknown = set(q.hints) - {QueryHints.QUERY_INDEX, QueryHints.SAMPLING,
                                  QueryHints.SAMPLE_BY}
        if unknown:
            raise _later(f"query hints {sorted(unknown)}",
                         "stats/arrow pushdown")
        return q

    @_synchronized
    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        explain = Explainer(explain_out)
        explain.push(lambda: f"Planning '{q.type_name}' filter={q.filter}")
        idx, strategy, attr_mask = self._matching_rows(q, st, explain)
        if strategy.index == "empty":
            explain.pop()
            return QueryResult(idx, np.empty(0, dtype=object), None, explain,
                               strategy)
        return self._finish_query(q, st, idx, attr_mask, strategy, explain)

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
        one-element list, go through ``query()`` entirely. The fused
        queries take the same post-scan stages as ``query()``:
        visibility, sampling, sort, max_features and projection."""
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
                idx, attr_mask = self._post_scan(q, st, idx, explain)
                results[i] = self._finish_query(q, st, idx, attr_mask,
                                                strategy, explain)
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
        """Count without gathering ids or columns: the same row
        selection (plan, scan, visibility, sampling), then the length."""
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        idx, _, _ = self._matching_rows(q, st, Explainer())
        n = len(idx)
        return n if q.max_features is None else min(n, q.max_features)

    def _matching_rows(self, q: Query, st: _TypeState, explain: Explainer):
        """The shared row-selection pipeline: plan, scan, visibility,
        sampling. (idx, strategy, attr_mask): attr_mask is the rows'
        attribute authorization matrix on an attribute-level schema with
        labels, else None."""
        _check_filter(q.filter)
        if st.n == 0:
            explain("Store is empty")
            return (np.empty(0, dtype=np.int64),
                    FilterStrategy("empty", None, None), None)
        strategy = decide_strategy(st.sft, q, _indices(st.sft), st.n,
                                   explain=explain)
        idx = self._execute(st, strategy, explain)
        idx, attr_mask = self._post_scan(q, st, idx, explain)
        return idx, strategy, attr_mask

    def _post_scan(self, q: Query, st: _TypeState, idx: np.ndarray,
                   explain: Explainer):
        """Post-scan row stages shared by the scalar and batched
        pipelines: visibility filtering (row- or attribute-level) and
        statistical sampling. Returns (idx, attr_mask)."""
        attr_mask = None
        if q.auths is not None or st.has_vis:
            auths = q.auths or []
            if st.sft.visibility_level == "attribute" and st.has_vis:
                # a row survives when ANY of its attributes is
                # authorized; the mask rides along (aligned with idx)
                # so materialization nulls cells without re-parsing
                m = _attr_vis_masks(st.vis[idx], len(st.sft.attributes),
                                    auths)
                keep = m.any(axis=1)
                idx = idx[keep]
                attr_mask = m[keep]
                # leak guard: the scan matched on RAW values, but the
                # caller must not learn hidden cells through the
                # predicate. Re-evaluate on the NULLED view; hidden
                # cells compare as NULL (UNKNOWN -> excluded).
                if (not attr_mask.all()
                        and not isinstance(q.filter, ast.Include)):
                    refd = ast.props_of(q.filter)
                    by_name = {a.name: j for j, a
                               in enumerate(st.sft.attributes)}
                    hidden_refd = [a for a in refd if a in by_name
                                   and not attr_mask[:, by_name[a]].all()]
                    if hidden_refd:
                        sub = st.batch.take(idx)
                        cols = dict(sub.columns)
                        for a in hidden_refd:
                            cols[a] = _null_cells(
                                sub.col(a), ~attr_mask[:, by_name[a]])
                        nulled = FeatureBatch(sub.sft, sub.ids, cols)
                        ok = np.asarray(evaluate(q.filter, nulled),
                                        dtype=bool)
                        idx = idx[ok]
                        attr_mask = attr_mask[ok]
                explain(f"Attribute-level visibility filter applied "
                        f"({len(auths)} auths)")
            else:
                if st.has_vis:
                    idx = idx[evaluate_visibilities(st.vis[idx], auths)]
                explain(f"Visibility filter applied ({len(auths)} auths)")

        rate = q.hints.get(QueryHints.SAMPLING)
        if rate is not None and len(idx):
            by_attr = q.hints.get(QueryHints.SAMPLE_BY)
            by = None
            if by_attr is not None:
                by = _sample_keys(st.batch.col(by_attr), idx)
            smask = sample_mask(len(idx), float(rate), by)
            idx = idx[smask]
            if attr_mask is not None:
                attr_mask = attr_mask[smask]
            explain(f"Sampling applied: rate={rate}")
        return idx, attr_mask

    def _finish_query(self, q: Query, st: _TypeState, idx: np.ndarray,
                      attr_mask, strategy: FilterStrategy,
                      explain: Explainer) -> QueryResult:
        """Result assembly shared by the scalar and batched pipelines:
        sort, max_features, projection check, lazy batch with
        attribute-cell redaction, id gather. (The reference's query
        metrics and audit record wait for the serving item of ROADMAP.md
        section 6, queue 1.)"""
        if q.sort_by is not None:
            hidden = None
            if attr_mask is not None:
                # hidden sort values must not leak through the row
                # ordering: they sort as NULL
                aj = {a.name: j for j, a
                      in enumerate(st.sft.attributes)}.get(q.sort_by)
                if aj is not None:
                    hidden = ~attr_mask[:, aj]
            order = sort_order(st.batch, q.sort_by, q.sort_desc, idx,
                               hidden=hidden)
            idx = idx[order]
            if attr_mask is not None:
                attr_mask = attr_mask[order]
        if q.max_features is not None:
            idx = idx[:q.max_features]
            if attr_mask is not None:
                attr_mask = attr_mask[:q.max_features]
        if q.properties is not None:
            # validate projection names now: errors belong to query(),
            # not to whenever (or whether) .batch is first read
            missing = [p for p in q.properties if p not in st.batch.columns]
            if missing:
                raise KeyError(f"unknown propert"
                               f"{'ies' if len(missing) > 1 else 'y'}: "
                               f"{', '.join(missing)}")
        batch: Any = _LazyBatch(st.batch, idx, q.properties,
                                row_order=q.sort_by is None)
        st.live_lazy.add(batch)
        if attr_mask is not None and not attr_mask.all():
            # null unauthorized attribute values in the result rows
            # (KryoVisibilityRowEncoder: the row is assembled from the
            # cells the scanner's auths can see)
            mb = batch.materialize()
            by_name = {a.name: j for j, a in enumerate(st.sft.attributes)}
            cols = {}
            for a in mb.sft.attributes:
                bad = ~attr_mask[:, by_name[a.name]]
                cols[a.name] = (_null_cells(mb.col(a.name), bad)
                                if bad.any() else mb.col(a.name))
            batch = FeatureBatch(mb.sft, mb.ids, cols)
        if isinstance(batch, FeatureBatch):
            ids = batch.ids
        elif len(idx) <= 100_000:
            # eager id gather (the result's identity), lazy columns
            ids = st.batch.ids[idx]
        else:
            # deferred gather against the immutable batch snapshot:
            # large results are often counted or read by column only
            src = st.batch
            ids = (lambda: src.ids[idx])
        explain(f"Hits: {len(idx)}").pop()
        return QueryResult(idx, ids, batch, explain, strategy)

    # -- pushdowns -----------------------------------------------------------

    @_synchronized
    def density(self, type_name: str, ecql, bbox, width: int, height: int,
                weight_attr: str | None = None) -> np.ndarray:
        """Density surface (DensityScan pushdown analog): the float32
        (height, width) heatmap of the matching features over ``bbox``,
        each weighted by ``weight_attr`` (a null weight drops the row),
        summed by the density kernel on the store's device. Computed on
        every call (the reference's result cache waits for the serving
        item of ROADMAP.md section 6, queue 1)."""
        st = self._state(type_name)
        if st.n == 0:
            return np.zeros((height, width), dtype=np.float32)
        res = self.query(Query(type_name, ecql))
        if res.n == 0:
            return np.zeros((height, width), dtype=np.float32)
        x, y, mask, w = density_columns(res, st.sft.geom_field, bbox,
                                        weight_attr)
        return density_grid(x, y, mask, bbox, width, height, w,
                            device=self.device)

    @_synchronized
    def bin_query(self, type_name: str, ecql, track: str | None = None,
                  label: str | None = None, sort: bool = False) -> bytes:
        """BIN-format results (BinAggregatingScan analog): 16-byte (or
        24-byte labeled) records of the matching features."""
        st = self._state(type_name)
        res = self.query(Query(type_name, ecql))
        if res.batch is None or res.batch.n == 0:
            return b""
        return encode_bin_batch(st.sft, res.ids, res.batch, track=track,
                                label=label, sort=sort)

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


def density_columns(res: QueryResult, geom_field: str, bbox,
                    weight_attr: str | None = None):
    """(x, y, mask, weights) of a query result for the density grid:
    the point coordinates (f64), the rows to count (a valid point, and a
    valid weight when weighted), and the weights (None: unit). Only
    these columns of the result are copied. Invalid points sit at the
    bbox corner, masked."""
    col = res.column(geom_field)
    mask = col.valid.copy()
    w = None
    if weight_attr is not None:
        wcol = res.column(weight_attr)
        w = np.where(wcol.valid, wcol.values, 0.0).astype(np.float32)
        mask &= wcol.valid
    x = np.where(col.valid, col.x, bbox[0])
    y = np.where(col.valid, col.y, bbox[1])
    return x, y, mask, w


def _sample_keys(col, idx: np.ndarray) -> np.ndarray:
    """SAMPLE_BY group keys of rows ``idx`` as strings, a null as the
    empty string (sample_mask's argsort needs a total order); a string
    column through its vocabulary, any other column value by value."""
    if isinstance(col, StringColumn):
        codes = col.codes[idx]
        return np.where(codes >= 0, col.vocab[np.maximum(codes, 0)],
                        "").astype(str)
    return np.array([col.value(int(i)) or "" for i in idx],
                    dtype=object).astype(str)


def _project_sft(sft: SimpleFeatureType, props: list[str]) -> SimpleFeatureType:
    return SimpleFeatureType(
        sft.type_name, [a for a in sft.attributes if a.name in props],
        sft.user_data)


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
