"""In-memory datastore of point and extent schemas, with its scans on
the GPU.

    write(batch, visibilities=None)
                 -> host columns (pending until the next read)
    query(q)     -> plan (splitter + cost decider over z3, z2 (points) or
                    xz3, xz2 (extents), id, attr:<name> and fullscan;
                    cached per type on the filter object until the next
                    mutation), under the query reaper when the query has
                    a deadline (the TIMEOUT hint or geomesa.query.timeout,
                    checked after the plan and after the scan)
                 -> xz3/xz2: the XZ-key index's candidates evaluated
                    exactly on the host when there are at most
                    geomesa.scan.extent.host.rows (50,000) of them; else
                    the extent tristate kernel over every row, then the
                    exact f64 predicate on its MAYBE rows (on every
                    non-OUT row for a non-rectangular or relate/DWITHIN
                    predicate)
                 -> z3/z2: one of three tiers:
                    host-exact   z-index candidates evaluated in f64
                    gathered     scan kernel over the index candidates
                    dense        scan kernel over every row
                    -> exact f64 boundary patch of the kernel tiers
                    -> the exact geometry of a spatial predicate (an
                       INTERSECTS/WITHIN polygon: the point-in-polygon
                       kernel on every candidate set, then float64 on
                       its band rows; DWITHIN and the relate operators:
                       float64 on the host)
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
                    (attribute-level redaction materializes it); a plan
                    the planner proved empty gives an empty batch of the
                    (projected) schema, a type with no rows None
                 -> the store.scan timer, an SLO event and an audit
                    record, inside a store-scan span (obs/, audit/)
    query_batched(qs)
                 -> plan each query; the fusible ones of a type run as
                    ONE pass of the batched kernels (hits, boundary
                    candidates, compaction on the device), then the
                    per-query f64 patch, visibility, sampling and result
                    assembly; the rest go through query()
    density / bin_query / stats_query / arrow_ipc
                 -> the result cache (cache/): a canonical plan key and
                    the type's version (the WAL LSN when durable, else a
                    store-local counter, advanced by every create,
                    write, delete and remove), looked up outside the
                    store's lock; a hit decodes a private copy, and
                    concurrent misses of one key compute once
                 -> on a miss, under the lock:
    density(...) -> the query's rows (plan, scan, visibility; one
                    store-scan span and audit record, as a query's),
                    then only their ids to the device: the density kernel
                    reads the point (an extent's bounding-box centre) and
                    weight from the device columns, bins and sums them
    bin_query(...)
                 -> the query, then the BIN records on the host
    stats_query(type_name, spec, ecql)
                 -> INCLUDE: the sketch observes the stored rows; any
                    other filter: query() (visibility included), then
                    the sketch observes its result batch, on the host
    arrow_ipc    -> the query, then the result batch as an Arrow IPC
                    file (optionally sorted; pyarrow, imported when
                    called)
    arrow_query  -> the query's batch as a RecordBatch (not cached)
    analyze(type_name)
                 -> the type's stats recomputed from its rows
    delete(ids)  -> the rows dropped; the device columns, z-index and
                    attribute indexes rebuild on the next read; the
                    stats stay as they were until analyze()
    reindex(type_name, to_version=None)
                 -> a point schema's z-key sort orders rebuilt under the
                    z3 curve of the index version (1: the legacy curve,
                    2: the current one), then swapped in at once; the
                    old index serves every query until then
    remove_schema
                 -> the type, its stats and its device memory released
    InMemoryDataStore(durable_dir=..., wal_fsync=...)
                 -> the newest checkpoint that verifies, then the log's
                    records past it, replayed into the new store on its
                    device (wal/recovery.py); from then on every
                    mutation is validated, journaled (write-ahead, under
                    the fsync policy: "always", "interval" or "never"),
                    then applied. A log that failed a write or fsync is
                    poisoned: every later mutation raises
                    DurabilityError at the journal step, before any
                    state changes, and the store serves reads only.
    checkpoint(keep=2)
                 -> the host columns as a snapshot under
                    <durable_dir>/snapshots/ckpt-<lsn>/, read back and
                    verified, then the log truncated below the oldest
                    kept checkpoint; close() syncs and closes the log

Every write feeds the type's stats (``self.stats``: a row count,
count-min sketches of the indexed attributes and a z3 histogram, over a
strided sample of at most about 1M rows a write) before anything goes
to the device; the planner costs each strategy from them. Unlike the
JAX package, remove_schema drops the type's stats, so a re-created
type is costed from its own rows only (ROADMAP.md section 3).

A point schema's device columns (two-float coordinates, (day, ms)
times) live on the store's device with power-of-two capacity; appends
copy into that capacity in place and rebuild with fresh headroom only
when it runs out. Its z-key index sorts on the host, in the native
library (``native/``), under the z3 curve of the schema's index version
(``geomesa.index.version``). An extent schema's device columns
(outward-rounded f32 bounding boxes, validity, (day, ms) times) and its
XZ-key index rebuild on the first read after a write.

A schema has a default geometry (a Point, or any extent type:
LineString, Polygon, their multi-part forms, GeometryCollection or the
generic Geometry) or none: a geometry-less schema (an event table keyed
by attributes) has no device columns or z-index, and its queries take
the id, ``attr:<name>`` and fullscan strategies (the residual kernel
over the attribute columns where the candidates are dense); density,
BIN and the spatial processes raise KeyError for it, as in the JAX
package. Attributes: Integer, Long, Float, Double, Boolean, String,
Date and geometry (``:index=true`` on any). A schema may also declare
List, Map and Bytes attributes, as in the JAX package, whose
``_column_for`` refuses them too: writing such a column raises
ValueError (the SFB codec, ``features/codec.py``, serializes their
values one feature at a time). The filters are the ECQL grammar of
``filters/ecql.py`` against any geometry literal.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
import weakref
from typing import Any, Iterator

import numpy as np

from ..analytics.st_functions import contains_points
from ..features.batch import (FeatureBatch, GeometryColumn, PointColumn,
                              StringColumn)
from ..features.sft import (Configs, SimpleFeatureType, check_index_version,
                            parse_spec)
from ..filters import ast
from ..filters.ecql import parse_ecql
from ..filters.evaluate import evaluate
from ..filters.helper import (coerce_literals, extract_attribute_bounds,
                              extract_geometries,
                              extract_intervals, is_box, to_millis)
from ..geometry import MultiPolygon, Polygon
from ..index.api import Explainer, FilterStrategy, Query, QueryHints
from ..index.attr import AttributeKeyIndex
from ..index.planner import decide_strategy
from ..index.splitter import spatial_part
from ..index.xzkeys import XZKeyIndex
from ..index.zkeys import (SCAN_BLOCK_THRESHOLD, ZKeyIndex, prune_candidates,
                           search_rows)
from ..scan import gscan, residual, zscan
from ..scan.aggregations import density_rows, encode_bin_batch, sample_mask
from ..security import (evaluate_visibilities, parse_visibility,
                        validate_labels)
from ..security.visibility import distinct_labels
from ..stats import DataStoreStats, parse_stat
from ..utils.device import resolve_device
from ..utils.properties import QUERY_TIMEOUT, SystemProperty
from ..utils.threads import ManagedQuery, ThreadManagement
from .api import DataStore
from .common import sort_order

__all__ = ["InMemoryDataStore", "QueryResult"]

# process-wide query reaper (ThreadManagement.scala's 5 s sweep); its
# thread starts at the first query that carries a deadline
_REAPER = ThreadManagement()

# index-pruned candidate sets at or below this size evaluate exactly on
# the host in f64 instead of a device round trip; larger candidate sets
# ride the device kernels
HOST_SCAN_ROWS = SystemProperty("geomesa.scan.host.rows", "2000000")

# the extent pruned path re-checks candidates with per-geometry exact
# predicates (a Python loop, not the vectorized point math), so its
# crossover to the dense device tristate sits much lower
EXTENT_HOST_SCAN_ROWS = SystemProperty("geomesa.scan.extent.host.rows",
                                       "50000")

# ready the join and KNN paths (analytics/join.prewarm_join_kernels: the
# kernel library's build and the table's x-sort) at bulk-ingest time,
# so the first join or KNN query does not pay them
JOIN_PREWARM = SystemProperty("geomesa.join.prewarm", "true")

_WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)

# the hints query() reads (TIMEOUT: seconds, the query's deadline), and
# those the reference's query() accepts and ignores (its pushdowns take
# their parameters as arguments)
_READ_HINTS = frozenset({QueryHints.QUERY_INDEX, QueryHints.SAMPLING,
                         QueryHints.SAMPLE_BY, "TIMEOUT"})
_IGNORED_HINTS = frozenset({
    QueryHints.STATS_STRING, QueryHints.ENCODE_STATS,
    QueryHints.ARROW_ENCODE, QueryHints.ARROW_DICTIONARY_FIELDS,
    QueryHints.DENSITY_BBOX, QueryHints.DENSITY_WIDTH,
    QueryHints.DENSITY_HEIGHT, QueryHints.DENSITY_WEIGHT,
    QueryHints.BIN_TRACK, QueryHints.BIN_GEOM, QueryHints.BIN_DTG,
    QueryHints.BIN_LABEL, QueryHints.BIN_SORT, QueryHints.BIN_BATCH_SIZE,
    QueryHints.EXACT_COUNT, QueryHints.LOOSE_BBOX,
    QueryHints.COST_EVALUATION})


class _PlanArtifacts:
    """Filter-derived plan state reused across identical queries (cached
    next to the FilterStrategy in ``_TypeState.plan_cache``): the z3/z2
    scan inputs (query envelopes, millis intervals, whether an exact
    geometry predicate follows) and the scan query, whose box and
    interval tables stay on the store's device once uploaded. All of it
    derives from the filter alone, so it lives until the plan cache is
    cleared."""

    __slots__ = ("boxes", "intervals", "needs_exact", "sq")

    def __init__(self):
        self.boxes = None
        self.sq = None


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
    if isinstance(col, GeometryColumn):
        bounds = col.bounds.copy()
        bounds[bad] = np.nan
        return GeometryColumn(
            col.name, [None if b else g for g, b in zip(col.geoms, bad)],
            bounds)
    return dataclasses.replace(col, valid=np.asarray(col.valid) & ~bad)


class _TypeState:
    """Per-feature-type storage: host batch + lazily built index.

    Writes land in a pending list; the first read flushes it with one
    concat. Once the index exists, a flush appends the delta to the
    device columns in place (within capacity) and merges it into the
    z-key sort orders instead of rebuilding them. The attribute indexes
    and the residual's device columns are built on first use and dropped
    on every flush. An extent schema's tristate columns and XZ-key
    index rebuild on the first read after a flush. A delete drops every
    device and index structure; the next read rebuilds them from the
    kept rows."""

    def __init__(self, sft: SimpleFeatureType, device):
        self.sft = sft
        self.device = device
        self._batch: FeatureBatch | None = None
        # (batch, visibilities or None when no row has a label)
        self._pending: list[tuple[FeatureBatch, np.ndarray | None]] = []
        self._pending_n = 0
        self.scan_data: zscan.ScanData | None = None
        # an extent schema's tristate columns
        self.extent_data: gscan.ExtentScanData | None = None
        self.zindex: ZKeyIndex | XZKeyIndex | None = None
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
        # persisted z-key sort orders (ZKeyIndex.state_dict) that the
        # next index build adopts when they cover its rows
        self.zindex_warm: dict | None = None
        # (id(filter), QUERY_INDEX hint) -> (filter, FilterStrategy,
        # _PlanArtifacts): repeated queries skip the splitter, the cost
        # decision and the scan inputs' extraction. Cleared on every
        # mutation and analyze(): the row count and the stats feed the
        # decision
        self.plan_cache: dict = {}

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

    def validate(self, batch: FeatureBatch, visibilities=None):
        """The append's checks, without mutating: also the durable
        write's guard, since a record must be known applyable before it
        is journaled or replay would fail on it again. Returns the
        labels as an object array, or None when no row has one."""
        if visibilities is None:
            return None
        vis = np.asarray(visibilities, dtype=object)
        if len(vis) != batch.n:
            raise ValueError("visibilities length mismatch")
        distinct = set(v for v in vis.tolist() if v)
        validate_labels(self.sft, distinct)  # raises on malformed
        return vis if distinct else None

    def append(self, batch: FeatureBatch, visibilities=None):
        # validate everything BEFORE mutating: a failed write must not
        # leave batch and labels misaligned
        vis = self.validate(batch, visibilities)
        if vis is not None:
            self.has_vis = True
        self.zindex_warm = None      # persisted orders no longer these rows
        self.plan_cache.clear()
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
        self.zindex_warm = None
        self.plan_cache.clear()
        if self._batch is None:
            return
        keep = ~np.isin(self._batch.ids.astype(str), list(ids))
        self._batch = self._batch.take(np.flatnonzero(keep))
        if self._vis is not None:
            self._vis = self._vis[keep]
        self.scan_data = self.extent_data = None
        self.zindex = None
        self.host_xhi = self.host_yhi = None
        self.attr_idx.clear()
        self.devcols = None
        self.dirty = True

    def ensure_index(self):
        """(Re)build the device columns and the z-key (or XZ-key) index
        if writes happened since the last build."""
        self.flush()
        if self.sft.geom_field is None:
            # a geometry-less schema: nothing to build
            self.dirty = False
            return
        if not self.dirty and (self.scan_data is not None
                               or self.extent_data is not None):
            return
        col = self._batch.col(self.sft.geom_field)
        if isinstance(col, GeometryColumn):
            millis = (self._batch.col(self.sft.dtg_field).millis
                      if self.sft.dtg_field is not None else None)
            self.extent_data = gscan.build_extent_data(col.bounds, millis,
                                                       self.device)
            self.zindex = XZKeyIndex(col.bounds, millis, self.sft.z3_interval)
            self.dirty = False
            return
        millis = self._millis(self._batch)
        xhi, xlo = zscan.split_two_float(col.x)
        yhi, ylo = zscan.split_two_float(col.y)
        self.scan_data = zscan.build_scan_data(
            col.x, col.y, millis, self.device,
            cap=zscan.next_pow2(self._batch.n), xy_split=(xhi, xlo, yhi, ylo))
        self.host_xhi, self.host_yhi = xhi, yhi
        self.zindex = ZKeyIndex(col.x, col.y,
                                millis if self.sft.dtg_field else None,
                                self.sft.z3_interval,
                                version=self.sft.index_version)
        if self.zindex_warm is not None:
            self.zindex.load_state(self.zindex_warm)  # no-op when stale
            self.zindex_warm = None
        self.dirty = False

    def reindex(self, version: int):
        """Set the schema's index version. A built z-key index gets its
        z3 sort order rebuilt under that version's curve (the z2 order
        does not depend on it) and swapped in once it is whole; an
        index not built yet builds at that version on the next read."""
        self.flush()
        self.plan_cache.clear()
        old = self.zindex
        new = None
        if isinstance(old, ZKeyIndex) and not self.dirty:
            new = old.with_version(version)
        self.sft.user_data[Configs.INDEX_VERSION] = version
        if new is not None:
            self.zindex = new

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


def _grid_copy(grid: np.ndarray) -> np.ndarray:
    """The cache's encode and decode of a density grid: every hit hands
    out a private copy, so a caller scribbling on its grid cannot
    corrupt the memoized original."""
    return np.asarray(grid).copy()


class InMemoryDataStore(DataStore):
    """A GeoTools-DataStore-shaped API over device-resident columns.

    ``device=None`` means ``"cuda"``: the store runs on the GPU unless
    the caller asks for another device, and raises when CUDA is absent.

    ``audit`` is the store's ``AuditLogger``: every query and count
    records one ``QueryEvent`` there (None: the process-wide logger,
    ``audit.global_audit()``).

    ``durable_dir`` journals every mutation to a write-ahead log under
    that directory (validate, journal, then apply) and, at construction,
    recovers the newest checkpoint and the log's tail into the store on
    its device; ``wal_fsync`` is the log's fsync policy (None: the
    ``geomesa.wal.fsync`` property, "always" by default). The directory
    has the JAX package's layout, and either package recovers one the
    other wrote.
    """

    # bulk writes at or above this into an empty type build the index
    # (and ready the join paths) eagerly, so the first query finds it
    _EAGER_INDEX_ROWS = 5_000_000

    def __init__(self, device=None, audit=None,
                 durable_dir: str | None = None,
                 wal_fsync: str | None = None):
        self.device = resolve_device(device)
        self._op_lock = threading.RLock()
        self._types: dict[str, _TypeState] = {}
        self.stats = DataStoreStats()
        self.audit = audit  # AuditLogger, or None for the global one
        # the materialized pushdown cache (cache/): every mutation stamps
        # the type's version (the WAL LSN when durable, a store-local
        # counter otherwise), so density, stats, BIN and Arrow results
        # memoize until the type changes. Created before the journal:
        # recovery replays through write() and delete(), which stamp them
        from ..cache import ResultCache
        self._pushdown_clock = 0
        self._pushdown_versions: dict[str, int] = {}
        self.result_cache = ResultCache(self.pushdown_version)
        # evolve/: the per-type dual-feed taps of an in-flight shadow
        # schema build (empty: the write path pays one dict test), and
        # the Evolver behind them, built on first touch
        self._evolve_feeds: dict = {}
        self._evolver = None
        self.journal = None
        if durable_dir:
            from ..wal.durable import Journal
            self.journal = Journal(durable_dir, fsync=wal_fsync)
            self.journal.recover(self)

    # -- schema management -------------------------------------------------

    @_synchronized
    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        if sft.type_name in self._types:
            raise ValueError(f"schema {sft.type_name!r} already exists")
        if self.journal is not None:
            self.journal.log_create_schema(sft)
        self._types[sft.type_name] = self._new_state(sft)
        # an estimator from creation on: a type with no rows estimates 0
        self.stats.ensure(sft)
        self._bump_pushdown_version(sft.type_name)

    def _new_state(self, sft: SimpleFeatureType) -> _TypeState:
        """An empty type on the store's own device (an evolution's
        shadow is built here too, so it lives where the type lives)."""
        return _TypeState(sft, self.device)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._state(type_name).sft

    def get_type_names(self) -> list[str]:
        return sorted(self._types)

    def _state(self, type_name: str) -> _TypeState:
        if type_name not in self._types:
            raise KeyError(f"no such schema: {type_name}")
        if self._evolve_feeds:
            # a mid-flip evolution fences every op on its type typed
            # (SchemaEvolutionError) until resume() or abort() restores a
            # consistent state: exact or typed, never silently stale
            feed = self._evolve_feeds.get(type_name)
            if feed is not None:
                feed.guard()
        return self._types[type_name]

    @property
    def evolver(self):
        """The store's online schema-evolution plane (evolve/), built on
        first touch."""
        if self._evolver is None:
            with self._op_lock:
                if self._evolver is None:
                    from ..evolve import Evolver
                    self._evolver = Evolver(self)
        return self._evolver

    @_synchronized
    def remove_schema(self, type_name: str):
        """Drop a type, its rows and its stats. Its device tensors lose
        their last reference here, so their memory returns to the
        allocator."""
        if self.journal is not None and type_name in self._types:
            self.journal.log_drop_schema(type_name)
        st = self._types.pop(type_name, None)
        if st is not None:
            # outstanding small lazy results must not pin the dropped
            # column snapshot
            st._detach_live()
        self.stats.clear(type_name)
        self._bump_pushdown_version(type_name)
        self.result_cache.invalidate(type_name)

    # -- pushdown versions (cache/) ------------------------------------------

    def _bump_pushdown_version(self, type_name: str):
        """Stamp the type's version after a mutation: the WAL LSN when
        the journal advanced, a store-local counter otherwise (replay
        suppresses journaling, so the counter also covers recovery)."""
        prev = self._pushdown_versions.get(type_name, 0)
        v = self.journal.wal.last_lsn if self.journal is not None else 0
        if v <= prev:
            self._pushdown_clock += 1
            v = max(prev + 1, self._pushdown_clock)
        self._pushdown_versions[type_name] = v

    def pushdown_version(self, type_name: str) -> int:
        """The type's cache version: any change to its rows or schema
        advances it, and an unchanged version means identical pushdown
        results. Per type, so writes to one type never invalidate
        another's cached tiles."""
        return self._pushdown_versions.get(type_name, 0)

    def cache_status(self) -> dict:
        out = self.result_cache.status()
        out["versions"] = dict(self._pushdown_versions)
        return out

    def invalidate_cache(self, type_name: str | None = None) -> int:
        """Drop the cached pushdown results of one type (None: all);
        returns how many entries went."""
        return self.result_cache.invalidate(type_name)

    # -- writes --------------------------------------------------------------

    @_synchronized
    def write(self, type_name: str, batch: FeatureBatch, visibilities=None):
        """Append a batch; ``visibilities`` gives one label per row (None
        or "" for world-readable; per-attribute, comma-joined, when the
        schema's visibility level is 'attribute')."""
        st = self._state(type_name)
        if batch.sft != st.sft:
            raise ValueError("batch schema does not match store schema")
        if batch.sft is not st.sft:
            # an equal schema object of its own (a replayed record's, a
            # caller's parse): the stored rows share the type's object,
            # so reindex's version change reaches every one of them
            batch = FeatureBatch(st.sft, batch.ids, batch.columns)
        feed = self._evolve_feeds.get(type_name) \
            if self._evolve_feeds else None
        if feed is not None:
            # refuse before journaling: a write that conflicts with an
            # in-flight evolution (non-null values for a mid-drop
            # attribute) must never be acked
            feed.check_write(batch)
        if self.journal is not None:
            # write-ahead: validate (so the journaled record is known
            # applyable), journal, then apply
            st.validate(batch, visibilities)
            self.journal.log_write(type_name, batch, visibilities)
        was_empty = st.n == 0
        st.append(batch, visibilities)
        self._bump_pushdown_version(type_name)
        # the write-side stats (StatsCombiner analog), on the host batch
        self.stats.observe(st.sft, batch)
        if feed is not None:
            # dual-feed: a non-durable store queues the acked mutation
            # for the shadow build (a durable one tails the WAL)
            feed.on_write(batch, visibilities)
        # initial bulk load only: later chunks fold into one incremental
        # merge at the next read
        if was_empty and batch.n >= self._EAGER_INDEX_ROWS:
            try:
                st.ensure_index()
                self._prewarm_join(st)
            except MemoryError:
                raise
            except Exception:
                logging.getLogger("geomesa_tpu_torch").warning(
                    "ingest-time index build failed; falling back to "
                    "lazy build on first read", exc_info=True)

    @staticmethod
    def _prewarm_join(st: _TypeState):
        """Ready the join paths for this type's table during ingest
        (``geomesa.join.prewarm``): the kernel library's build and the
        resident columns' x-sort, as the reference compiles its join
        kernels there."""
        if str(JOIN_PREWARM.get()).lower() not in ("true", "1", "yes"):
            return
        sd = st.scan_data
        if sd is None:   # an extent schema: no point columns to join
            return
        from ..analytics.join import prewarm_join_kernels
        prewarm_join_kernels(device_xy=(sd.xhi, sd.yhi), nrows=st.n)

    @_synchronized
    def delete(self, type_name: str, ids):
        """Remove the features with these ids."""
        st = self._state(type_name)
        ids = set(map(str, ids))
        if self.journal is not None:
            self.journal.log_delete(type_name, sorted(ids))
        st.delete(ids)
        self._bump_pushdown_version(type_name)
        feed = self._evolve_feeds.get(type_name) \
            if self._evolve_feeds else None
        if feed is not None:
            feed.on_delete(ids)

    # -- durability (wal/, with durable_dir) ---------------------------------

    @_synchronized
    def checkpoint(self, keep: int = 2) -> dict:
        """Snapshot the store and compact the journal; needs
        ``durable_dir``. ``keep=2`` retains the prior checkpoint (and the
        log back to it), so recovery can fall back to it id for id if
        the newest snapshot is later found corrupt."""
        if self.journal is None:
            raise ValueError("store is not durable (no durable_dir)")
        return self.journal.checkpoint(self, keep=keep)

    def close(self):
        """Sync (unless the policy is "never") and close the journal."""
        if self.journal is not None:
            self.journal.close()

    @_synchronized
    def warm_index(self, type_name: str, state: dict):
        """Install persisted z-key sort orders (``index_state``'s dict,
        possibly memory-mapped) for the next index build to adopt. A
        stale state (another row count) or one from another index
        version installs nothing."""
        self._state(type_name).zindex_warm = state

    @_synchronized
    def index_state(self, type_name: str) -> dict | None:
        """The built z-key sort orders for persistence, or None when no
        index has been built yet (or the type's is an XZ index)."""
        st = self._state(type_name)
        if not isinstance(st.zindex, ZKeyIndex):
            return None
        return st.zindex.state_dict() or None

    @_synchronized
    def count(self, type_name: str) -> int:
        return self._state(type_name).n

    @_synchronized
    def reindex(self, type_name: str, to_version: int | None = None):
        """Migrate the type's z-index layout to ``to_version`` (None: the
        current version; an unknown one raises ValueError), as the
        reference's reindex jobs move a table to a new index version
        (GeoMesaFeatureIndex.scala:33-35): the z3 sort order is rebuilt
        under the new curve and swapped in at once, so the old index
        serves every query until then."""
        to_version = check_index_version(to_version)
        st = self._state(type_name)
        if st.sft.index_version != to_version:
            st.reindex(to_version)

    @_synchronized
    def analyze(self, type_name: str):
        """Recompute the type's stats from its rows (stats add up on
        write and go stale after deletes); returns the estimator, None
        for a type without rows."""
        st = self._state(type_name)
        self.stats.clear(type_name)
        st.plan_cache.clear()   # cached strategies used the stale stats
        if st.n:
            self.stats.observe(st.sft, st.batch)
        return self.stats.get(type_name)

    # -- queries -------------------------------------------------------------

    def _as_query(self, q: Query | str, type_name: str | None) -> Query:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        unknown = set(q.hints) - _READ_HINTS - _IGNORED_HINTS
        if unknown:
            raise NotImplementedError(
                f"query hints {sorted(unknown)} are not known to the "
                f"store's query()")
        return q

    @_synchronized
    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        explain = Explainer(explain_out)
        explain.push(lambda: f"Planning '{q.type_name}' filter={q.filter}")
        if st.n == 0:
            explain("Store is empty").pop()
            return QueryResult(np.empty(0, dtype=np.int64),
                               np.empty(0, dtype=object), None, explain,
                               FilterStrategy("empty", None, None))
        from ..obs import tracer
        with tracer.span("store-scan", q.type_name) as sp:
            idx, strategy, attr_mask, t_plan, t_scan0 = \
                self._matching_rows(q, st, explain)
            sp.set_attr(index=strategy.index, rows=int(st.n),
                        hits=int(len(idx)))
            return self._finish_query(q, st, idx, attr_mask, strategy,
                                      explain, t_plan, t_scan0)

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
            t_scan0 = time.perf_counter()
            from ..obs import tracer
            with tracer.span("store-scan", tn) as sp:
                sp.set_attr(fused=len(fused), rows=int(st.n))
                rows_per_q = self._batched_scan_rows(st,
                                                     list(fused.values()))
                for (i, (strategy, explain, _a)), idx in zip(
                        fused.items(), rows_per_q):
                    q = queries[i]
                    idx, attr_mask = self._post_scan(q, st, idx, explain)
                    results[i] = self._finish_query(
                        q, st, idx, attr_mask, strategy, explain, 0.0,
                        t_scan0, batched=True)
        return results  # type: ignore[return-value]

    def _plan_for(self, q: Query, st: _TypeState, explain: Explainer):
        """(strategy, artifacts) of ``q`` from the type's plan cache,
        keyed on the filter object and the QUERY_INDEX hint: the ECQL
        parse cache hands one shared AST per query string, so a repeated
        query skips the splitter, the cost decision and the scan inputs'
        extraction. The ``is`` check makes an id reused after a filter's
        collection harmless."""
        pkey = (id(q.filter), q.hints.get(QueryHints.QUERY_INDEX))
        hit = st.plan_cache.get(pkey)
        if hit is not None and hit[0] is q.filter:
            strategy, art = hit[1], hit[2]
            explain(lambda: f"Plan cache hit: {strategy.index}")
            return strategy, art
        strategy = decide_strategy(st.sft, _coerced(q, st.sft),
                                   _indices(st.sft), st.n,
                                   stats=self.stats.get(q.type_name),
                                   explain=explain)
        art = _PlanArtifacts()
        if len(st.plan_cache) >= 256:
            st.plan_cache.pop(next(iter(st.plan_cache)))
        st.plan_cache[pkey] = (q.filter, strategy, art)
        return strategy, art

    def _fusible_plan(self, q: Query, st: _TypeState, explain_out):
        """(strategy, explainer, artifacts) when the query can run in the
        batched scan: a z3/z2 strategy with no secondary filter and no
        exact geometry predicate (a rectangular INTERSECTS or WITHIN
        goes through query(), as in the reference); else None."""
        explain = Explainer(explain_out)
        explain.push(lambda: f"Batched '{q.type_name}' filter={q.filter}")
        strategy, art = self._plan_for(q, st, explain)
        if strategy.index not in ("z3", "z2") or strategy.secondary is not None:
            return None
        if _fill_artifacts(st.sft, strategy, art).needs_exact:
            return None
        return strategy, explain, art

    def _batched_scan_rows(self, st: _TypeState, plans) -> list[np.ndarray]:
        """One pass of the batched kernels over the stacked queries, then
        the per-query exact boundary patch on the candidates that the
        kernels compacted on the device (no per-query O(n) host work).
        ``plans`` are _fusible_plan's, all of one type."""
        st.ensure_index()
        sqs = [_scan_query(art) for _s, _e, art in plans]
        bq = zscan.stack_queries(sqs)
        hits, cands = zscan.batch_hit_rows(st.scan_data, bq)
        col = st.batch.col(st.sft.geom_field)
        millis = st._millis(st.batch)
        out = []
        for (_s, explain, _a), sq, rows, cand in zip(plans, sqs, hits,
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
        if st.n == 0:
            return 0
        from ..obs import tracer
        with tracer.span("store-scan", q.type_name) as sp:
            idx, strategy, _, t_plan, t_scan0 = self._matching_rows(
                q, st, Explainer())
            n = len(idx)
            if q.max_features is not None:
                n = min(n, q.max_features)
            sp.set_attr(index=strategy.index, rows=int(st.n), hits=n)
            from ..audit import audit_query
            audit_query(self.audit, "memory", q.type_name, str(q.filter),
                        q.hints, t_plan * 1000,
                        (time.perf_counter() - t_scan0) * 1000, n,
                        index=strategy.index, rows_scanned=int(st.n))
        return n

    def _matching_rows(self, q: Query, st: _TypeState, explain: Explainer):
        """The shared row-selection pipeline: plan, scan (under the query
        reaper: the TIMEOUT hint, else ``geomesa.query.timeout``, checked
        after the plan and after the scan), visibility, sampling. (idx,
        strategy, attr_mask, t_plan, t_scan0): attr_mask is the rows'
        attribute authorization matrix on an attribute-level schema with
        labels, else None; t_plan the plan's seconds; t_scan0 the
        ``perf_counter`` at the scan's start."""
        if st.n == 0:
            explain("Store is empty")
            return (np.empty(0, dtype=np.int64),
                    FilterStrategy("empty", None, None), None, 0.0,
                    time.perf_counter())
        managed = None
        timeout_s = q.hints.get("TIMEOUT") or QUERY_TIMEOUT.as_seconds()
        if timeout_s:
            managed = _REAPER.register(
                ManagedQuery(q.type_name, str(q.filter), float(timeout_s)))
        try:
            t_plan0 = time.perf_counter()
            strategy, art = self._plan_for(q, st, explain)
            t_plan = time.perf_counter() - t_plan0
            if managed is not None:
                managed.check()
            t_scan0 = time.perf_counter()
            idx = self._execute(st, strategy, explain, art)
            if managed is not None:
                managed.check()
        finally:
            if managed is not None:
                _REAPER.complete(managed)
        idx, attr_mask = self._post_scan(_coerced(q, st.sft), st, idx,
                                         explain)
        return idx, strategy, attr_mask, t_plan, t_scan0

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
                      explain: Explainer, t_plan: float, t_scan0: float,
                      batched: bool = False) -> QueryResult:
        """Result assembly shared by the scalar and batched pipelines:
        sort, max_features, projection check, lazy batch with
        attribute-cell redaction, id gather; then the query's
        ``store.scan`` timer, its SLO event and its audit record."""
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
        self._record_scan(q, st, strategy, t_plan, t_scan0, len(idx),
                          batched=batched)
        return QueryResult(idx, ids, batch, explain, strategy)

    def _record_scan(self, q: Query, st: _TypeState, strategy: FilterStrategy,
                     t_plan: float, t_scan0: float, hits: int,
                     batched: bool = False):
        """A finished scan's telemetry: the ``store.scan`` timer, its SLO
        event and its audit record (in the caller's context for a
        batcher's follower)."""
        scan_s = time.perf_counter() - t_scan0
        from ..metrics import metrics
        metrics.observe("store.scan", scan_s,
                        labels={"type": q.type_name,
                                "index": strategy.index or "none"})
        from ..obs.slo import slo_engine
        slo_engine.record("store.scan", ok=True, latency_s=scan_s)
        from ..audit import audit_query, caller_context
        record = functools.partial(
            audit_query, self.audit, "memory", q.type_name, str(q.filter),
            q.hints, t_plan * 1000, scan_s * 1000, hits,
            index=strategy.index, rows_scanned=int(st.n), batched=batched)
        ctx = caller_context(q)   # a batcher's follower: its own context
        ctx.run(record) if ctx is not None else record()

    # -- materialized pushdowns (cache/) -------------------------------------
    #
    # The public pushdowns are caching wrappers: the canonical plan key,
    # the type's version and single-flight coalescing are looked up
    # OUTSIDE _op_lock, so a repeated tile costs a dict lookup and a herd
    # of identical cold ones one kernel launch with no lock convoy. The
    # _*_uncached bodies hold the synchronized compute on the device.

    def density(self, type_name: str, ecql, bbox, width: int, height: int,
                weight_attr: str | None = None) -> np.ndarray:
        """Density surface (DensityScan pushdown analog): the float32
        (height, width) heatmap of the matching features over ``bbox``,
        each weighted by ``weight_attr`` (a null weight drops the row),
        summed by the density kernel on the store's device from the
        point and weight columns it keeps there (uploaded on first use),
        so only the matching row ids cross from the host. A point or
        weight that attribute-level visibility hides counts as null.
        Memoized at the type's version; every call gets its own copy."""
        from ..cache import density_key
        flt, key = density_key(ecql, bbox, width, height, weight_attr)
        return self.result_cache.get_or_compute(
            type_name, key,
            lambda: self._density_uncached(type_name, flt, bbox, width,
                                           height, weight_attr),
            encode=_grid_copy, decode=_grid_copy)

    def bin_query(self, type_name: str, ecql, track: str | None = None,
                  label: str | None = None, sort: bool = False) -> bytes:
        """BIN-format results (BinAggregatingScan analog): 16-byte (or
        24-byte labeled) records of the matching features, memoized at
        the type's version."""
        from ..cache import bin_key
        flt, key = bin_key(ecql, track, label, sort)
        return self.result_cache.get_or_compute(
            type_name, key,
            lambda: self._bin_query_uncached(type_name, flt, track=track,
                                             label=label, sort=sort))

    def stats_query(self, type_name: str, stat_spec: str, ecql=None):
        """A stat sketch over the query's rows (StatsScan analog): a new
        Stat each call, the caller's to keep or mutate. INCLUDE or None
        observes the stored rows; any other filter runs query(), so
        visibility applies, and observes its result batch. Memoized at
        the type's version in serialized form (stats/serialize.py), so
        every hit decodes a private copy."""
        from ..cache import stats_key
        from ..stats.serialize import deserialize_stat, serialize_stat
        flt, key = stats_key(ecql, stat_spec)
        return self.result_cache.get_or_compute(
            type_name, key,
            lambda: self._stats_query_uncached(type_name, stat_spec, flt),
            encode=serialize_stat, decode=deserialize_stat)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        """Arrow IPC file of the matching features, readable by
        FeatureArrowFileReader (the ARROW_ENCODE surface); ``sort_by``
        sorts the rows by an attribute. Memoized at the type's version.
        Needs pyarrow."""
        from ..cache import arrow_key
        flt, key = arrow_key(ecql, sort_by)
        return self.result_cache.get_or_compute(
            type_name, key,
            lambda: self._arrow_ipc_uncached(type_name, flt,
                                             sort_by=sort_by))

    @_synchronized
    def _density_uncached(self, type_name: str, ecql, bbox, width: int,
                          height: int,
                          weight_attr: str | None = None) -> np.ndarray:
        st = self._state(type_name)
        empty = np.zeros((height, width), dtype=np.float32)
        if st.n == 0:
            return empty
        # the scan is a query's: one store-scan span and one audit record
        q = Query(type_name, ecql)
        from ..obs import tracer
        with tracer.span("store-scan", type_name) as sp:
            idx, strategy, attr_mask, t_plan, t_scan0 = \
                self._matching_rows(q, st, Explainer())
            sp.set_attr(index=strategy.index, rows=int(st.n),
                        hits=int(len(idx)))
            self._record_scan(q, st, strategy, t_plan, t_scan0, len(idx))
        if not len(idx):
            return empty
        geom = st.sft.geom_field
        if geom is None:
            raise KeyError("density needs a geometry; the schema has none")
        if attr_mask is not None:
            by_name = {a.name: j for j, a in enumerate(st.sft.attributes)}
            keep = attr_mask[:, by_name[geom]]
            if weight_attr is not None:
                keep = keep & attr_mask[:, by_name[weight_attr]]
            idx = idx[keep]
        cols = st.device_cols()
        weight = None
        if weight_attr is not None:
            entry = cols.get(weight_attr)
            if entry["kind"] not in ("f64", "i64", "bool"):
                raise TypeError(f"density weight {weight_attr!r} is not a "
                                f"number or a boolean")
            weight = (entry["kind"], entry["slot"])
        return density_rows(idx, cols.get(geom)["slot"], weight, bbox, width,
                            height)

    @_synchronized
    def _bin_query_uncached(self, type_name: str, ecql,
                            track: str | None = None,
                            label: str | None = None,
                            sort: bool = False) -> bytes:
        st = self._state(type_name)
        res = self.query(Query(type_name, ecql))
        if res.batch is None or res.batch.n == 0:
            return b""
        if st.sft.geom_field is None:
            raise KeyError("BIN records need a geometry; the schema has none")
        return encode_bin_batch(st.sft, res.ids, res.batch, track=track,
                                label=label, sort=sort)

    @_synchronized
    def _stats_query_uncached(self, type_name: str, stat_spec: str,
                              ecql=None):
        st = self._state(type_name)
        stat = parse_stat(stat_spec)
        if st.n == 0:
            return stat
        flt = _as_filter(ecql)
        if isinstance(flt, ast.Include):
            stat.observe(st.batch)
            return stat
        res = self.query(Query(type_name, flt))
        if res.batch is not None and res.batch.n:
            stat.observe(res.batch)
        return stat

    @_synchronized
    def _arrow_ipc_uncached(self, type_name: str, ecql="INCLUDE",
                            sort_by: str | None = None) -> bytes:
        from ..arrow.scan import ArrowScan
        return ArrowScan(self).execute(type_name, _as_filter(ecql),
                                       sort_by=sort_by)

    @_synchronized
    def arrow_query(self, type_name: str, ecql):
        """The matching features as a pyarrow RecordBatch (ArrowScan
        analog); None when the type holds no rows. Needs pyarrow."""
        res = self.query(Query(type_name, _as_filter(ecql)))
        if res.batch is None:
            return None
        return res.batch.to_arrow()

    def _execute(self, st: _TypeState, strategy: FilterStrategy,
                 explain: Explainer, art: _PlanArtifacts) -> np.ndarray:
        """Run the chosen strategy; returns sorted matching row indices,
        in index space (an index-pruned scan never pays O(n) host work)."""
        if strategy.index == "empty":
            return np.empty(0, dtype=np.int64)
        if strategy.index in ("z3", "z2"):
            st.ensure_index()
            idx = self._device_scan(st, strategy, explain, art)
        elif strategy.index in ("xz3", "xz2"):
            st.ensure_index()
            idx = self._device_extent_scan(st, strategy, explain)
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
                     explain: Explainer, art: _PlanArtifacts) -> np.ndarray:
        """The hot path: z-range index pruning -> host-exact tier, or
        the scan kernel over gathered candidates or every row, + exact
        boundary patch + the polygon predicate of INTERSECTS/WITHIN.
        Returns sorted row indices."""
        _fill_artifacts(st.sft, strategy, art)
        boxes, intervals, needs_exact = (art.boxes, art.intervals,
                                         art.needs_exact)
        block_cap = int(float(SCAN_BLOCK_THRESHOLD.get()) * st.n)
        host_cap = min(block_cap, int(HOST_SCAN_ROWS.get()))
        kind, rows = search_rows(st.zindex, strategy.index, boxes,
                                 intervals, host_cap, block_cap)
        if kind == "exact":
            explain(f"Index-pruned host scan: {len(rows)} hit(s) of {st.n}, "
                    f"{len(boxes)} box(es), {len(intervals)} interval(s)")
            idx = rows
        else:
            sq = _scan_query(art)
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

    def _device_extent_scan(self, st: _TypeState, strategy: FilterStrategy,
                            explain: Explainer) -> np.ndarray:
        """The XZ-index scan of an extent schema: XZ-key candidates
        evaluated exactly on the host when few; else the extent tristate
        kernel over every row (definitely in, definitely out, or the
        boundary band) and the exact host predicate on the band only, or
        on every non-OUT row when the predicate is not the envelope's
        (the reference's XZ ranges plus its per-candidate JTS filter,
        curve/XZ2SFC.scala:146-252). Returns sorted row indices."""
        primary = (strategy.primary if strategy.primary is not None
                   else ast.Include())
        geom = st.sft.geom_field
        geoms = extract_geometries(primary, geom)
        boxes = [g.envelope.as_tuple() for g in geoms] or [_WHOLE_WORLD]
        intervals = (_intervals_ms(primary, st.sft.dtg_field)
                     if st.sft.dtg_field is not None
                     and strategy.index == "xz3" else [])
        max_rows = min(int(float(SCAN_BLOCK_THRESHOLD.get()) * st.n),
                       int(EXTENT_HOST_SCAN_ROWS.get()))
        rows = prune_candidates(st.zindex, strategy.index, boxes, intervals,
                                max_rows)
        if rows is not None:
            explain(f"XZ-pruned host scan: {len(rows)} candidate row(s) "
                    f"of {st.n}")
            if not len(rows):
                return rows
            return np.sort(rows[evaluate(primary, st.batch.take(rows))])

        # the states' copy to the host is the sync point
        state = gscan.extent_tristate(
            st.extent_data, gscan.extent_query(boxes, intervals)).cpu().numpy()
        explain(f"Device extent scan: {len(boxes)} box(es), "
                f"{len(intervals)} interval(s), n={st.n}")
        needs_exact = _needs_exact(geoms, primary)
        spatial_f, _ = spatial_part(primary, geom)
        if spatial_f is None:
            # no spatial constraint (a time-only query on xz3): every
            # non-OUT row matches
            return np.flatnonzero(state >= gscan.MAYBE)
        # an envelope's IN rows surely match; otherwise IN only proves
        # that the boxes meet, and every non-OUT row needs the predicate
        mask = (np.zeros(st.n, dtype=bool) if needs_exact
                else state == gscan.IN)
        check = np.flatnonzero(state >= gscan.MAYBE if needs_exact
                               else state == gscan.MAYBE)
        if len(check):
            mask[check[evaluate(spatial_f, st.batch.take(check))]] = True
            explain(f"Exact predicate on {len(check)} candidate(s)")
        return np.flatnonzero(mask)

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


def _fill_artifacts(sft: SimpleFeatureType, strategy: FilterStrategy,
                    art: _PlanArtifacts) -> _PlanArtifacts:
    """The scan inputs of a z3/z2 strategy on its plan artifacts, for
    the scalar and the batched scan alike (derived once a plan): the
    query envelopes (the whole world when the filter has none), the
    inclusive millis intervals (z3 only), and whether an exact geometry
    predicate (INTERSECTS, WITHIN, a non-rectangular geometry) must
    re-check the scan's rows."""
    if art.boxes is None:
        primary = (strategy.primary if strategy.primary is not None
                   else ast.Include())
        geoms = extract_geometries(primary, sft.geom_field)
        art.intervals = (_intervals_ms(primary, sft.dtg_field)
                         if sft.dtg_field is not None
                         and strategy.index == "z3" else [])
        art.needs_exact = _needs_exact(geoms, primary)
        art.boxes = [g.envelope.as_tuple() for g in geoms] or [_WHOLE_WORLD]
    return art


def _scan_query(art: _PlanArtifacts) -> zscan.ScanQuery:
    """The plan's padded scan query, built once: its box and interval
    tables move to a device at their first use there and stay."""
    if art.sq is None:
        art.sq = zscan.make_query(art.boxes, art.intervals)
    return art.sq


def _needs_exact(geoms, primary: ast.Filter) -> bool:
    """Whether the envelope test is not the whole predicate: a query
    geometry that is not a rectangle, or a DWITHIN or spatial predicate
    (INTERSECTS, WITHIN, the relate operators) in the filter."""
    return any(not is_box(g) for g in geoms) or any(
        isinstance(c, (ast.DWithin, ast.SpatialPredicate))
        for c in ast.walk(primary))


def _coerced(q: Query, sft: SimpleFeatureType) -> Query:
    """``q`` with its quoted Date and numeric literals as the attributes'
    types (filters/helper.coerce_literals)."""
    f = coerce_literals(q.filter, sft)
    return q if f is q.filter else dataclasses.replace(q, filter=f)


def _as_filter(ecql) -> ast.Filter:
    """An ECQL string, a filter, or None (match-all) as a filter."""
    if ecql is None:
        return ast.Include()
    if isinstance(ecql, ast.Filter):
        return ecql
    return parse_ecql(str(ecql))


def _indices(sft: SimpleFeatureType) -> list[str]:
    """The indexes a schema has: z3 (with a default date) and z2 for a
    point schema, xz3 and xz2 for an extent schema, none of these for a
    geometry-less one; id; and one attr:<name> per indexed attribute."""
    out = []
    if sft.geom_field is not None:
        z = "z" if sft.is_points else "xz"
        out = ([f"{z}3"] if sft.dtg_field is not None else []) + [f"{z}2"]
    return out + ["id"] + [f"attr:{a.name}" for a in sft.attributes
                           if a.indexed]


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
