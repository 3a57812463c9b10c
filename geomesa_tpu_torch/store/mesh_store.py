"""Mesh-distributed datastore: the multi-device execution tier.

One engine, two execution tiers: this store IS the single-device engine
(it subclasses InMemoryDataStore, inheriting the planner, attribute
strategies, visibility filtering, deletes, residual compilation, LSM
writes and the host z-key fast path), with the *device* tier swapped
out: the hot columns live as sharded segments over a mesh
(``parallel.data_mesh``: shards on torch devices, several on one card)
and wide scans run shard by shard with their reduces in shard order.
That mirrors the reference, where a single ``GeoMesaDataStore`` runs the
full query surface over every distributed backend (GeoMesaDataStore.
scala:38, with backends plugging in through IndexAdapter.scala:24-102;
here the "adapter" is the small set of device-tier hooks of
``store/memory.py``'s ``_TypeState`` that this module overrides).

Execution tiers per query (the single-device store's policy):

- selective queries resolve EXACTLY inside the host z-key index
  (index-space candidates, never an O(n) mask);
- mid-size candidate sets evaluate exactly on the host in f64 over just
  the gathered candidate rows;
- wide scans run the scan kernel on every shard with the exact f64
  boundary patch on the hit rows; counts and density grids reduce over
  the shards and never materialize row sets at all.

Writes are LSM-style at BOTH levels: host appends merge into the sorted
z-key index incrementally, and the device tier appends delta-sized
sharded SEGMENTS (re-shard cost proportional to the burst, the
minor-compaction shape); segments compact into one when they pile up.
The reference gets the same write path from BatchWriter mutations
merging into tablets at minor compaction.

The mesh's first device is the base store's ``device``, where the
inherited residual, attribute, density-of-rows and Arrow paths run.
"""

from __future__ import annotations

import time

import numpy as np

from ..features.batch import FeatureBatch, PointColumn
from ..features.sft import SimpleFeatureType
from ..filters import ast
from ..filters.helper import extract_geometries
from ..index.api import Explainer, Query, QueryHints
from ..index.planner import decide_strategy
from ..index.zkeys import SCAN_BLOCK_THRESHOLD, ZKeyIndex, search_rows
from ..parallel import (data_mesh, distributed_count, distributed_density,
                        distributed_histogram, distributed_knn,
                        distributed_tristate, exact_hit_rows,
                        shard_extent_data, shard_scan_data)
from ..parallel.mesh import batch_exact_hit_rows, shard_tensor
from ..scan import zscan
from .memory import (HOST_SCAN_ROWS, InMemoryDataStore, _coerced,
                     _indices, _intervals_ms, _needs_exact, _null_cells,
                     _scan_query, _synchronized, _TypeState)

__all__ = ["DistributedDataStore"]

# segment count past which a write burst declines to append (the next
# read compacts with one full re-shard): bounds per-query scan
# dispatches while keeping write bursts O(delta)
MAX_SEGMENTS = 8


class _MeshTypeState(_TypeState):
    """Per-type state whose device tier is a list of sharded segments
    (LSM runs): writes append delta-sized segments, reads scan every
    segment, compaction re-shards into one."""

    def __init__(self, sft: SimpleFeatureType, device, mesh):
        super().__init__(sft, device)
        self.mesh = mesh
        self.segments: list = []        # parallel.DistributedScanData runs
        self.ext_segments: list = []    # parallel.DistributedExtentData

    # -- device-tier hooks -------------------------------------------------

    def has_point_scan(self) -> bool:
        return bool(self.segments)

    def has_extent_scan(self) -> bool:
        return bool(self.ext_segments)

    def _clear_device_index(self):
        self.segments = []
        self.ext_segments = []

    def _build_point_index(self, x, y, millis):
        self.segments = [shard_scan_data(x, y, millis, self.mesh)]
        self.ext_segments = []

    def _build_extent_index(self, bounds, millis):
        self.ext_segments = [shard_extent_data(bounds, millis, self.mesh)]
        self.segments = []

    def _extend_device_index(self, col: PointColumn, dmillis) -> bool:
        """Write burst -> one new delta-sized sharded segment (cost
        proportional to the delta); False once MAX_SEGMENTS runs have
        piled up, leaving the state dirty so the next read compacts
        (full re-shard)."""
        if len(self.segments) >= MAX_SEGMENTS:
            return False
        self.segments.append(shard_scan_data(col.x, col.y, dmillis,
                                             self.mesh))
        return True

    def segment_offsets(self) -> list[int]:
        offs = [0]
        for seg in self.segments:
            offs.append(offs[-1] + seg.n)
        return offs


def _geom_centroids(batch: FeatureBatch, geom_field: str):
    """(x, y, valid) for any geometry column: point coords, or envelope
    centroids for extent geometries."""
    col = batch.col(geom_field)
    if isinstance(col, PointColumn):
        return col.x, col.y, col.valid
    bounds = col.bounds
    x = (bounds[:, 0] + bounds[:, 2]) / 2
    y = (bounds[:, 1] + bounds[:, 3]) / 2
    return x, y, col.valid


class DistributedDataStore(InMemoryDataStore):
    """Full-featured datastore sharded over a device mesh: the scale tier
    for 100M+-row tables (BASELINE.md north-star shape), with the
    complete single-device query surface. ``mesh=None`` means
    ``data_mesh()``: one shard a visible CUDA card, and an error without
    CUDA (pass ``data_mesh(k, device="cpu")`` to run on the CPU)."""

    def __init__(self, mesh=None, audit=None):
        mesh = mesh if mesh is not None else data_mesh()
        self.mesh = mesh
        super().__init__(device=mesh.devices[0], audit=audit)

    def _new_state(self, sft: SimpleFeatureType) -> _MeshTypeState:
        return _MeshTypeState(sft, self.device, self.mesh)

    # -- scan tiers over the sharded segments ------------------------------

    def _scan_gathered(self, st: _MeshTypeState, sq: zscan.ScanQuery,
                       rows: np.ndarray, explain: Explainer) -> np.ndarray:
        """Candidate sets between the host cap and the block threshold
        evaluate exactly on the host in f64 over just the gathered rows:
        index-space work, never an O(n) mask (a gather from the shards
        would move the candidates for no arithmetic advantage at this
        tier)."""
        explain(f"Index-pruned host candidate scan: {len(rows)} "
                f"candidate row(s) of {st.n}, {sq.n_boxes} box(es), "
                f"{len(sq.host_intervals)} interval(s)")
        col = st.batch.col(st.sft.geom_field)
        intervals = [] if sq.time_any else \
            [tuple(iv) for iv in sq.host_intervals]
        ms = st.batch.col(st.sft.dtg_field).millis if intervals else None
        boxes = [tuple(b) for b in sq.host_boxes]
        keep = ZKeyIndex._eval_sorted(col.x, col.y, ms, rows, boxes,
                                      intervals)
        return np.sort(rows[keep]).astype(np.int64)

    def _scan_dense(self, st: _MeshTypeState, sq: zscan.ScanQuery,
                    explain: Explainer) -> np.ndarray:
        """Dense tier: the scan kernel on every shard of every segment,
        the hit rows compacted on the shards' devices (O(hits) host work,
        never a full-length mask), the exact f64 boundary patch applied
        in row-set space."""
        explain(f"Distributed scan over {self.mesh.size} device(s), "
                f"{len(st.segments)} segment(s), n={st.n}, "
                f"{sq.n_boxes} box(es), {len(sq.host_intervals)} "
                f"interval(s)")
        offs = st.segment_offsets()[:-1]
        parts = [exact_hit_rows(seg, sq) + off
                 for seg, off in zip(st.segments, offs)]
        return (np.concatenate(parts) if parts
                else np.empty(0, dtype=np.int64))

    def _batched_scan_rows(self, st: _MeshTypeState,
                           plans) -> list[np.ndarray]:
        """Micro-batched dense tier over the sharded segments: on every
        shard of every segment one pass of the batched kernels evaluates
        every query of the batch (parallel.mesh.batch_exact_hit_rows),
        in place of the scalar path's per-query dispatch."""
        st.ensure_index()
        sqs = [_scan_query(art) for _s, _e, art in plans]
        bq = zscan.stack_queries(sqs)
        offs = st.segment_offsets()[:-1]
        per_query: list[list[np.ndarray]] = [[] for _ in sqs]
        for seg, off in zip(st.segments, offs):
            for j, rows in enumerate(batch_exact_hit_rows(seg, bq)):
                per_query[j].append(rows + off)
        out = []
        for (_s, explain, _a), sq, parts in zip(plans, sqs, per_query):
            explain(f"Fused distributed scan: query {len(out) + 1} of "
                    f"{bq.n_queries} over {self.mesh.size} device(s), "
                    f"{len(st.segments)} segment(s), {sq.n_boxes} box(es), "
                    f"{len(sq.host_intervals)} interval(s), n={st.n}")
            out.append(np.concatenate(parts) if parts
                       else np.empty(0, dtype=np.int64))
        return out

    def _extent_states(self, st: _MeshTypeState, eq) -> np.ndarray:
        return np.concatenate([distributed_tristate(seg, eq)
                               for seg in st.ext_segments])

    # -- aggregate pushdown (sums over the shards) -------------------------

    def _psum_plan(self, st: _MeshTypeState, q: Query):
        """(strategy, boxes, intervals) when the plan's result is fully
        decided by the shard-local kernel (a pure z envelope scan, no
        residual, no visibility, no sampling or limit stage), else None
        (the caller takes the shared row pipeline)."""
        strategy = decide_strategy(st.sft, _coerced(q, st.sft),
                                   _indices(st.sft), st.n,
                                   stats=self.stats.get(q.type_name),
                                   explain=Explainer())
        primary = (strategy.primary if strategy.primary is not None
                   else ast.Include())
        geoms = extract_geometries(primary, st.sft.geom_field)
        if (strategy.index not in ("z2", "z3")
                or strategy.secondary is not None
                or _needs_exact(geoms, primary)
                or st.has_vis or q.auths is not None
                or q.hints.get(QueryHints.SAMPLING) is not None
                or q.max_features is not None):
            return None
        boxes = [g.envelope.as_tuple() for g in geoms] or \
            [(-180.0, -90.0, 180.0, 90.0)]
        intervals = (_intervals_ms(primary, st.sft.dtg_field)
                     if st.sft.dtg_field is not None
                     and strategy.index == "z3" else [])
        return strategy, boxes, intervals

    @_synchronized
    def query_count(self, q: Query | str,
                    type_name: str | None = None) -> int:
        """Counts never materialize row sets on the dense tier: the
        selective path counts inside the host z-key index; wide
        sum-eligible scans count on every shard and sum (server-side
        aggregate -> client reduce, SURVEY §2.5#5) with the exact host
        boundary adjustment. Every other plan shape takes the shared
        pipeline."""
        q = self._as_query(q, type_name)
        st = self._state(q.type_name)
        if st.n == 0:
            return 0
        st.ensure_index()
        plan = self._psum_plan(st, q) if st.segments else None
        if plan is None:
            return super().query_count(q)
        strategy, boxes, intervals = plan
        t0 = time.perf_counter()
        host_cap = min(int(float(SCAN_BLOCK_THRESHOLD.get()) * st.n),
                       int(HOST_SCAN_ROWS.get()))
        kind, rows = search_rows(st.zindex, strategy.index, boxes,
                                 intervals, host_cap, host_cap)
        if kind == "exact":
            n = len(rows)
        else:
            sq = zscan.make_query(boxes, intervals)
            n = sum(distributed_count(seg, sq) for seg in st.segments)
        from ..audit import audit_query
        audit_query(self.audit, "mesh", q.type_name, str(q.filter),
                    q.hints, 0.0, (time.perf_counter() - t0) * 1000, n,
                    index=strategy.index, rows_scanned=int(st.n))
        return n

    @_synchronized
    def _density_uncached(self, type_name: str, ecql, bbox, width: int,
                          height: int,
                          weight_attr: str | None = None) -> np.ndarray:
        """Heatmap grid: per shard the scan and the density kernel, the
        grids summed over the shards (DensityScan -> client-reduce shape)
        for sum-eligible plans; the shared path over the result's rows
        otherwise. (The public ``density`` wrapper in the base class adds
        the materialized-result cache.)"""
        st = self._state(type_name)
        if st.n == 0 or weight_attr is not None:
            return super()._density_uncached(type_name, ecql, bbox, width,
                                             height, weight_attr)
        st.ensure_index()
        q = Query(type_name, ecql)
        plan = self._psum_plan(st, q) if st.segments else None
        if plan is None:
            return super()._density_uncached(type_name, ecql, bbox, width,
                                             height, weight_attr)
        _, boxes, intervals = plan
        sq = zscan.make_query(boxes, intervals)
        grid = np.zeros((height, width), dtype=np.float32)
        for seg in st.segments:
            grid += distributed_density(seg, sq, bbox, width, height)
        return grid

    @_synchronized
    def histogram(self, type_name: str, attribute: str, nbins: int,
                  lo: float, hi: float) -> np.ndarray:
        """Distributed attribute histogram: the column's f32 values
        sharded over the mesh, a bincount on every shard, the counts
        summed (StatsCombiner merge analog); int64 counts, np.histogram
        semantics."""
        st = self._state(type_name)
        if st.n == 0:
            return np.zeros(nbins, dtype=np.int64)
        vals = st.batch.col(attribute)
        v = np.asarray(getattr(vals, "values", getattr(vals, "millis", None)),
                       np.float64)
        n_padded = self.mesh.per(st.n) * self.mesh.size
        vp = np.full(n_padded, np.nan, np.float32)
        vp[:st.n] = v
        m = np.zeros(n_padded, dtype=bool)
        m[:st.n] = np.asarray(vals.valid)
        return distributed_histogram(shard_tensor(vp, self.mesh),
                                     shard_tensor(m, self.mesh), self.mesh,
                                     nbins, lo, hi)

    @_synchronized
    def _arrow_ipc_uncached(self, type_name: str, ecql="INCLUDE",
                            sort_by: str | None = None) -> bytes:
        """Distributed Arrow output (DeltaWriter.scala:47,203 shape): the
        row-selection pipeline runs once, matched rows split along the
        mesh's shard boundaries, every shard encodes ITS rows as an IPC
        payload with shard-local dictionaries, and the payloads merge
        into one stream with global dictionaries (arrow/scan.
        merge_deltas), the client-side reduce of the reference's
        server-side ArrowScan."""
        from ..arrow.io import sort_batches, write_ipc
        from ..arrow.scan import merge_deltas
        st = self._state(type_name)
        sft = st.sft
        if st.batch is None or st.n == 0:
            return merge_deltas([], sft=sft, sort_by=sort_by)
        q = ecql if isinstance(ecql, Query) else Query(type_name, ecql)
        idx, _strategy, attr_mask, _tp, _ts = self._matching_rows(
            q, st, Explainer())
        if not len(idx):
            return merge_deltas([], sft=sft, sort_by=sort_by)
        # matched ORIGINAL row ids split at the mesh's shard boundaries
        # (rows shard evenly in row order): each shard encodes its own
        # rows with shard-local dictionaries
        k = self.mesh.size
        per = self.mesh.per(st.n)
        shard_of = np.minimum(idx // max(per, 1), k - 1)
        payloads = []
        for s in np.unique(shard_of):
            sel = shard_of == s
            sub = st.batch.take(idx[sel])
            if attr_mask is not None and not attr_mask[sel].all():
                # query()'s cell-level redaction: unauthorized attribute
                # values must not leak through the Arrow surface
                # (KryoVisibilityRowEncoder semantics)
                m = attr_mask[sel]
                cols = {}
                for j, a in enumerate(sft.attributes):
                    col = sub.col(a.name)
                    bad = ~m[:, j]
                    cols[a.name] = (_null_cells(col, bad) if bad.any()
                                    else col)
                sub = FeatureBatch(sft, sub.ids, cols)
            if sort_by:
                # shard-local sort, so the client reduce is a streaming
                # k-way merge instead of a concat-then-sort (the
                # reference's tablets return sorted batches too)
                sub = sort_batches(sub, sort_by)
            payloads.append(write_ipc(sft, sub))
        return merge_deltas(payloads, sft=sft, sort_by=sort_by,
                            presorted=True)

    @_synchronized
    def knn(self, type_name: str, qx: float, qy: float, k: int) -> np.ndarray:
        """k nearest feature ids: every segment's shards prune to their
        candidates (which travel with their two-float coords), then an
        exact f64 re-rank of the segments' candidates on the host.

        The prune reads each segment's own scan columns (a departure from
        the reference, which keeps a second sharded two-float copy of the
        coordinates per segment: the same tensors bit for bit, 16 B a row
        more on the device)."""
        st = self._state(type_name)
        if st.n == 0:
            return np.empty(0, dtype=object)
        if st.sft.geom_field is None:
            raise ValueError("knn requires a geometry field")
        st.ensure_index()
        if not st.segments:
            # extent types: exact centroid ranking on the host
            x, y, valid = _geom_centroids(st.batch, st.sft.geom_field)
            d2 = np.where(valid, (x - qx) ** 2 + (y - qy) ** 2, np.inf)
            return st.batch.ids[np.argsort(d2, kind="stable")[:k]]
        col = st.batch.col(st.sft.geom_field)
        offs = st.segment_offsets()
        cands = []
        for i, seg in enumerate(st.segments):
            sp, valid, n = seg.knn_split()
            idx = distributed_knn(None, None, valid, self.mesh, n,
                                  qx, qy, k, split=sp)
            cands.append(np.asarray(idx, dtype=np.int64) + offs[i])
        cand = np.concatenate(cands)
        d2 = (col.x[cand] - qx) ** 2 + (col.y[cand] - qy) ** 2
        order = np.argsort(d2, kind="stable")
        return st.batch.ids[cand[order][:k]]
