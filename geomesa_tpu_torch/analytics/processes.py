"""Analytic processes over a datastore (geomesa-process analogs): KNN
search, proximity search, unique values, min/max, tube select, each the
WPS-process API shape minus GeoServer.

The device joins and tube select run on the store's resident columns
(its device) or, for a filtered subset, on the store's device. The
geohash-spiral KNN runs one BBOX query per geohash cell through the
store's scan kernels."""

from __future__ import annotations

import numpy as np

from ..features.batch import PointColumn
from ..index.api import Query
from ..stats import EnumerationStat, MinMax
from .join import contains_join, dwithin_join, knn, knn_batched
from .tube import TubeBuilder, tube_select_rows


__all__ = ["knn_process", "knn_batch_process", "contains_process",
           "knn_spiral_process", "proximity_process",
           "unique_process", "minmax_process", "tube_select_process",
           "sampling_process", "query_process", "join_process",
           "point2point_process", "track_label_process",
           "route_search_process", "hash_attribute_process",
           "arrow_conversion_process", "bin_conversion_process",
           "length_spheroid_process", "geohash_process",
           "geohash_decode_process"]


def _point_cols(store, type_name):
    st = store._state(type_name)
    if st.batch is None or st.n == 0:
        return st, None
    col = st.batch.col(st.sft.geom_field)
    if not isinstance(col, PointColumn):
        raise TypeError("process requires a point geometry type")
    return st, col


def _resident_xy(st):
    """The type's device-resident f32 coordinate columns (built by
    ensure_index), so processes scan without re-uploading the table."""
    try:
        st.ensure_index()
    except Exception:
        return None
    sd = getattr(st, "scan_data", None)
    return None if sd is None else (sd.xhi, sd.yhi)


def _knn_zring(st, col, qx: float, qy: float, k: int):
    """Z-index ring-expansion KNN: the reference's iterative geohash
    spiral (knn/KNNQuery.scala:27-81) with its distance-bounded cut
    (knn/GeoHashSpiral.scala:53,80), re-keyed to the z2 sorted index —
    grow a box around the query until it provably contains the k
    nearest (the kth candidate distance fits inside the box radius),
    then exact f64 top-k over just the in-box rows. Touches O(rows
    near q), never the full table. Returns (distances, rows) ascending,
    or None when the index is unavailable / the region is too dense for
    the host tier (caller falls back to the device KNN kernel)."""
    if k <= 0:
        return np.empty(0), np.empty(0, dtype=np.int64)
    try:
        st.ensure_index()
    except Exception:
        return None
    zi = st.zindex
    if zi is None or st.n == 0:
        return None
    from ..index.zkeys import search_rows
    # initial radius sized so the box holds ~2k points at the GLOBAL
    # density (8k/pi in the box); local density deviations just mean an
    # extra doubling or a one-round shrink via the dk bound
    rho = max(st.n, 1) / (360.0 * 180.0)
    r = float(np.sqrt(2.0 * k / (np.pi * rho)))
    cap = 2_000_000  # host-tier ceiling; denser regions use the kernel
    for _ in range(64):
        if (qx - r <= -180.0 and qx + r >= 180.0
                and qy - r <= -90.0 and qy + r >= 90.0):
            # ring covers the world: the candidate set is the whole
            # table, which is exactly what the KNN kernel is for
            return None
        box = (max(qx - r, -180.0), max(qy - r, -90.0),
               min(qx + r, 180.0), min(qy + r, 90.0))
        kind, rows = search_rows(zi, "z2", [box], [], cap, cap)
        if kind != "exact":
            return None
        if len(rows) >= k:
            dx = col.x[rows] - qx
            dy = col.y[rows] - qy
            d2 = dx * dx + dy * dy
            # (distance, row) tiebreak, same as the KNN kernel: an
            # argpartition cut picks an arbitrary member of a distance
            # tie at the k boundary, so gather every candidate within
            # the kth distance first, then break ties on row id
            part = (np.argpartition(d2, k - 1)[:k]
                    if len(rows) > k else np.arange(len(rows)))
            kth = d2[part].max()
            cand = np.flatnonzero(d2 <= kth)
            top = cand[np.lexsort((rows[cand], d2[cand]))[:k]]
            dk = float(np.sqrt(d2[top].max()))
            if dk <= r:
                return np.sqrt(d2[top]), rows[top]
            # candidates found but the kth may lie outside the box:
            # one more round with the proven cover radius
            r = dk * (1.0 + 1e-12)
        else:
            r *= 2.0
    return None


def knn_process(store, type_name: str, qx, qy, k: int, ecql=None):
    """KNearestNeighborSearchProcess (knn/KNearestNeighborSearchProcess.scala:30):
    k nearest features to the query point, optionally pre-filtered.

    ``qx``/``qy`` may be arrays — the reference process takes a
    *collection* of query features; a multi-query call routes through
    the batched call (knn_batch_process) and returns a list
    of (ids, distances) pairs, one per query point."""
    if np.ndim(qx) > 0:
        return knn_batch_process(store, type_name, qx, qy, k, ecql=ecql)
    st, col = _point_cols(store, type_name)
    if col is None:
        return np.empty(0, object), np.empty(0)
    if ecql is not None:
        res = store.query(Query(type_name, ecql))
        sub = res.batch
        if sub is None or sub.n == 0:
            return np.empty(0, object), np.empty(0)
        scol = sub.col(st.sft.geom_field)
        d, idx = knn(scol.x, scol.y, qx, qy, min(k, sub.n),
                     device=store.device)
        return sub.ids[idx], d
    pruned = _knn_zring(st, col, qx, qy, min(k, st.n))
    if pruned is not None:
        d, rows = pruned
        return st.batch.ids[rows], d
    d, idx = knn(col.x, col.y, qx, qy, min(k, st.n),
                 device_xy=_resident_xy(st), device=store.device)
    return st.batch.ids[idx], d


def knn_batch_process(store, type_name: str, qx, qy, k: int, ecql=None):
    """Batched KNN: ONE device call answers every query point
    (analytics/join.knn_batched) against the resident coordinate
    columns — Q queries cost one kernel launch + one transfer instead
    of Q round trips. Returns [(ids, distances), ...] per query,
    distances ascending with the id-stable tiebreak."""
    qx = np.atleast_1d(np.asarray(qx, np.float64))
    qy = np.atleast_1d(np.asarray(qy, np.float64))
    st, col = _point_cols(store, type_name)
    if col is None:
        return [(np.empty(0, object), np.empty(0)) for _ in qx]
    if ecql is not None:
        res = store.query(Query(type_name, ecql))
        sub = res.batch
        if sub is None or sub.n == 0:
            return [(np.empty(0, object), np.empty(0)) for _ in qx]
        scol = sub.col(st.sft.geom_field)
        d, idx = knn_batched(scol.x, scol.y, qx, qy, min(k, sub.n),
                             device=store.device)
        return [(sub.ids[idx[i]], d[i]) for i in range(len(qx))]
    d, idx = knn_batched(col.x, col.y, qx, qy, min(k, st.n),
                         device_xy=_resident_xy(st), device=store.device)
    return [(st.batch.ids[idx[i]], d[i]) for i in range(len(qx))]


def contains_process(store, type_name: str, polygons,
                     counts_only: bool = True):
    """Batched ST_Contains over the resident point columns: counts (and
    optionally matching feature ids) per polygon via the x-slab +
    crossing-number kernel (analytics/join.contains_join) — the
    points-vs-polygons join surface BASELINE config #5 measures.
    Returns (counts, None) or (counts, [ids_per_polygon, ...])."""
    st, col = _point_cols(store, type_name)
    k = len(polygons)
    if col is None:
        return (np.zeros(k, np.int64),
                None if counts_only else [np.empty(0, object)] * k)
    counts, pairs = contains_join(polygons, col.x, col.y,
                                  counts_only=counts_only,
                                  device_xy=_resident_xy(st),
                                  device=store.device)
    if counts_only:
        return counts, None
    ids = []
    for j in range(k):
        rows = pairs[pairs[:, 1] == j, 0] if len(pairs) else \
            np.empty(0, np.int64)
        ids.append(st.batch.ids[rows])
    return counts, ids


def knn_spiral_process(store, type_name: str, qx: float, qy: float, k: int,
                       estimated_distance: float = 1.0):
    """Geohash-spiral KNN (knn/KNNQuery.scala:27,34-81): iterate cells
    outward from the query point in distance order, run a bbox query per
    cell, keep a bounded PQ, and cut the spiral at the kth distance.

    Each cell's BBOX query runs through the store's scan kernels on its
    device; ``knn_process`` scans the whole column in one kernel top-k,
    and the spiral bounds the work when the store is huge and the query
    local (the reference's reason too).
    """
    from ..geohash import (BoundedNearestNeighbors, GeoHashSpiral,
                           decode_bbox, precision_for_radius)
    st, col = _point_cols(store, type_name)
    if col is None:
        return np.empty(0, object), np.empty(0)
    prec = precision_for_radius(estimated_distance)
    spiral = GeoHashSpiral(qx, qy, prec)
    nn = BoundedNearestNeighbors(k)
    for cell in spiral:
        xmin, ymin, xmax, ymax = decode_bbox(cell)
        res = store.query(Query(
            type_name, f"BBOX({st.sft.geom_field}, "
                       f"{xmin}, {ymin}, {xmax}, {ymax})"))
        if res.batch is not None and res.batch.n:
            c = res.batch.col(st.sft.geom_field)
            d = np.hypot(c.x - qx, c.y - qy)
            for dist, fid in zip(d, res.batch.ids):
                nn.offer(float(dist), fid)
        if nn.full:
            spiral.update_max_distance(nn.max_distance)
    pairs = nn.result()
    return (np.array([p[1] for p in pairs], dtype=object),
            np.array([p[0] for p in pairs]))


def proximity_process(store, type_name: str, qx, qy,
                      radius_deg: float, counts_only: bool = False):
    """ProximitySearchProcess (query/ProximitySearchProcess.scala:32):
    features within radius of any of the query points."""
    st, col = _point_cols(store, type_name)
    if col is None:
        return (np.zeros(len(np.atleast_1d(qx)), np.int64), None)
    counts, pairs = dwithin_join(col.x, col.y, np.atleast_1d(qx),
                                 np.atleast_1d(qy), radius_deg,
                                 counts_only=counts_only,
                                 device_xy=_resident_xy(st),
                                 device=store.device)
    if counts_only:
        return counts, None
    ids = st.batch.ids[np.unique(pairs[:, 0])] if len(pairs) else \
        np.empty(0, object)
    return counts, ids


def unique_process(store, type_name: str, attribute: str, ecql=None):
    """UniqueProcess: distinct attribute values with counts."""
    stat = store.stats_query(type_name, f"Enumeration({attribute})", ecql)
    assert isinstance(stat, EnumerationStat)
    return dict(stat.counts)


def minmax_process(store, type_name: str, attribute: str, ecql=None):
    """MinMaxProcess: attribute bounds over matching features."""
    stat = store.stats_query(type_name, f"MinMax({attribute})", ecql)
    assert isinstance(stat, MinMax)
    return stat.min, stat.max


def tube_select_process(store, type_name: str, track_x, track_y,
                        track_millis, buffer_deg: float,
                        bin_millis: int = 3_600_000, max_bins: int = 256):
    """TubeSelectProcess: features inside the space-time tube around the
    track (analytics/tube.TubeBuilder's pairs, evaluated by the tube
    kernel on the store's resident columns; only the hit rows come to
    the host). Returns matched feature ids, in row order."""
    st, col = _point_cols(store, type_name)
    if col is None:
        return np.empty(0, object)
    st.ensure_index()
    if st.scan_data is None:
        raise TypeError("tube select requires a point-indexed store")
    boxes, intervals = TubeBuilder(buffer_deg, bin_millis,
                                   max_bins).build(track_x, track_y,
                                                   track_millis)
    return st.batch.ids[tube_select_rows(st.scan_data, boxes, intervals)]


def sampling_process(store, type_name: str, ecql=None, rate: float = 0.1,
                     by: str | None = None):
    """SamplingProcess (process/vector/SamplingProcess): thin the result
    set to ~rate, optionally per `by`-attribute group."""
    from ..index.api import QueryHints
    q = Query(type_name, ecql or "INCLUDE")
    q.hints[QueryHints.SAMPLING] = rate
    if by is not None:
        q.hints[QueryHints.SAMPLE_BY] = by
    return store.query(q)


def query_process(store, type_name: str, ecql):
    """QueryProcess (process/query/QueryProcess): pass-through query —
    the WPS chaining primitive."""
    return store.query(Query(type_name, ecql))


def join_process(store, primary_type: str, join_type: str,
                 attribute: str, join_attribute: str | None = None,
                 ecql=None):
    """JoinProcess (process/query/JoinProcess): attribute equi-join —
    features of `join_type` whose `join_attribute` matches a value of
    `attribute` in the (optionally filtered) primary features."""
    join_attribute = join_attribute or attribute
    res = store.query(Query(primary_type, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return store.query(Query(join_type, "EXCLUDE"))
    col = res.batch.col(attribute)
    vals = {col.value(i) for i in range(res.batch.n)} - {None}
    if not vals:
        return store.query(Query(join_type, "EXCLUDE"))
    quoted = ", ".join(
        "'" + v.replace("'", "''") + "'" if isinstance(v, str) else str(v)
        for v in sorted(vals))
    return store.query(Query(join_type, f"{join_attribute} IN ({quoted})"))


def point2point_process(store, type_name: str, group_by: str,
                        sort_by: str | None = None, ecql=None):
    """Point2PointProcess (process/vector/Point2PointProcess): connect
    each group's time-ordered points into line segments. Returns
    {group: (k, 2, 2) segment array [[x0,y0],[x1,y1]]}."""
    st, col = _point_cols(store, type_name)
    if col is None:
        return {}
    q = Query(type_name, ecql or "INCLUDE")
    q.sort_by = sort_by or st.sft.dtg_field  # store sorts the results
    res = store.query(q)
    if res.batch is None or res.n == 0:
        return {}
    batch = res.batch
    gcol = batch.col(st.sft.geom_field)
    keys = np.array([batch.col(group_by).value(i) for i in range(batch.n)],
                    dtype=object)
    order = np.arange(batch.n)
    out = {}
    for g in set(keys.tolist()):
        rows = order[keys[order] == g]
        if len(rows) < 2:
            continue
        xs, ys = gcol.x[rows], gcol.y[rows]
        segs = np.stack([np.stack([xs[:-1], ys[:-1]], axis=1),
                         np.stack([xs[1:], ys[1:]], axis=1)], axis=1)
        out[g] = segs
    return out


def track_label_process(store, type_name: str, track: str, label: str,
                        ecql=None):
    """TrackLabelProcess (process/vector/TrackLabelProcess): reduce each
    track to its most recent point + label attribute. Returns
    {track: (x, y, label_value)}."""
    st, col = _point_cols(store, type_name)
    if col is None:
        return {}
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return {}
    batch = res.batch
    gcol = batch.col(st.sft.geom_field)
    tvals = np.array([batch.col(track).value(i) for i in range(batch.n)],
                     dtype=object)
    dtg = st.sft.dtg_field
    ms = (batch.col(dtg).millis if dtg is not None
          else np.arange(batch.n, dtype=np.int64))
    out = {}
    for t in set(tvals.tolist()):
        rows = np.flatnonzero(tvals == t)
        last = rows[np.argmax(ms[rows])]
        out[t] = (float(gcol.x[last]), float(gcol.y[last]),
                  batch.col(label).value(int(last)))
    return out


def route_search_process(store, type_name: str, route_x, route_y,
                         buffer_deg: float, ecql=None):
    """RouteSearchProcess (process/query/RouteSearchProcess): features
    within buffer_deg of a route polyline — the TubeBuilder's gap-fill
    densification + the device DWithin join against route vertices."""
    st, col = _point_cols(store, type_name)
    if col is None:
        return np.empty(0, object)
    route_x = np.asarray(route_x, np.float64)
    route_y = np.asarray(route_y, np.float64)
    # densify the polyline so vertex spacing <= buffer (LineGapFill
    # analog, tube/TubeBuilder.scala:182): the DWithin join against the
    # dense vertices then covers the whole route corridor
    dxs, dys = [route_x[:1]], [route_y[:1]]
    for i in range(len(route_x) - 1):
        seg = np.hypot(route_x[i + 1] - route_x[i],
                       route_y[i + 1] - route_y[i])
        steps = max(int(np.ceil(seg / max(buffer_deg, 1e-9))), 1)
        t = np.linspace(0, 1, steps + 1)[1:]
        dxs.append(route_x[i] + t * (route_x[i + 1] - route_x[i]))
        dys.append(route_y[i] + t * (route_y[i + 1] - route_y[i]))
    dx = np.concatenate(dxs)
    dy = np.concatenate(dys)
    if ecql is not None:
        res = store.query(Query(type_name, ecql))
        if res.batch is None or res.n == 0:
            return np.empty(0, object)
        batch = res.batch
        pcol = batch.col(st.sft.geom_field)
    else:
        batch = st.batch
        pcol = col
    # vertex prefilter radius covers the corridor between vertices
    # (worst case: point at buffer from a segment midpoint), then the
    # exact distance-to-polyline check runs on candidates only
    r_pre = float(np.hypot(buffer_deg, buffer_deg / 2))
    _, pairs = dwithin_join(pcol.x, pcol.y, dx, dy, r_pre,
                            device=store.device)
    hit = np.zeros(batch.n, dtype=bool)
    if len(pairs):
        cand = np.unique(pairs[:, 0])
        if len(route_x) < 2:
            # degenerate single-vertex route: plain radius test
            d2 = ((pcol.x[cand] - route_x[0]) ** 2
                  + (pcol.y[cand] - route_y[0]) ** 2)
            keep = d2 <= buffer_deg * buffer_deg
        else:
            from ..geometry.base import _point_segments_dist2
            coords = np.stack([route_x, route_y], axis=1)
            keep = np.array([
                _point_segments_dist2(pcol.x[i], pcol.y[i], coords)
                <= buffer_deg * buffer_deg for i in cand])
        hit[cand[keep]] = True
    return batch.ids[hit]


def hash_attribute_process(store, type_name: str, attribute: str,
                           modulo: int, ecql=None) -> np.ndarray:
    """HashAttributeProcess (process/transform/HashAttributeProcess):
    stable per-feature hash of an attribute mod `modulo` (coloring /
    partitioning aid)."""
    from ..scan.aggregations import _id_hashes
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, np.int64)
    col = res.batch.col(attribute)
    vals = np.array([str(col.value(i)) for i in range(res.batch.n)],
                    dtype=object)
    # java String.hashCode (shared with the BIN encoder) mod modulo;
    # numpy % with a positive divisor is non-negative
    return _id_hashes(vals).astype(np.int64) % modulo


def arrow_conversion_process(store, type_name: str, ecql=None) -> bytes:
    """ArrowConversionProcess (process/transform/ArrowConversionProcess
    :38): query results as Arrow IPC stream bytes."""
    import io

    import pyarrow as pa
    rb = store.arrow_query(type_name, ecql or "INCLUDE")
    if rb is None:  # empty result: stream with the schema, zero batches
        from ..features.batch import FeatureBatch
        sft = store.get_schema(type_name)
        rb = FeatureBatch.from_dict(
            sft, [], {a.name: [] for a in sft.attributes}).to_arrow()
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return sink.getvalue()


def bin_conversion_process(store, type_name: str, ecql=None,
                           track: str | None = None,
                           label: str | None = None) -> bytes:
    """BinConversionProcess (process/transform/BinConversionProcess):
    query results as BIN records."""
    return store.bin_query(type_name, ecql or "INCLUDE", track=track,
                           label=label)


def length_spheroid_process(store, type_name: str, attribute: str,
                            ecql=None) -> np.ndarray:
    """Per-feature WGS84 geodesic length of a geometry attribute
    (process form of ST_LengthSpheroid); NaN for null geometries."""
    from .st_functions import st_length_spheroid
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, np.float64)
    col = res.batch.col(attribute)
    return np.array([st_length_spheroid(g) if (g := col.value(i)) is not None
                     else np.nan for i in range(res.batch.n)], np.float64)


def geohash_process(store, type_name: str, attribute: str,
                    prec: int = 25, ecql=None) -> np.ndarray:
    """Per-feature geohash of a geometry attribute at ``prec`` bits
    (process form of ST_GeoHash); None for null geometries."""
    from .st_functions import st_geohash
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, object)
    col = res.batch.col(attribute)
    return np.array([st_geohash(g, prec) if (g := col.value(i)) is not None
                     else None for i in range(res.batch.n)], object)


def geohash_decode_process(hashes, prec: int | None = None) -> np.ndarray:
    """Geohash strings back to cell-bbox polygons (process form of
    ST_GeomFromGeoHash); None passes through."""
    from .st_functions import st_geom_from_geohash
    return np.array([st_geom_from_geohash(h, prec) if h is not None
                     else None for h in np.asarray(hashes, object)],
                    object)


def point_n_process(store, type_name: str, attribute: str, n: int,
                    ecql=None) -> np.ndarray:
    """Per-feature n-th vertex of a LineString attribute (process form
    of ST_PointN); None for nulls / non-lines / out of range."""
    from .st_functions import st_point_n
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, object)
    col = res.batch.col(attribute)
    return np.array([st_point_n(g, n) if (g := col.value(i)) is not None
                     else None for i in range(res.batch.n)], object)


def exterior_ring_process(store, type_name: str, attribute: str,
                          ecql=None) -> np.ndarray:
    """Per-feature polygon shell as a LineString (process form of
    ST_ExteriorRing); None for nulls / non-polygons."""
    from .st_functions import st_exterior_ring
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, object)
    col = res.batch.col(attribute)
    return np.array([st_exterior_ring(g) if (g := col.value(i)) is not None
                     else None for i in range(res.batch.n)], object)


def num_points_process(store, type_name: str, attribute: str,
                       ecql=None) -> np.ndarray:
    """Per-feature vertex count (process form of ST_NumPoints); -1 for
    null geometries (int column, no NaN slot)."""
    from .st_functions import st_num_points
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, np.int64)
    col = res.batch.col(attribute)
    return np.array([st_num_points(g) if (g := col.value(i)) is not None
                     else -1 for i in range(res.batch.n)], np.int64)


def translate_process(store, type_name: str, attribute: str,
                      dx: float, dy: float, ecql=None) -> np.ndarray:
    """Per-feature geometry shifted by (dx, dy) (process form of
    ST_Translate); None for null geometries."""
    from .st_functions import st_translate
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, object)
    col = res.batch.col(attribute)
    return np.array([st_translate(g, dx, dy)
                     if (g := col.value(i)) is not None
                     else None for i in range(res.batch.n)], object)


def idl_safe_geom_process(store, type_name: str, attribute: str,
                          ecql=None) -> np.ndarray:
    """Per-feature dateline-safe geometry (process form of
    ST_IdlSafeGeom, the st_antimeridianSafeGeom alias); None for null
    geometries."""
    from .st_functions import st_idl_safe_geom
    res = store.query(Query(type_name, ecql or "INCLUDE"))
    if res.batch is None or res.n == 0:
        return np.empty(0, object)
    col = res.batch.col(attribute)
    return np.array([st_idl_safe_geom(g)
                     if (g := col.value(i)) is not None
                     else None for i in range(res.batch.n)], object)
