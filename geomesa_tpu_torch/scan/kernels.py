"""The port's kernels: wrappers, launch counts and plain versions.

Twenty kernels, written in CUDA C++ for Hopper in ``csrc/scan.cu``,
``csrc/batch.cu``, ``csrc/geom.cu``, ``csrc/residual.cu``,
``csrc/density.cu``, ``csrc/extent.cu``, ``csrc/join.cu``,
``csrc/tube.cu`` and ``csrc/standing.cu`` (see the notes at their heads
for what they replace and what bounds them):

- ``scan_mask``: the dense tier, bool[cap] over every row;
- ``scan_mask_gather``: the gathered tier, bool[m] over rows ``idx``
  (int32), read from the row-major gather table (``ScanData.rows``);
- ``scan_count``: the predicate summed to one int32 on the device;
- ``scan_batch_bits``: a batch of Qp queries in one pass over the rows,
  as hit and boundary-candidate bitmaps int32[2, Qp, words] with
  per-block popcounts int32[2, Qp, nb], each query's own boxes and
  intervals only (a (Qp, 2) counts table);
- ``compact_prefix``: the exclusive prefix of those popcounts within each
  (kind, query), as int32 offsets, and each (kind, query) total as int64,
  in one pass over fixed tiles chained by a decoupled look-back (its
  status words and ticket counter in a scratch buffer kept per device
  and stream, ``prefix_plan``);
- ``compact_bits``: the bitmaps compacted into each query's ascending
  int32 row ids, one flat buffer per kind, with the per-query counts
  (it runs ``compact_prefix`` first);
- ``pip_mask``: points against a polygon's edges, the crossing-number
  parity and the EDGE_EPS band, as bool[n] each (``scan/gscan.py``);
- ``residual_mask``: a compiled attribute-filter program over split
  device columns, one byte per row (bit 0 the verdict, bit 1 the f64
  band; ``scan/residual.py`` compiles the program, which the caller
  passes as host data and the wrapper uploads once per program and
  column set);
- ``density_grid``: the weights of the counted points summed into a
  (height, width) f32 pixel grid by warp-grouped atomic adds, into the
  grid or, for small grids with many rows, a copy of it in each block's
  shared memory (``scan/aggregations.py``); two
  loaders: the caller's arrays (``density_grid``), or a query result's
  row ids into the store's device columns (``density_grid_rows``).
- ``extent_tristate``: per row of an extent schema, OUT (0), MAYBE (1)
  or IN (2) of its outward-rounded f32 bounding box against the query's
  outward- and inward-rounded boxes, and its (day, ms) against the
  query's intervals, as int8[n] (``scan/gscan.py``).
- ``dwithin_counts``: per query point, the rows whose f32 squared
  distance is within the radius band's lower edge (definite) and between
  its edges (band), as int32 counts (``analytics/join.py``), over the
  tiles of the x-sorted table that each query's slab meets
  (``sorted_by_x``, ``dwithin_slabs``, ``tile_lists``);
- ``slab_pairs``: over each query's slab of the x-sorted table, the rows
  within the radius band's upper edge (radius mode) or inside the
  widened box (box mode), as (row, query) pairs in query-major, slab
  order, in two passes over the tiles its slab meets (``tile_lists``):
  each entry's count and match bitmap, then the writes at their prefix
  offsets (a prefix on the card);
- ``contains_counts``: per polygon, the slab rows inside its widened box
  and, for those, the crossing number and the EDGE_EPS band: definite
  and band counts, each tile of the x-sorted table read once for every
  polygon whose slab meets it (``tile_lists``), and the first band rows
  in slab order (``contains_band_rows``: more band rows of listed
  polygons);
- ``knn_topk``: per query point, the kpad smallest (f32 d2, row) keys in
  lexicographic order: a sample pass seeds a bound a query, chunks of
  rows are each read once for a group of queries, then each query's
  kept keys are sorted (``knn_plan``).
- ``tube_mask``: per row, whether some pair i of a tube's (box, interval)
  pairs holds it in box_i AND interval_i (``analytics/tube.py``): a
  streaming pass over the time words rejects the rows no interval can
  hold by a time-bucket index and packs the rest, then each is searched
  for over the pairs sorted by their intervals (``tube_pairs``).
- the standing filters (``scan/standing.py``), five wrappers over one
  source: ``standing_grid`` lists each live slot in the 1-degree cells
  its boxes reach (or as everywhere) from the set's seven tables;
  ``standing_count`` and ``standing_write`` test each ingest chunk's
  rows against their cell's slots and the everywhere slots (per pair the
  slot's boxes, time interval and attribute intervals on the two-float
  rows), counting each slot's hits, then writing the hit rows into each
  slot's segment (``standing_offsets``: the counts' prefix, the one
  sync); ``standing_sort`` orders each segment, so the pairs come out
  filter-major and row-ascending (``standing_pairs`` runs them all,
  ``standing_pairs_plain`` their plain versions).

Each wrapper takes its plain PyTorch version ONLY when the tensors lie
on the CPU (the tests' device; for ``residual_mask``, its columns). On
CUDA tensors it launches its kernel or raises; it never falls back.
``launches`` counts kernel launches per wrapper, so a run can show that
its main path went through them.

The kernels build at first use with ``nvcc`` into ``_build/`` beside
this package (one ``nvcc`` per source, started together, then one
link), keyed on a hash of the sources, and load with ctypes. Query
tables: boxes (K, 8) f32 and times (B, 4) i32 with unused slots folded
into impossible bounds (see ``zscan.make_query``); the batched kernels
take them stacked, (Qp, K, 8) and (Qp, B, 4), beside each query's own
box and interval counts (``zscan.stack_queries``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["launches", "reset_launches", "scan_mask", "scan_mask_gather",
           "scan_count", "scan_batch_bits", "compact_bits",
           "scan_mask_plain", "scan_mask_gather_plain", "scan_count_plain",
           "scan_batch_bits_plain", "compact_bits_plain",
           "compact_prefix",
           "compact_prefix_plain", "batch_shape", "unpack_bits",
           "build_library", "BuildInfo", "MAX_TABLE_BYTES",
           "BATCH_ROWS_PER_BLOCK", "BATCH_MAX_GROUP", "pip_mask",
           "pip_mask_plain", "pip_pairs_plain", "pip_edge_terms_plain",
           "pip_skip_plain", "residual_mask", "residual_mask_plain",
           "residual_launcher", "residual_depth", "Op", "Cmp",
           "density_grid", "density_grid_plain", "density_cells_plain",
           "density_grid_rows", "density_grid_rows_plain",
           "density_rows_gather", "density_weights_plain", "density_plan",
           "DENSITY_PATHS", "prefix_plan", "PREFIX_TILE", "extent_tristate",
           "extent_tristate_plain", "dwithin_counts", "dwithin_counts_plain",
           "slab_pairs", "slab_pairs_plain", "contains_counts",
           "contains_counts_plain", "contains_band_rows",
           "contains_band_rows_plain", "knn_topk", "knn_topk_plain",
           "KNN_MAX_KPAD", "SLAB_GROUP", "JOIN_TILE", "JOIN_GROUP",
           "sorted_by_x", "TileLists", "tile_lists", "dwithin_slabs",
           "dwithin_counts_tiles_plain", "contains_rows_items",
           "contains_counts_tiles_plain", "slab_pairs_tiles_plain",
           "knn_plan", "knn_topk_blocks_plain", "tube_mask", "tube_mask_plain",
           "tube_pairs", "tube_index_plain", "tube_mask_index_plain",
           "tube_bucket_bits", "TUBE_STAGE", "TUBE_TILE",
           "TUBE_MAX_BUCKET_BITS", "StandingGrid", "standing_grid",
           "standing_grid_plain", "standing_count", "standing_count_plain",
           "standing_offsets", "standing_offsets_plain", "standing_write",
           "standing_write_plain", "standing_sort", "standing_sort_plain",
           "standing_pairs", "standing_pairs_plain", "standing_cells_plain",
           "STANDING_GRID_X",
           "STANDING_GRID_Y", "STANDING_CELLS", "STANDING_MAX_SLOT_CELLS",
           "STANDING_SORT_TILE", "STANDING_NOWHERE", "STANDING_GRID",
           "STANDING_EVERYWHERE"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_PKG, "csrc", f)
            for f in ("scan.cu", "batch.cu", "geom.cu", "residual.cu",
                      "density.cu", "extent.cu", "join.cu", "tube.cu",
                      "standing.cu")]
_BUILD_DIR = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]

# the kernels stage both query tables in dynamic shared memory, which a
# launch may use up to 48 KB without opting in to more
MAX_TABLE_BYTES = 48 * 1024

# the batched kernels (csrc/batch.cu): a block of the bitmap kernel, and
# so one partial count, covers this many rows (64 bitmap words); one
# launch takes at most BATCH_MAX_GROUP queries, and its shared memory
# (_batch_smem) holds the group's tables and staged bitmap words
BATCH_ROWS_PER_BLOCK = 2048
BATCH_MAX_GROUP = 32

# the prefix kernel's tile: partials per block (256 threads x four
# 16-byte vectors)
PREFIX_TILE = 4096

launches = {"scan_mask": 0, "scan_mask_gather": 0, "scan_count": 0,
            "scan_batch_bits": 0, "compact_prefix": 0, "compact_bits": 0,
            "pip_mask": 0, "residual_mask": 0, "density_grid": 0,
            "extent_tristate": 0, "dwithin_counts": 0, "slab_pairs": 0,
            "contains_counts": 0, "knn_topk": 0, "tube_mask": 0,
            "standing_grid": 0, "standing_count": 0, "standing_offsets": 0,
            "standing_write": 0, "standing_sort": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# -- plain versions (a port of zscan._mask_body) ---------------------------

def _ge2(hi, lo, bhi, blo):
    return (hi > bhi) | ((hi == bhi) & (lo >= blo))


def _le2(hi, lo, bhi, blo):
    return (hi < bhi) | ((hi == bhi) & (lo <= blo))


def _predicate(xhi, xlo, yhi, ylo, tday, tms, boxes, times, time_any):
    """(rows, K) and (rows, B) broadcasts of the two-float box test and
    the (day, ms) interval test, reduced over boxes and intervals."""
    xh, xl = xhi[:, None], xlo[:, None]
    yh, yl = yhi[:, None], ylo[:, None]
    b = boxes[None, :, :]
    spatial = (_ge2(xh, xl, b[..., 0], b[..., 1])
               & _le2(xh, xl, b[..., 2], b[..., 3])
               & _ge2(yh, yl, b[..., 4], b[..., 5])
               & _le2(yh, yl, b[..., 6], b[..., 7])).any(dim=1)
    if time_any:
        return spatial
    td, tm = tday[:, None], tms[:, None]
    t = times[None, :, :]
    after = (td > t[..., 0]) | ((td == t[..., 0]) & (tm >= t[..., 1]))
    before = (td < t[..., 2]) | ((td == t[..., 2]) & (tm <= t[..., 3]))
    return spatial & (after & before).any(dim=1)


def scan_mask_plain(cols, n: int, boxes, times, time_any: bool):
    """bool[cap]: the predicate on rows < n, False on rows >= n."""
    out = _predicate(*cols, boxes, times, time_any)
    out[n:] = False
    return out


def scan_mask_gather_plain(rows, idx, boxes, times, time_any: bool):
    """bool[len(idx)]: the predicate on rows ``idx``, unpacked from the
    gather table's words [xhi, xlo, yhi, ylo, tday, tms, 0, 0]."""
    w = rows[idx.long()]
    f = w[:, :4].view(torch.float32)
    return _predicate(f[:, 0], f[:, 1], f[:, 2], f[:, 3], w[:, 4], w[:, 5],
                      boxes, times, time_any)


def scan_count_plain(cols, n: int, boxes, times, time_any: bool):
    """int32[1]: the number of rows < n that match."""
    hits = _predicate(*(c[:n] for c in cols), boxes, times, time_any)
    return hits.sum(dtype=torch.int32).reshape(1)


def batch_shape(cap: int) -> tuple[int, int]:
    """(words, nb) of the batched kernels' outputs for ``cap`` rows:
    32 rows per bitmap word, BATCH_ROWS_PER_BLOCK rows per partial."""
    words = -(-cap // 32)
    return words, -(-words // (BATCH_ROWS_PER_BLOCK // 32))


def _candidates(xhi, yhi, boxes):
    """The boundary-candidate test (a port of zscan._cand_body): the
    row's hi cell equals a box bound's hi cell, over the K boxes."""
    b = boxes[None, :, :]
    xh, yh = xhi[:, None], yhi[:, None]
    return ((xh == b[..., 0]) | (xh == b[..., 2])
            | (yh == b[..., 4]) | (yh == b[..., 6])).any(dim=1)


def _pack_bits(mask, words: int):
    """bool[rows] -> int32[words], bit j of word w = row 32w + j. Distinct
    powers of two (bit 31 as -2^31) sum without a carry, so the int32
    sum is the bitwise OR."""
    m = torch.zeros(words * 32, dtype=torch.int32, device=mask.device)
    m[:mask.shape[0]] = mask
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    return (m.view(words, 32) << shifts).sum(dim=1, dtype=torch.int32)


def unpack_bits(words):
    """int32[words] -> bool[32 * words]; the inverse of _pack_bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).bool().flatten()


def _own_slots(boxes, times, counts):
    """Per query, (boxes, times) cut to its own slots: the first
    counts[q] = (boxes, intervals), each clamped to [0, K] and [0, B]."""
    k, b = boxes.shape[1], times.shape[1]
    return [(boxes[q, :min(max(cb, 0), k)], times[q, :min(max(ct, 0), b)])
            for q, (cb, ct) in enumerate(counts.tolist())]


def scan_batch_bits_plain(cols, n: int, boxes, times, counts):
    """(bits int32[2, Qp, words], partials int32[2, Qp, nb]): per query,
    the predicate (kind 0) and the boundary-candidate test (kind 1) on
    rows < n over its own slots (``_own_slots``) as bitmaps, and their
    popcounts per BATCH_ROWS_PER_BLOCK rows."""
    cap = cols[0].shape[0]
    qp = boxes.shape[0]
    words, nb = batch_shape(cap)
    dev = cols[0].device
    bits = torch.empty((2, qp, words), dtype=torch.int32, device=dev)
    partials = torch.empty((2, qp, nb), dtype=torch.int32, device=dev)
    if cap == 0:
        return bits, partials
    for q, (bq, tq) in enumerate(_own_slots(boxes, times, counts)):
        hit = _predicate(*cols, bq, tq, False)
        cand = _candidates(cols[0], cols[2], bq)
        for kind, m in enumerate((hit, cand)):
            m[n:] = False
            bits[kind, q] = _pack_bits(m, words)
            blocks = torch.zeros(nb * BATCH_ROWS_PER_BLOCK, dtype=torch.int32,
                                 device=dev)
            blocks[:cap] = m
            partials[kind, q] = blocks.view(nb, -1).sum(dim=1,
                                                        dtype=torch.int32)
    return bits, partials


def compact_prefix_plain(partials):
    """(offsets int32[2, Qp, nb], totals int64[2, Qp]): per (kind,
    query) row of ``partials`` the exclusive prefix of its partials and
    its sum. A query's ids start at the sum of its kind's totals over
    the queries before it (int64: that sum can pass 2^31)."""
    incl = torch.cumsum(partials, dim=2, dtype=torch.int64)
    offsets = (incl - partials).to(torch.int32)
    totals = (incl[:, :, -1] if partials.shape[2]
              else incl.new_zeros(partials.shape[:2]))
    return offsets, totals


def prefix_plan(rows: int, nb: int) -> tuple[int, int, int]:
    """(tiles per row, tiles, scratch words) of one prefix launch over
    ``rows`` rows of ``nb`` partials: PREFIX_TILE partials a tile, one
    block a tile, and a scratch of one ticket counter and one look-back
    status word a tile."""
    per_row = -(-nb // PREFIX_TILE)
    return per_row, rows * per_row, 1 + rows * per_row


_PLAIN_COMPACT_ELEMS = 1 << 24


def compact_bits_plain(bits, partials):
    """(hit ids, candidate ids, counts): per kind the set rows of query
    0, then query 1, ..., ascending within a query (torch.nonzero), as
    int32; counts int64[2, Qp] on the host, query q's share of kind k."""
    counts = partials.sum(dim=2, dtype=torch.int64).cpu().numpy()
    qp, words = bits.shape[1], bits.shape[2]
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    # groups of queries whose unpacked bits stay near 2^24 elements; the
    # (query, row) pairs of a group in row-major order are query-major,
    # rows ascending within a query
    group = max(1, _PLAIN_COMPACT_ELEMS // max(32 * words, 1))
    return (*(torch.cat([torch.nonzero(
        ((bits[kind, q:q + group, :, None] >> shifts) & 1).flatten(1))[:, 1]
        .to(torch.int32) for q in range(0, qp, group)]
        or [torch.empty(0, dtype=torch.int32, device=bits.device)])
              for kind in range(2)), counts)


# -- build -----------------------------------------------------------------

@dataclasses.dataclass
class BuildInfo:
    path: str
    seconds: float   # 0.0 when a build of these sources already existed
    log: str         # nvcc's output (-Xptxas -v: registers, shared memory)


_lock = threading.Lock()
_lib: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the scan kernels build with the "
                       "CUDA toolkit (set CUDA_HOME)")


def build_library() -> BuildInfo:
    """Compile csrc/*.cu (once per source hash) and return where the
    shared library is: one ``nvcc -c`` per source, all started together,
    then one link. Raises on a failed build; there is no fallback."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in _SOURCES:
        with open(p, "rb") as f:
            h.update(f.read())
    path = os.path.join(_BUILD_DIR, f"libgeomesa_scan_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o")
                for p in _SOURCES]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(_SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(lib, path)
    return BuildInfo(path, time.perf_counter() - t0, log)


def _library() -> ctypes.CDLL:
    with _lock:
        if "lib" not in _lib:
            lib = ctypes.CDLL(build_library().path)
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            cols = [p] * 6
            lib.geomesa_scan_mask.argtypes = (
                cols + [i64, i64, p, i32, p, i32, i32, p, p])
            lib.geomesa_scan_mask_gather.argtypes = (
                [p, p, i64, p, i32, p, i32, i32, p, p])
            lib.geomesa_scan_count.argtypes = (
                cols + [i64, p, i32, p, i32, i32, p, p])
            lib.geomesa_scan_batch_bits.argtypes = (
                cols + [i64, i64, p, p, p, i32, i32, i32, p, i64, p, i64, p])
            lib.geomesa_compact_prefix.argtypes = [
                p, i32, i64, p, p, p, ctypes.c_uint64, ctypes.c_uint32, p]
            lib.geomesa_prefix_tile.argtypes = []
            lib.geomesa_compact_bits.argtypes = (
                [p, p, p, p, i32, i64, i64, p, p, p])
            lib.geomesa_batch_rows_per_block.argtypes = []
            lib.geomesa_batch_max_group.argtypes = []
            lib.geomesa_batch_smem_bytes.argtypes = [i32, i32, i32]
            lib.geomesa_batch_smem_bytes.restype = ctypes.c_longlong
            lib.geomesa_pip_mask.argtypes = [p, p, i64, p, i64,
                                             ctypes.c_float, p, p, p]
            lib.geomesa_residual_mask.argtypes = [p, p, p, p, i32, i32, i64,
                                                  p, p]
            lib.geomesa_residual_codes.argtypes = [p, i32]
            f32 = ctypes.c_float
            lib.geomesa_density_grid.argtypes = [p, p, p, p, i64, f32, f32,
                                                 f32, f32, i32, i32, i32, p, p]
            lib.geomesa_density_rows.argtypes = [
                p, i64, p, p, p, i32, p, p, p, f32, f32, f32, f32, i32, i32,
                i32, p, p]
            lib.geomesa_density_plan.argtypes = [i32, i64, i32, i32, i32, p]
            lib.geomesa_extent_tristate.argtypes = [p, p, p, i64, p, p, i32,
                                                    p, i32, p, p]
            lib.geomesa_join_constant.argtypes = [i32]
            lib.geomesa_dwithin_counts.argtypes = [p, p, i64, p, p, i32, p, p,
                                                   f32, f32, p, p, p]
            lib.geomesa_slab_counts.argtypes = [p, p, i64, p, p, i32, p, p,
                                                p, i32, p, f32, f32, p, p, p]
            lib.geomesa_slab_write.argtypes = [p, i64, p, p, i32, p, p, p, p,
                                               p, p, p, p, p]
            lib.geomesa_contains_counts.argtypes = [p, p, i64, p, p, i32, p,
                                                    p, p, p, p, i32, i32, f32,
                                                    f32, p, p, p, p, p]
            lib.geomesa_contains_band_rows.argtypes = [p, p, p, i64, p, p, p,
                                                       i64, p, p, p, i32, i32,
                                                       f32, f32, p, i32, p, p]
            lib.geomesa_knn_plan.argtypes = [i64, i32, i32, p]
            lib.geomesa_knn_topk.argtypes = [p, p, i64, p, p, i64, i32, i32,
                                             p, p, p, p, p, p, p, p, p, p]
            lib.geomesa_tube_mask.argtypes = cols + [i64, p, p, p, p, i32, i32,
                                                     p, p]
            lib.geomesa_tube_constant.argtypes = [i32]
            tables = [p] * 7
            lib.geomesa_standing_constant.argtypes = [i32]
            lib.geomesa_standing_grid_count.argtypes = (
                tables + [i32, i32, p, p, p, p, p, p, p])
            lib.geomesa_standing_grid_fill.argtypes = (
                tables + [i32, i32, p, p, p, p])
            lib.geomesa_standing_match.argtypes = (
                [i32] + cols + [p, p, i64, i32, i64] + tables
                + [i32, i32, p, p, p, p, i32, p, p, p, i32, p])
            lib.geomesa_standing_offsets.argtypes = [p, i32, p, p, p, p]
            lib.geomesa_standing_sort.argtypes = [p, p, p, p, p, i32, p]
            for fn in (lib.geomesa_scan_mask, lib.geomesa_scan_mask_gather,
                       lib.geomesa_scan_count, lib.geomesa_scan_batch_bits,
                       lib.geomesa_compact_prefix, lib.geomesa_compact_bits,
                       lib.geomesa_batch_rows_per_block,
                       lib.geomesa_batch_max_group, lib.geomesa_pip_mask,
                       lib.geomesa_residual_mask, lib.geomesa_residual_codes,
                       lib.geomesa_density_grid, lib.geomesa_density_rows,
                       lib.geomesa_density_plan, lib.geomesa_prefix_tile,
                       lib.geomesa_extent_tristate, lib.geomesa_join_constant,
                       lib.geomesa_dwithin_counts, lib.geomesa_slab_counts,
                       lib.geomesa_slab_write, lib.geomesa_contains_counts,
                       lib.geomesa_contains_band_rows, lib.geomesa_knn_plan,
                       lib.geomesa_knn_topk, lib.geomesa_tube_mask,
                       lib.geomesa_tube_constant,
                       lib.geomesa_standing_constant,
                       lib.geomesa_standing_grid_count,
                       lib.geomesa_standing_grid_fill,
                       lib.geomesa_standing_match,
                       lib.geomesa_standing_offsets,
                       lib.geomesa_standing_sort):
                fn.restype = ctypes.c_int
            if (lib.geomesa_batch_rows_per_block() != BATCH_ROWS_PER_BLOCK
                    or lib.geomesa_batch_max_group() != BATCH_MAX_GROUP
                    or lib.geomesa_prefix_tile() != PREFIX_TILE
                    or lib.geomesa_batch_smem_bytes(3, 4, 2)
                    != _batch_smem(3, 4, 2)):
                raise RuntimeError("csrc/batch.cu and kernels.py disagree "
                                   "on the batched kernels' block shape")
            codes = (ctypes.c_int32 * 64)()
            got = lib.geomesa_residual_codes(codes, len(codes))
            if tuple(codes[:got]) != RESIDUAL_CODES:
                raise RuntimeError("csrc/residual.cu and kernels.py disagree "
                                   "on the residual program's opcodes")
            if tuple(lib.geomesa_join_constant(i) for i in range(4)) != (
                    JOIN_TILE, JOIN_GROUP, SLAB_GROUP, KNN_MAX_KPAD):
                raise RuntimeError("csrc/join.cu and kernels.py disagree on "
                                   "the join kernels' tiles, groups and "
                                   "windows")
            if (tuple(lib.geomesa_tube_constant(i) for i in range(3))
                    != (TUBE_STAGE, TUBE_TILE, TUBE_MAX_BUCKET_BITS)):
                raise RuntimeError("csrc/tube.cu and kernels.py disagree on "
                                   "the tube kernel's staging, tiles or "
                                   "buckets")
            if (tuple(lib.geomesa_standing_constant(i) for i in range(4))
                    != (STANDING_GRID_X, STANDING_GRID_Y,
                        STANDING_MAX_SLOT_CELLS, STANDING_SORT_TILE)):
                raise RuntimeError("csrc/standing.cu and kernels.py disagree "
                                   "on the slot grid or the sort's tile")
            _lib["lib"] = lib
        return _lib["lib"]


# -- wrappers --------------------------------------------------------------

_DTYPES = (torch.float32,) * 4 + (torch.int32,) * 2


def _on_cpu(cols, *others) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else raises."""
    devs = {t.device for t in (*cols, *others)}
    if len(devs) != 1:
        raise ValueError(f"scan tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"scan kernels run on CUDA or CPU tensors, not {dev}")
    return False


def _check_cols(cols, n: int) -> int:
    if len(cols) != 6:
        raise ValueError("cols are (xhi, xlo, yhi, ylo, tday, tms)")
    cap = cols[0].shape[0]
    for c, dt in zip(cols, _DTYPES):
        if c.dtype != dt or c.dim() != 1 or c.shape[0] != cap:
            raise ValueError(f"column must be 1-d {dt} of length {cap}")
        if not c.is_contiguous():
            raise ValueError("columns must be contiguous")
    if not 0 <= n <= cap:
        raise ValueError(f"n={n} outside [0, {cap}]")
    return cap


def _check(cols, n: int, boxes, times):
    cap = _check_cols(cols, n)
    _check_tables(boxes, times)
    return cap


def _check_tables(boxes, times):
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 8 or boxes.shape[0] < 1
            or not boxes.is_contiguous()):
        raise ValueError("boxes must be a contiguous (K>=1, 8) float32 table")
    if (times.dtype != torch.int32 or times.dim() != 2
            or times.shape[1] != 4 or times.shape[0] < 1
            or not times.is_contiguous()):
        raise ValueError("times must be a contiguous (B>=1, 4) int32 table")
    table_bytes = boxes.numel() * 4 + times.numel() * 4
    if table_bytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"query tables of {boxes.shape[0]} boxes and {times.shape[0]} "
            f"intervals take {table_bytes} bytes of shared memory; the "
            f"kernels take at most {MAX_TABLE_BYTES}")


def _ptrs(cols):
    return [c.data_ptr() for c in cols]


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def scan_mask(cols, n: int, boxes, times, time_any: bool):
    """Dense tier: bool[cap] mask over every row, False past ``n``."""
    cap = _check(cols, n, boxes, times)
    if _on_cpu(cols, boxes, times):
        return scan_mask_plain(cols, n, boxes, times, time_any)
    out = torch.empty(cap, dtype=torch.bool, device=cols[0].device)
    if cap == 0:
        return out
    lib = _library()
    rc = lib.geomesa_scan_mask(
        *_ptrs(cols), n, cap, boxes.data_ptr(), boxes.shape[0],
        times.data_ptr(), times.shape[0], int(time_any), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(rc, "scan_mask")
    launches["scan_mask"] += 1
    return out


def scan_mask_gather(rows, idx, boxes, times, time_any: bool):
    """Gathered tier: bool[len(idx)] mask over rows ``idx``.

    ``rows`` is the (cap, 8) int32 gather table (``ScanData.rows``);
    ``idx`` holds int32 row ids, each in range (the caller checks the
    bounds on the host)."""
    _check_tables(boxes, times)
    if (rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 8
            or not rows.is_contiguous()):
        raise ValueError("rows must be a contiguous (cap, 8) int32 table")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-d int32 tensor")
    if _on_cpu((rows,), boxes, times, idx):
        return scan_mask_gather_plain(rows, idx, boxes, times, time_any)
    if rows.data_ptr() % 32 or idx.data_ptr() % 16:
        raise ValueError("the gather kernel reads rows as 32-byte sectors and "
                         "ids as 16-byte vectors: rows must be 32-byte and "
                         "idx 16-byte aligned")
    m = idx.shape[0]
    out = torch.empty(m, dtype=torch.bool, device=idx.device)
    if m == 0:
        return out
    lib = _library()
    rc = lib.geomesa_scan_mask_gather(
        rows.data_ptr(), idx.data_ptr(), m, boxes.data_ptr(), boxes.shape[0],
        times.data_ptr(), times.shape[0], int(time_any), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(rc, "scan_mask_gather")
    launches["scan_mask_gather"] += 1
    return out


def scan_count(cols, n: int, boxes, times, time_any: bool):
    """int32[1] on the columns' device: matching rows among the first n."""
    _check(cols, n, boxes, times)
    if _on_cpu(cols, boxes, times):
        return scan_count_plain(cols, n, boxes, times, time_any)
    out = torch.zeros(1, dtype=torch.int32, device=cols[0].device)
    if n == 0:
        return out
    lib = _library()
    rc = lib.geomesa_scan_count(
        *_ptrs(cols), n, boxes.data_ptr(), boxes.shape[0],
        times.data_ptr(), times.shape[0], int(time_any), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(rc, "scan_count")
    launches["scan_count"] += 1
    return out


def _batch_smem(qg: int, k: int, b: int) -> int:
    """Shared memory of one bitmap-kernel launch (csrc/batch.cu
    batch_smem): per query its staged hit and candidate words (2 x 64),
    its K boxes (4 hi bounds and all 8 f32), its B interval keys (2 i64)
    and its counts."""
    return qg * (2 * (BATCH_ROWS_PER_BLOCK // 32) * 4 + k * 12 * 4
                 + b * 2 * 8 + 2 * 4)


def _batch_group(boxes, times) -> int:
    """Queries per launch of the bitmap kernel: at most BATCH_MAX_GROUP,
    and as many as keep their shared memory (``_batch_smem``) within
    MAX_TABLE_BYTES. A batch that exceeds that runs as several launches
    over query groups."""
    if (boxes.dtype != torch.float32 or boxes.dim() != 3
            or boxes.shape[2] != 8 or boxes.shape[1] < 1
            or not boxes.is_contiguous()):
        raise ValueError("boxes must be a contiguous (Qp, K>=1, 8) float32 "
                         "table")
    if (times.dtype != torch.int32 or times.dim() != 3
            or times.shape[2] != 4 or times.shape[1] < 1
            or not times.is_contiguous()):
        raise ValueError("times must be a contiguous (Qp, B>=1, 4) int32 "
                         "table")
    if boxes.shape[0] < 1 or boxes.shape[0] != times.shape[0]:
        raise ValueError("boxes and times must stack the same Qp >= 1 "
                         "queries")
    per_query = _batch_smem(1, boxes.shape[1], times.shape[1])
    group = min(BATCH_MAX_GROUP, MAX_TABLE_BYTES // per_query)
    if group < 1:
        raise ValueError(
            f"one query's tables of {boxes.shape[1]} boxes and "
            f"{times.shape[1]} intervals take {per_query} bytes of shared "
            f"memory with its staged words; the kernels take at most "
            f"{MAX_TABLE_BYTES}")
    return group


def scan_batch_bits(cols, n: int, boxes, times, counts):
    """A batch of Qp queries in one pass over the rows: (bits
    int32[2, Qp, words], partials int32[2, Qp, nb]), ``batch_shape``.

    Kind 0 is the predicate, kind 1 the boundary-candidate test; bit j
    of word w is row 32w + j, rows >= n are 0; partials[kind, q, j] is
    the popcount of rows j*BATCH_ROWS_PER_BLOCK .. of query q. ``boxes``
    (Qp, K, 8) f32 and ``times`` (Qp, B, 4) i32 are stacked tables with
    no time_any: a time-free query carries a catch-all interval
    (``zscan.stack_queries``). ``counts`` (Qp, 2) i32 holds each query's
    own box and interval counts, the slots the kernel evaluates (counts
    past a query's own slots give the same bits, since unused slots
    match nothing)."""
    cap = _check_cols(cols, n)
    group = _batch_group(boxes, times)
    if (counts.dtype != torch.int32 or not counts.is_contiguous()
            or tuple(counts.shape) != (boxes.shape[0], 2)):
        raise ValueError("counts must be a contiguous (Qp, 2) int32 table")
    if _on_cpu(cols, boxes, times, counts):
        return scan_batch_bits_plain(cols, n, boxes, times, counts)
    if any(c.data_ptr() % 16 for c in cols):
        raise ValueError("the bitmap kernel reads the columns as 16-byte "
                         "vectors: they must be 16-byte aligned")
    qp, k, b = boxes.shape[0], boxes.shape[1], times.shape[1]
    words, nb = batch_shape(cap)
    dev = cols[0].device
    bits = torch.empty((2, qp, words), dtype=torch.int32, device=dev)
    partials = torch.empty((2, qp, nb), dtype=torch.int32, device=dev)
    if cap == 0:
        return bits, partials
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q0 in range(0, qp, group):
        qg = min(group, qp - q0)
        rc = lib.geomesa_scan_batch_bits(
            *_ptrs(cols), n, words, boxes[q0].data_ptr(), times[q0].data_ptr(),
            counts[q0].data_ptr(), qg, k, b,
            bits[0, q0].data_ptr(), qp * words, partials[0, q0].data_ptr(),
            qp * nb, stream)
        _raise_on(rc, "scan_batch_bits")
        launches["scan_batch_bits"] += 1
    return bits, partials


def _check_partials(partials):
    if (partials.dtype != torch.int32 or partials.dim() != 3
            or partials.shape[0] != 2 or not partials.is_contiguous()):
        raise ValueError("partials must be a contiguous int32[2, Qp, nb]")


class _PrefixScratch:
    """The prefix kernel's scratch on one device and stream: a zeroed
    int64 buffer (word 0 the ticket counter, then one look-back status
    word per tile), the tickets that launches on it have taken, and the
    epoch of the last launch."""

    def __init__(self, words: int, device):
        self.buf = torch.zeros(words, dtype=torch.int64, device=device)
        self.issued = 0
        self.epoch = 0


# epochs are 31 bits in the status words; a scratch is made anew before
# its epoch would pass them
_PREFIX_EPOCHS = (1 << 31) - 1
_prefix_scratch: dict = {}


def compact_prefix(partials):
    """(offsets int32[2, Qp, nb], totals int64[2, Qp]) on the partials'
    device: per (kind, query) row the exclusive prefix of its partials
    (a block's first id within its query) and its sum. One block of the
    prefix kernel per tile of PREFIX_TILE partials (``prefix_plan``); the
    tiles' look-back runs through a scratch kept per device and stream,
    which needs no clearing between launches."""
    _check_partials(partials)
    if _on_cpu((partials,)):
        return compact_prefix_plain(partials)
    qp, nb = partials.shape[1], partials.shape[2]
    dev = partials.device
    offsets = torch.empty((2, qp, nb), dtype=torch.int32, device=dev)
    if qp * nb == 0:
        return offsets, torch.zeros((2, qp), dtype=torch.int64, device=dev)
    totals = torch.empty((2, qp), dtype=torch.int64, device=dev)
    _, tiles, words = prefix_plan(2 * qp, nb)
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream)
    lib = _library()
    # one launch at a time per scratch: its ticket base and epoch follow
    # the launches before it on the stream
    with _lock:
        sc = _prefix_scratch.get(key)
        if (sc is None or sc.buf.numel() < words
                or sc.epoch >= _PREFIX_EPOCHS):
            sc = _prefix_scratch[key] = _PrefixScratch(
                max(words, 0 if sc is None else sc.buf.numel()), dev)
        sc.epoch += 1
        rc = lib.geomesa_compact_prefix(
            partials.data_ptr(), 2 * qp, nb, offsets.data_ptr(),
            totals.data_ptr(), sc.buf.data_ptr(), sc.issued, sc.epoch,
            stream.cuda_stream)
        _raise_on(rc, "compact_prefix")
        sc.issued += tiles
    launches["compact_prefix"] += 1
    return offsets, totals


def _check_compact(bits, partials) -> tuple[int, int]:
    if (bits.dtype != torch.int32 or bits.dim() != 3 or bits.shape[0] != 2
            or not bits.is_contiguous()):
        raise ValueError("bits must be a contiguous int32[2, Qp, words]")
    qp, words = bits.shape[1], bits.shape[2]
    _check_partials(partials)
    if tuple(partials.shape) != (2, qp, batch_shape(32 * words)[1]):
        raise ValueError("partials must be the contiguous int32[2, Qp, nb] "
                         "of these bits")
    return qp, words


def _compact_launch(bits, partials, offsets, totals, sums):
    """The compaction kernel into outputs of ``sums`` = (hit, candidate)
    ids; no launch when both are 0."""
    qp, words = bits.shape[1], bits.shape[2]
    dev = bits.device
    out_hit = torch.empty(sums[0], dtype=torch.int32, device=dev)
    out_cand = torch.empty(sums[1], dtype=torch.int32, device=dev)
    if sums[0] + sums[1] == 0:
        return out_hit, out_cand
    rc = _library().geomesa_compact_bits(
        bits.data_ptr(), partials.data_ptr(), offsets.data_ptr(),
        totals.data_ptr(), qp, partials.shape[2], words, out_hit.data_ptr(),
        out_cand.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "compact_bits")
    launches["compact_bits"] += 1
    return out_hit, out_cand


def compact_bits(bits, partials):
    """(hit ids, candidate ids, counts): the ids int32 on the bitmaps'
    device, per kind the rows of query 0, then query 1, ..., each
    ascending; counts int64[2, Qp] on the host, query q's share of kind
    k (the sums of ``partials``). ``bits`` and ``partials`` are
    ``scan_batch_bits``'s. ``compact_prefix`` gives the blocks' offsets
    and the totals on the device; the totals' copy to the host (the one
    sync) sizes the outputs, and the kernel sums each query's base from
    the totals on the device."""
    _check_compact(bits, partials)
    if _on_cpu((bits, partials)):
        return compact_bits_plain(bits, partials)
    offsets, totals = compact_prefix(partials)
    counts = totals.cpu().numpy()
    sums = tuple(int(c) for c in counts.sum(axis=1))
    return (*_compact_launch(bits, partials, offsets, totals, sums), counts)


# -- point in polygon (csrc/geom.cu) ----------------------------------------

# points per chunk of the plain version: (chunk, E) intermediates stay
# near 2^24 elements, whatever the number of points
_PIP_PLAIN_ELEMS = 1 << 24


def pip_pairs_plain(px, py, edges):
    """(cross, d2), each (n, E): per (point, edge) pair the crossing bit
    ``cond & (px < xint)`` and the squared distance to the edge at the
    clamped projection; one elementwise op per step in the JAX body's
    order (so no multiply and add contract)."""
    x0, y0, x1, y1 = (edges[:, k] for k in range(4))
    ex = x1 - x0
    ey = y1 - y0
    len2 = ex * ex + ey * ey
    len2 = torch.where(len2 == 0, torch.ones_like(len2), len2)
    dy = torch.where(y1 == y0, torch.full_like(ey, 1e-30), ey)
    pxc, pyc = px[:, None], py[:, None]
    cond = (y0 > pyc) != (y1 > pyc)
    xint = x0 + ((pyc - y0) * ex) / dy
    cross = cond & (pxc < xint)
    t = (((pxc - x0) * ex + (pyc - y0) * ey) / len2).clamp(0.0, 1.0)
    dx = pxc - (x0 + t * ex)
    dyv = pyc - (y0 + t * ey)
    return cross, dx * dx + dyv * dyv


def pip_mask_plain(px, py, edges, eps2: float):
    """(inside, band) bool[n]: a port of gscan._pip_kernel in torch ops
    (``pip_pairs_plain``), over chunks of points against every edge."""
    n, e = px.shape[0], edges.shape[0]
    inside = torch.zeros(n, dtype=torch.bool, device=px.device)
    band = torch.zeros(n, dtype=torch.bool, device=px.device)
    if e == 0:
        return inside, band
    eps = torch.tensor(eps2, dtype=torch.float32, device=px.device)
    step = max(1, _PIP_PLAIN_ELEMS // e)
    for lo in range(0, n, step):
        cross, d2 = pip_pairs_plain(px[lo:lo + step], py[lo:lo + step], edges)
        inside[lo:lo + step] = (cross.sum(dim=1) % 2) == 1
        band[lo:lo + step] = d2.min(dim=1).values < eps
    return inside, band


# csrc/geom.cu's skip: points and edges beyond 2^60 never skip, and the
# margin is r + 2^-19 * max |coordinate| of the edge
_PIP_TAME = float(2.0**60)
_PIP_ULPS = float(2.0**-19)


def pip_edge_terms_plain(edges, eps2: float):
    """(lox, hix, loy, hiy) f32 [E]: each edge's box expanded by the
    kernel's margin M = r + 2^-19 * A, with r = fl(sqrt(eps2)) * (1 +
    2^-8) and A the largest |coordinate| of the edge, each step rounded
    to nearest as csrc/geom.cu's prologue computes it; NaN (no skip)
    for an edge with a coordinate that is NaN or beyond 2^60."""
    x0, y0, x1, y1 = (edges[:, k] for k in range(4))
    r = np.float32(np.sqrt(np.float32(eps2))) * np.float32(1.00390625)
    mag = edges.abs()
    tame = (mag <= _PIP_TAME).all(dim=1)
    m = torch.where(tame, float(r) + mag.max(dim=1).values * _PIP_ULPS,
                    torch.full_like(x0, float("nan")))
    return (torch.minimum(x0, x1) - m, torch.maximum(x0, x1) + m,
            torch.minimum(y0, y1) - m, torch.maximum(y0, y1) + m)


def pip_skip_plain(px, py, edges, eps2: float):
    """(skip, cross), each (n, E): the pairs the kernel skips (a point
    with |px|, |py| <= 2^60 outside the edge's expanded box) and the
    division-free crossing it takes for them, ``cond & (px < lox)``."""
    lox, hix, loy, hiy = pip_edge_terms_plain(edges, eps2)
    tame = (px.abs() <= _PIP_TAME) & (py.abs() <= _PIP_TAME)
    sx = torch.where(tame, px, float("nan"))[:, None]
    sy = torch.where(tame, py, float("nan"))[:, None]
    skip = (sx < lox) | (sx > hix) | (sy < loy) | (sy > hiy)
    y0, y1 = edges[:, 1], edges[:, 3]
    pyc = py[:, None]
    cond = (y0 > pyc) != (y1 > pyc)
    return skip, cond & (px[:, None] < lox)


def pip_mask(px, py, edges, eps2: float):
    """(inside, band) bool[n] on the points' device: the crossing-number
    parity of each point (px[i], py[i]) against the (E, 4) f32 edges
    [x0 y0 x1 y1], and whether its least squared distance to an edge is
    below ``eps2`` (an f32 value)."""
    if (px.dtype != torch.float32 or py.dtype != torch.float32
            or px.dim() != 1 or px.shape != py.shape
            or not (px.is_contiguous() and py.is_contiguous())):
        raise ValueError("px, py must be contiguous 1-d float32 of one length")
    if (edges.dtype != torch.float32 or edges.dim() != 2
            or edges.shape[1] != 4 or not edges.is_contiguous()):
        raise ValueError("edges must be a contiguous (E, 4) float32 table")
    if _on_cpu((px, py, edges)):
        return pip_mask_plain(px, py, edges, eps2)
    if edges.data_ptr() % 16:
        raise ValueError("the kernel reads edges as 16-byte vectors: edges "
                         "must be 16-byte aligned")
    n = px.shape[0]
    inside = torch.empty(n, dtype=torch.bool, device=px.device)
    band = torch.empty(n, dtype=torch.bool, device=px.device)
    if n == 0:
        return inside, band
    rc = _library().geomesa_pip_mask(
        px.data_ptr(), py.data_ptr(), n, edges.data_ptr(), edges.shape[0],
        eps2, inside.data_ptr(), band.data_ptr(),
        torch.cuda.current_stream(px.device).cuda_stream)
    _raise_on(rc, "pip_mask")
    launches["pip_mask"] += 1
    return inside, band


# -- attribute residual (csrc/residual.cu) ----------------------------------

class Op:
    """Opcodes of the residual program (csrc/residual.cu's enum Op)."""
    TRUE, FALSE, AND, OR, NOT, VALID, ISNULL = range(7)
    PAIR_I64, PAIR_DATE, PAIR_F64, BOOL = 7, 8, 9, 10
    STR_EQ, STR_NE, STR_LT, STR_GE, VOCAB = 11, 12, 13, 14, 15


class Cmp:
    """Compare codes of the residual program's pair leaves."""
    LT, GT, LE, GE, EQ, NE = range(6)


# every opcode, then every compare code, in the order of csrc/residual.cu's
# geomesa_residual_codes; the loader refuses a library that disagrees
RESIDUAL_CODES = (
    Op.TRUE, Op.FALSE, Op.AND, Op.OR, Op.NOT, Op.VALID, Op.ISNULL,
    Op.PAIR_I64, Op.PAIR_DATE, Op.PAIR_F64, Op.BOOL, Op.STR_EQ, Op.STR_NE,
    Op.STR_LT, Op.STR_GE, Op.VOCAB,
    Cmp.LT, Cmp.GT, Cmp.LE, Cmp.GE, Cmp.EQ, Cmp.NE)


_SIGN = -(1 << 31)


def _pick(cmp: int, lt, gt):
    return (lt, gt, ~gt, ~lt, ~lt & ~gt, lt | gt)[cmp]


def residual_depth(code, n_consts: int, n_table: int, n_slots: int) -> int:
    """The stack depth the program ``code`` needs (1..64), after checking
    that it is well formed: known opcodes, a stack that never runs empty
    and ends with one value, and every slot, threshold and vocab range
    inside its table. Raises ValueError otherwise."""
    height = depth = 0
    for op, slot, a, b in code.tolist():
        if not Op.TRUE <= op <= Op.VOCAB:
            raise ValueError(f"unknown residual opcode {op}")
        height += -1 if op in (Op.AND, Op.OR) else 0 if op == Op.NOT else 1
        if height < 1:
            raise ValueError("the residual program pops an empty stack")
        depth = max(depth, height)
        if op >= Op.VALID and not 0 <= slot < n_slots:
            raise ValueError("a residual instruction names a slot it lacks")
        if Op.PAIR_I64 <= op <= Op.PAIR_F64 and not 0 <= a < n_consts:
            raise ValueError("a residual compare names a threshold it lacks")
        if op == Op.VOCAB and (a < 0 or b < 0 or a + b > n_table):
            raise ValueError("a vocab range runs past the residual's table")
    if height != 1:
        raise ValueError("the residual program does not leave exactly one "
                         "value on its stack")
    if depth > 64:
        raise ValueError(f"the residual program needs a stack of {depth}; "
                         f"the kernel holds 64")
    return depth


def residual_mask_plain(code, consts, table, slots, n: int, device=None):
    """uint8[n]: the residual program evaluated with torch ops over whole
    columns, one step per instruction, on the columns' device (``device``
    when the program reads no column; None means CUDA). The i64 low words hold unsigned
    bits; they compare with the sign bit flipped, which orders them as
    signed int32 (torch on the CPU has no unsigned 32-bit compares)."""
    stack: list = []
    band = None
    dev = next((t.device for s in slots for t in s if t is not None), None)
    dev = resolve_device(device) if dev is None else dev
    cst = consts.cpu().numpy()
    tbl = table.cpu().numpy()
    for op, slot, a, b in code.cpu().tolist():
        if op == Op.AND:
            stack.append(stack.pop() & stack.pop())
            continue
        if op == Op.OR:
            stack.append(stack.pop() | stack.pop())
            continue
        if op == Op.NOT:
            stack.append(~stack.pop())
            continue
        if op in (Op.TRUE, Op.FALSE):
            stack.append(torch.full((n,), op == Op.TRUE, dtype=torch.bool,
                                    device=dev))
            continue
        c0, c1, valid = slots[slot]
        c0 = c0[:n]
        valid = valid[:n] if valid is not None else None
        if op == Op.VALID:
            v = valid.clone()
        elif op == Op.ISNULL:
            v = c0 < 0 if valid is None else ~valid
        elif op in (Op.PAIR_I64, Op.PAIR_DATE):
            vh, vl = (int(w) for w in cst[a])
            lo = c1[:n]
            if op == Op.PAIR_I64:
                lo = lo ^ _SIGN
                vl = int(np.int32(vl) ^ np.int32(_SIGN))
            lt = (c0 < vh) | ((c0 == vh) & (lo < vl))
            gt = (c0 > vh) | ((c0 == vh) & (lo > vl))
            v = _pick(b, lt, gt) & valid
        elif op == Op.PAIR_F64:
            vh, vl = (torch.tensor(w, device=dev)
                      for w in cst[a].view(np.float32))
            lo = c1[:n]
            lt = (c0 < vh) | ((c0 == vh) & (lo < vl))
            gt = (c0 > vh) | ((c0 == vh) & (lo > vl))
            v = _pick(b, lt, gt) & valid
            hit = (c0 == vh) & (lo == vl) & valid
            band = hit if band is None else band | hit
        elif op == Op.BOOL:
            v = ((c0 & bool(a & 2)) | (~c0 & bool(a & 1))) & valid
        elif op == Op.STR_EQ:
            v = (c0 == a) & (c0 >= 0)
        elif op == Op.STR_NE:
            v = (c0 != a) & (c0 >= 0)
        elif op == Op.STR_LT:
            v = (c0 < a) & (c0 >= 0)
        elif op == Op.STR_GE:
            v = c0 >= a
        elif op == Op.VOCAB:
            lut = torch.from_numpy(np.append(tbl[a:a + b] != 0, False)).to(dev)
            v = lut[torch.where((c0 < 0) | (c0 >= b), b, c0).long()]
        else:
            raise ValueError(f"unknown residual opcode {op}")
        stack.append(v)
    if len(stack) != 1:
        raise ValueError("the residual program leaves "
                         f"{len(stack)} values on its stack, not 1")
    out = stack[0].to(torch.uint8)
    if band is not None:
        out |= band.to(torch.uint8) << 1
    return out


def _host_array(t, dtype) -> np.ndarray:
    return np.ascontiguousarray(t.numpy(), dtype=dtype)


# prepared launches kept by residual_mask, oldest dropped first
_RESIDUAL_LAUNCHES = 256
_residual_launches: dict = {}


class _ResidualLaunch:
    """A prepared launch of the residual kernel: the program uploaded
    once, here; ``launch(n, out)`` runs it over rows < n into ``out``
    (uint8, 16-byte aligned), without checks or a launch count (the
    wrapper's job)."""

    def __init__(self, code, consts, table, slots, device, depth: int):
        c = _host_array(code, np.int32)
        k = _host_array(consts, np.int32)
        tb = _host_array(table, np.uint8)
        ptrs = np.array([[0 if t is None else t.data_ptr() for t in s]
                         for s in slots] or [[0, 0, 0]], dtype=np.uint64)
        self.lib = _library()
        self.len, self.depth = c.shape[0], depth
        # code, consts, slot pointers and table, each 16-byte aligned in
        # one buffer
        parts = [c.view(np.uint8).ravel(), k.view(np.uint8).ravel(),
                 ptrs.view(np.uint8).ravel(), tb]
        offs = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in parts])
        buf = np.zeros(int(offs[-1]) + 16, dtype=np.uint8)
        for o, a in zip(offs, parts):
            buf[o:o + a.nbytes] = a
        self.keep = torch.from_numpy(buf).to(device)
        base = self.keep.data_ptr()
        self.args = tuple(base + int(o) for o in offs[:4])

    def __call__(self, n: int, out):
        rc = self.lib.geomesa_residual_mask(
            *self.args, self.len, self.depth, n, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
        _raise_on(rc, "residual_mask")


def residual_launcher(code, consts, table, slots, device) -> _ResidualLaunch:
    """The residual kernel's launch of this program over these slots,
    prepared once (for timing the kernel apart from its wrapper)."""
    depth = residual_depth(code, consts.shape[0], table.shape[0], len(slots))
    return _ResidualLaunch(code, consts, table, slots, device, depth)


def residual_mask(code, consts, table, slots, n: int, device=None):
    """uint8[n] on the columns' device: bit 0 the program's verdict per
    row, bit 1 the f64 band. The program is host data, CPU tensors:
    ``code`` (L, 4) int32 instructions, ``consts`` (T, 2) int32
    thresholds, ``table`` uint8 vocab tables (csrc/residual.cu's layout);
    ``slots`` one (a, b, valid) tensor triple per column slot, None where
    a slot has no such column, all on one device (``device`` when the
    program reads no column; None means CUDA, as for every entry point).
    On CPU columns the plain version runs; on CUDA columns the kernel,
    the program uploaded in one copy the first time it runs over these
    columns."""
    if (code.dtype != torch.int32 or code.dim() != 2 or code.shape[1] != 4
            or code.shape[0] < 1 or not code.is_contiguous()):
        raise ValueError("code must be a contiguous (L>=1, 4) int32 table")
    if (consts.dtype != torch.int32 or consts.dim() != 2
            or consts.shape[1] != 2 or not consts.is_contiguous()):
        raise ValueError("consts must be a contiguous (T, 2) int32 table")
    if table.dtype != torch.uint8 or table.dim() != 1:
        raise ValueError("table must be a 1-d uint8 tensor")
    if any(t.device.type != "cpu" for t in (code, consts, table)):
        raise ValueError("the residual program (code, consts, table) is host "
                         "data: pass CPU tensors")
    cols = [t for s in slots for t in s if t is not None]
    for t in cols:
        if t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
            raise ValueError(f"slot columns must be contiguous 1-d tensors "
                             f"of at least {n} rows")
    devs = {t.device for t in cols}
    if len(devs) > 1:
        raise ValueError(f"residual columns on several devices: {devs}")
    dev = devs.pop() if devs else resolve_device(device)
    if dev.type == "cpu":
        residual_depth(code, consts.shape[0], table.shape[0], len(slots))
        return residual_mask_plain(code, consts, table, slots, n, dev)
    if dev.type != "cuda":
        raise ValueError(f"the residual kernel runs on CUDA or CPU, not {dev}")
    if any(t.data_ptr() % 16 for t in cols):
        raise ValueError("the residual kernel reads columns as 16-byte "
                         "vectors: every column must be 16-byte aligned")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    # a prepared launch per program (by content) and slot pointers, so a
    # repeated call does no host work beyond this lookup
    key = (code.numpy().tobytes(), consts.numpy().tobytes(),
           table.numpy().tobytes(), dev,
           tuple(0 if t is None else t.data_ptr() for s in slots for t in s))
    launch = _residual_launches.get(key)
    if launch is None:
        launch = residual_launcher(code, consts, table, slots, dev)
        with _lock:
            if len(_residual_launches) >= _RESIDUAL_LAUNCHES:
                _residual_launches.pop(next(iter(_residual_launches)))
            _residual_launches[key] = launch
    launch(n, out)
    launches["residual_mask"] += 1
    return out


# -- density grid (csrc/density.cu) -----------------------------------------

def _density_bins(v, lo, scale, size: int):
    """Pixel index int64 [n] of coordinates ``v`` (f32): the rounded
    ``(v - lo) * scale`` in f32, truncated toward zero with NaN as 0,
    clipped to [0, size - 1] (what the kernel's saturating
    ``__float2int_rz`` and clip give; the clip runs in float64, exact
    for every int32)."""
    lo = torch.tensor(lo, dtype=torch.float32, device=v.device)
    scale = torch.tensor(scale, dtype=torch.float32, device=v.device)
    t = torch.trunc((v - lo) * scale)
    t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    return t.double().clamp(0, size - 1).long()


def density_cells_plain(x, y, xmin, ymin, sx, sy, width: int, height: int):
    """int64 [n]: each point's flat cell ``row * width + col``."""
    return (_density_bins(y, ymin, sy, height) * width
            + _density_bins(x, xmin, sx, width))


def density_grid_plain(x, y, w, mask, xmin, ymin, sx, sy, width: int,
                       height: int):
    """float32 (height, width): a port of aggregations._density_kernel
    in torch ops, the binning step by step (``density_cells_plain``),
    then ``where(mask, w, 0)`` accumulated into a zeroed grid by
    ``index_put_``; ``w`` None means unit weights."""
    flat = density_cells_plain(x, y, xmin, ymin, sx, sy, width, height)
    ones = torch.ones_like(x)
    vals = torch.where(mask, ones if w is None else w, torch.zeros_like(x))
    grid = torch.zeros(height * width, dtype=torch.float32, device=x.device)
    grid.index_put_((flat,), vals, accumulate=True)
    return grid.view(height, width)


def _check_grid(width: int, height: int):
    if width < 1 or height < 1 or width * height >= 2**31:
        raise ValueError(f"a {height} x {width} grid is outside 1 .. 2^31 - 1 "
                         f"cells")


def density_grid(x, y, w, mask, xmin, ymin, sx, sy, width: int,
                 height: int):
    """float32 (height, width) grid on the points' device: the sum of
    the weights ``w`` (f32 [n]; None means 1) of the points (x[i], y[i])
    (f32 [n]) with ``mask[i]`` (bool [n]) in the cell of row
    ``clip(int((y - ymin) * sy), 0, height - 1)`` and the column alike.
    ``xmin``, ``ymin``, ``sx`` and ``sy`` are f32 values
    (``aggregations.density_scalars``). The cells' f32 sums follow the
    order of the kernel's atomic adds: exact while a cell's total is an
    integer below 2^24, else within ``2 * n_cell * 2^-24 * sum |w|``."""
    tensors = (x, y, mask) + (() if w is None else (w,))
    if any(t.dim() != 1 or t.shape != x.shape or not t.is_contiguous()
           for t in tensors):
        raise ValueError("x, y, w and mask must be contiguous 1-d tensors "
                         "of one length")
    if (x.dtype != torch.float32 or y.dtype != torch.float32
            or (w is not None and w.dtype != torch.float32)
            or mask.dtype != torch.bool):
        raise ValueError("x, y and w must be float32 and mask bool")
    _check_grid(width, height)
    if _on_cpu(tensors):
        return density_grid_plain(x, y, w, mask, xmin, ymin, sx, sy, width,
                                  height)
    n = x.shape[0]
    grid = torch.zeros((height, width), dtype=torch.float32, device=x.device)
    if n == 0:
        return grid
    rc = _library().geomesa_density_grid(
        x.data_ptr(), y.data_ptr(), 0 if w is None else w.data_ptr(),
        mask.data_ptr(), n, float(xmin), float(ymin), float(sx), float(sy),
        width, height, -1, grid.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "density_grid")
    launches["density_grid"] += 1
    return grid


# weight slots of the rows loader, by DeviceColumns kind: the kernel's
# code and the slot's dtypes (a, b)
_DENSITY_WEIGHTS = {"f64": (1, torch.float32, None),
                    "i64": (2, torch.int32, torch.int32),
                    "bool": (3, torch.bool, None)}


def density_weights_plain(kind: str, a, b, rows):
    """float32 weights of ``rows`` (int64) from a weight slot: an f64
    column's hi word (f32 rounded to nearest); an i64 column's (hi, lo)
    words rebuilt into the int64, rounded to f64 and then to f32 (as
    numpy's ``where(valid, v, 0.0).astype(float32)`` does); a bool
    column's values as 1 or 0."""
    if kind == "f64":
        return a[rows]
    if kind == "i64":
        v = (a[rows].long() << 32) | (b[rows].long() & 0xFFFFFFFF)
        return v.double().float()
    if kind == "bool":
        return a[rows].float()
    raise ValueError(f"no density weights from a {kind!r} column")


def density_rows_gather(ids, point, weight):
    """(x, y, w, mask) of rows ``ids`` as the rows loader reads them:
    the point slot's x and y, the weights (None: unit;
    ``density_weights_plain``), and the rows that count (a valid point,
    and a valid weight when weighted)."""
    rows = ids.long()
    px, py, pvalid = point
    mask = pvalid[rows]
    w = None
    if weight is not None:
        kind, (a, b, valid) = weight
        w = density_weights_plain(kind, a, b, rows)
        mask = mask & valid[rows]
    return px[rows], py[rows], w, mask


def density_grid_rows_plain(ids, point, weight, xmin, ymin, sx, sy,
                            width: int, height: int):
    """The rows loader's grid in torch ops: ``density_rows_gather``,
    then ``density_grid_plain``."""
    x, y, w, mask = density_rows_gather(ids, point, weight)
    return density_grid_plain(x, y, w, mask, xmin, ymin, sx, sy, width,
                              height)


def density_grid_rows(ids, point, weight, xmin, ymin, sx, sy, width: int,
                      height: int):
    """``density_grid`` over a query result's rows, read where they
    live: ``ids`` int32 [m], rows of the columns (the caller keeps them
    in range); ``point`` the point column's DeviceColumns slot (x f32,
    y f32 rounded to nearest, valid bool); ``weight`` None or (kind,
    slot) of a DeviceColumns entry of kind f64 (hi f32), i64 (hi, lo
    int32 words) or bool (values). A row counts when its point is valid
    and its weight, if any, is valid. Same tolerance as
    ``density_grid``."""
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-d int32 tensor")
    px, py, pvalid = point
    cap = px.shape[0]
    cols = [(px, torch.float32), (py, torch.float32), (pvalid, torch.bool)]
    kind = 0
    if weight is not None:
        name, (a, b, valid) = weight
        if name not in _DENSITY_WEIGHTS:
            raise ValueError(f"no density weights from a {name!r} column")
        kind, da, db = _DENSITY_WEIGHTS[name]
        cols += [(a, da), (valid, torch.bool)] + ([(b, db)] if db else [])
    for t, dt in cols:
        if (t.dtype != dt or t.dim() != 1 or t.shape[0] != cap
                or not t.is_contiguous()):
            raise ValueError(f"column slots must be contiguous 1-d {dt} of "
                             f"{cap} rows")
    _check_grid(width, height)
    if _on_cpu([t for t, _ in cols], ids):
        return density_grid_rows_plain(ids, point, weight, xmin, ymin, sx, sy,
                                       width, height)
    m = ids.shape[0]
    grid = torch.zeros((height, width), dtype=torch.float32, device=ids.device)
    if m == 0:
        return grid
    a, b, valid = weight[1] if weight is not None else (None, None, None)
    rc = _library().geomesa_density_rows(
        ids.data_ptr(), m, px.data_ptr(), py.data_ptr(), pvalid.data_ptr(),
        kind, 0 if a is None else a.data_ptr(),
        b.data_ptr() if kind == 2 else 0,
        0 if valid is None else valid.data_ptr(), float(xmin), float(ymin),
        float(sx), float(sy), width, height, -1, grid.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream)
    _raise_on(rc, "density_grid")
    launches["density_grid"] += 1
    return grid


DENSITY_PATHS = ("global", "block")


def density_plan(n: int, width: int, height: int, weight=None,
                 rows: bool = True, mode: int = -1) -> dict:
    """The path that the density kernel takes on the current card for
    ``n`` rows into ``width`` x ``height`` cells (``mode`` -1), or what
    forcing path ``mode`` (0 global, 1 block) would launch; ``rows`` the
    rows loader with a weight kind of ``_DENSITY_WEIGHTS`` (None: unit),
    else the array loader (``weight`` None or "f32"). Needs the card."""
    if rows:
        loader = 2 + (0 if weight is None else _DENSITY_WEIGHTS[weight][0])
    else:
        loader = 0 if weight is None else 1
    out = (ctypes.c_longlong * 3)()
    rc = _library().geomesa_density_plan(loader, n, width, height, mode, out)
    _raise_on(rc, "density_plan")
    return {"path": DENSITY_PATHS[out[0]], "blocks": out[1],
            "flush_adds": out[2]}


# -- extent tristate (csrc/extent.cu) ---------------------------------------

# rows per chunk of the plain version: (chunk, K) intermediates stay near
# 2^24 elements, whatever the number of boxes or intervals
_TRISTATE_PLAIN_ELEMS = 1 << 24


def _tristate_rows(bounds, valid, times, outer, inner, intervals):
    """The states of one chunk of rows, in _tristate_body's steps."""
    bxmin, bymin, bxmax, bymax = (bounds[:, c, None] for c in range(4))
    ob = outer[None, :, :]
    # overlap with the outward-rounded box: False means surely disjoint
    overlap = ((bxmax >= ob[..., 0]) & (bxmin <= ob[..., 2])
               & (bymax >= ob[..., 1]) & (bymin <= ob[..., 3]))
    ib = inner[None, :, :]
    # inside the inward-rounded box: True means surely inside
    inside = ((bxmin >= ib[..., 0]) & (bxmax <= ib[..., 2])
              & (bymin >= ib[..., 1]) & (bymax <= ib[..., 3]))
    any_overlap = overlap.any(dim=1)
    any_inside = inside.any(dim=1)
    zero = torch.zeros((), dtype=torch.int8, device=bounds.device)
    state = torch.where(any_inside, torch.full_like(zero, 2),
                        torch.where(any_overlap, torch.ones_like(zero), zero))
    state = torch.where(valid, state, zero)
    if times is None or intervals.shape[0] == 0:
        return state
    tday, tms = times[:, 0, None], times[:, 1, None]
    tx = intervals[None, :, :]
    after = (tday > tx[..., 0]) | ((tday == tx[..., 0]) & (tms >= tx[..., 1]))
    before = (tday < tx[..., 2]) | ((tday == tx[..., 2]) & (tms <= tx[..., 3]))
    t_ok = (after & before).any(dim=1)
    return torch.where(t_ok, state, zero)


def extent_tristate_plain(bounds, valid, times, outer, inner, intervals):
    """int8[n]: a port of gscan._tristate_body in torch ops, over chunks
    of rows against every box and interval. The query's tables hold only
    its real boxes and intervals (no padded slots, so no validity
    masks); no interval, or no times (None), means no time test."""
    n = bounds.shape[0]
    width = max(outer.shape[0], intervals.shape[0], 1)
    step = max(1, _TRISTATE_PLAIN_ELEMS // width)
    out = torch.empty(n, dtype=torch.int8, device=bounds.device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = _tristate_rows(
            bounds[lo:hi], valid[lo:hi],
            None if times is None else times[lo:hi], outer, inner,
            intervals)
    return out


def extent_tristate(bounds, valid, times, outer, inner, intervals):
    """int8[n] on the rows' device, 0 OUT, 1 MAYBE, 2 IN: ``bounds`` (n,
    4) f32 [xmin ymin xmax ymax] rounded outward, ``valid`` bool[n],
    ``times`` (n, 2) int32 [day, ms] or None; the query's ``outer`` and
    ``inner`` (K, 4) f32 boxes and its (B, 4) int32 ``intervals``
    [day_lo ms_lo day_hi ms_hi], all on one device."""
    if (bounds.dtype != torch.float32 or bounds.dim() != 2
            or bounds.shape[1] != 4 or not bounds.is_contiguous()):
        raise ValueError("bounds must be a contiguous (n, 4) float32 table")
    n = bounds.shape[0]
    if (valid.dtype != torch.bool or valid.shape != (n,)
            or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool[{n}]")
    if times is not None and (times.dtype != torch.int32
                              or times.shape != (n, 2)
                              or not times.is_contiguous()):
        raise ValueError(f"times must be a contiguous ({n}, 2) int32 table")
    for name, t in (("outer", outer), ("inner", inner)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 4
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (K, 4) float32 "
                             f"table")
    if outer.shape != inner.shape:
        raise ValueError("outer and inner must hold the same boxes")
    if (intervals.dtype != torch.int32 or intervals.dim() != 2
            or intervals.shape[1] != 4 or not intervals.is_contiguous()):
        raise ValueError("intervals must be a contiguous (B, 4) int32 table")
    table_bytes = 16 * (2 * outer.shape[0] + intervals.shape[0])
    if table_bytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"{outer.shape[0]} boxes and {intervals.shape[0]} intervals take "
            f"{table_bytes} bytes of shared memory; the kernel takes at "
            f"most {MAX_TABLE_BYTES}")
    cols = (bounds, valid) if times is None else (bounds, valid, times)
    if _on_cpu(cols, outer, inner, intervals):
        return extent_tristate_plain(bounds, valid, times, outer, inner,
                                     intervals)
    if bounds.data_ptr() % 16 or (times is not None and times.data_ptr() % 8):
        raise ValueError("the kernel reads a row's bounds as one 16-byte "
                         "vector and its times as one 8-byte vector: "
                         "bounds must be 16-byte aligned, times 8-byte")
    out = torch.empty(n, dtype=torch.int8, device=bounds.device)
    if n == 0:
        return out
    rc = _library().geomesa_extent_tristate(
        bounds.data_ptr(), valid.data_ptr(),
        None if times is None else times.data_ptr(), n, outer.data_ptr(),
        inner.data_ptr(), outer.shape[0], intervals.data_ptr(),
        intervals.shape[0], out.data_ptr(),
        torch.cuda.current_stream(bounds.device).cuda_stream)
    _raise_on(rc, "extent_tristate")
    launches["extent_tristate"] += 1
    return out


# -- spatial joins and knn (csrc/join.cu) ------------------------------------

# the tile of the dwithin, slab and contains kernels (columns of the
# x-sorted table) and the listed objects one of the dwithin or contains
# kernels' blocks takes (the slab kernels' blocks take SLAB_GROUP); the
# knn kernel keeps at most KNN_MAX_KPAD keys a query
JOIN_TILE = 2048
JOIN_GROUP = 1024
SLAB_GROUP = 256
KNN_MAX_KPAD = 8192

# rows per chunk of the dwithin plain version: (chunk, k) intermediates
# stay near 2^24 elements, whatever the number of queries
_JOIN_PLAIN_ELEMS = 1 << 24


def _check_vec(name: str, t, dtype, n: int | None = None):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or (
            n is not None and t.shape[0] != n):
        raise ValueError(f"{name} must be a contiguous 1-d {dtype}"
                         + ("" if n is None else f" of length {n}"))


def _f32_scalar(v: float, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def sorted_by_x(px, py, nrows: int):
    """(xs, ys, order): the rows sorted by x (stable, as jnp.argsort),
    rows >= nrows and rows whose x is NaN (which no test passes) pushed
    to +inf so they land at the tail, with the rows' y beside (NaN for
    those rows, so no slab test passes them) and the int32 row ids. xs
    holds no NaN, so a binary search of it is well defined."""
    pad = (torch.arange(px.shape[0], device=px.device) >= nrows) | px.isnan()
    key = px.masked_fill(pad, float("inf"))
    xs, order = torch.sort(key, stable=True)
    ys = py[order].masked_fill(pad[order], float("nan"))
    return xs, ys, order.to(torch.int32)


class TileLists(NamedTuple):
    """Slabs [lo, lo + width) over a table of ``ncols`` columns cut into
    ``ntiles`` tiles of ``tile`` columns aligned to 0: tile t lists the
    objects whose slab meets it, objs[offsets[t]:offsets[t + 1]],
    ascending. ``tiles`` is each entry's tile; entry i is entry perm[i]
    of the object-major order (each object's tiles in order, objects in
    order), whose object o starts at start[o]. ``most``: the longest
    list."""
    offsets: torch.Tensor   # int32[ntiles + 1]
    objs: torch.Tensor      # int32[total]
    tiles: torch.Tensor     # int64[total]
    perm: torch.Tensor      # int64[total]
    start: torch.Tensor     # int64[k]
    ntiles: int
    total: int
    most: int


def tile_lists(los, widths, ncols: int, tile: int = JOIN_TILE) -> TileLists:
    """The tile-major incidence lists of the slabs, built where the slabs
    lie with torch ops (one copy to the host: the total and the longest
    list): per-tile counts by a difference array, each object's entries
    by repeat_interleave, then a stable sort by tile."""
    dev = los.device
    lo, w = los.to(torch.int64), widths.to(torch.int64)
    k = lo.shape[0]
    ntiles = -(-int(ncols) // tile)
    live = (w > 0).to(torch.int64)
    first = torch.div(lo, tile, rounding_mode="floor")
    count = torch.where(live > 0, torch.div(lo + w - 1, tile,
                                            rounding_mode="floor") - first + 1,
                        0)
    start = torch.cumsum(count, 0) - count
    diff = torch.zeros(ntiles + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, first.clamp(0, ntiles), live)
    diff.index_add_(0, (first + count).clamp(0, ntiles), -live)
    per_tile = torch.cumsum(diff[:ntiles], 0)
    offsets = torch.zeros(ntiles + 1, dtype=torch.int32, device=dev)
    if ntiles == 0:
        total = most = 0
    else:
        offsets[1:] = torch.cumsum(per_tile, 0)
        total, most = (int(v) for v in torch.stack(
            [count.sum(), per_tile.max()]).tolist())
    if total > (1 << 31) - 1:
        raise ValueError(f"{total} (tile, object) entries: the lists hold "
                         f"int32 offsets")
    obj = torch.repeat_interleave(torch.arange(k, device=dev), count,
                                  output_size=total)
    tile_of = first[obj] + torch.arange(total, device=dev) - start[obj]
    tiles, perm = torch.sort(tile_of, stable=True)
    return TileLists(offsets, obj[perm].to(torch.int32), tiles, perm, start,
                     ntiles, total, most)


def dwithin_slabs(xs, qx, r2_hi: float, r2_lo: float):
    """(los, widths) int32 on the table's device: each query's slab of
    the x-sorted table xs that holds every row whose f32 d2 to the query
    can pass r2_hi or r2_lo (csrc/join.cu's head note has the argument):
    [searchsorted(fl(qx - w), left), searchsorted(fl(qx + w), right))
    with w = (D + 2^-23 M)(1 + 2^-22) rounded up to f32, D = sqrt(r2)
    (1 + 2^-22) + 1e-20 for the larger threshold r2, M the table's
    largest finite |x|. A non-finite qx's slab is empty, every slab is
    the whole table where w is infinite. No copy to the host."""
    dev, cap, k = xs.device, xs.shape[0], qx.shape[0]
    r2 = [v for v in (float(r2_hi), float(r2_lo)) if v == v]
    if cap == 0 or not r2:
        zero = torch.zeros(k, dtype=torch.int32, device=dev)
        return zero, zero.clone()
    d = float(np.sqrt(max(max(r2), 0.0))) * (1 + 2.0**-22) + 1e-20
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=dev)
    a = torch.searchsorted(xs, -inf, right=True)   # the first finite column
    z = torch.searchsorted(xs, inf) - 1            # and the last
    ends = xs[torch.cat([a, z]).clamp(0, cap - 1)].abs().to(torch.float64)
    big = torch.where(a <= z, ends.max(), 0.0)
    w64 = (d + big * 2.0**-23) * (1 + 2.0**-22)
    w = w64.to(torch.float32)
    w = torch.where(w.to(torch.float64) < w64, torch.nextafter(w, inf), w)
    los = torch.searchsorted(xs, qx - w)
    his = torch.searchsorted(xs, qx + w, right=True)
    widths = torch.where(torch.isfinite(qx), his - los, 0)
    full = torch.isinf(w)
    return (torch.where(full, 0, los).to(torch.int32),
            torch.where(full, cap, widths).to(torch.int32))


def dwithin_counts_plain(px, py, qx, qy, r2_hi: float, r2_lo: float,
                         nrows: int):
    """(definite, band) int32[k]: per query, the rows < nrows with f32
    d2 = dx*dx + dy*dy <= r2_lo, and those with r2_lo < d2 <= r2_hi (a
    port of _dwithin_counts_all, one elementwise op per step)."""
    k, dev = qx.shape[0], px.device
    definite = torch.zeros(k, dtype=torch.int32, device=dev)
    band = torch.zeros(k, dtype=torch.int32, device=dev)
    if k == 0 or nrows == 0:
        return definite, band
    hi, lo = _f32_scalar(r2_hi, dev), _f32_scalar(r2_lo, dev)
    step = max(1, _JOIN_PLAIN_ELEMS // k)
    for a in range(0, nrows, step):
        b = min(nrows, a + step)
        dx = px[a:b, None] - qx[None, :]
        dy = py[a:b, None] - qy[None, :]
        d2 = dx * dx + dy * dy
        d = d2 <= lo
        definite += d.sum(dim=0, dtype=torch.int32)
        band += (~d & (d2 <= hi)).sum(dim=0, dtype=torch.int32)
    return definite, band


def dwithin_counts_tiles_plain(xs, ys, qx, qy, r2_hi: float, r2_lo: float,
                               tile: int = JOIN_TILE):
    """(definite, band) int32[k]: the dwithin kernel's walk of the
    x-sorted table (xs, ys): dwithin_slabs, tile_lists, then every column
    of each tile against each query it lists. It equals dwithin_counts_plain
    on the original columns."""
    k, dev, cap = qx.shape[0], xs.device, xs.shape[0]
    definite = torch.zeros(k, dtype=torch.int32, device=dev)
    band = torch.zeros(k, dtype=torch.int32, device=dev)
    lists = tile_lists(*dwithin_slabs(xs, qx, r2_hi, r2_lo), cap, tile)
    hi, lo = _f32_scalar(r2_hi, dev), _f32_scalar(r2_lo, dev)
    step = max(1, _JOIN_PLAIN_ELEMS // tile)
    cols = torch.arange(tile, device=dev)
    for a in range(0, lists.total, step):
        q = lists.objs[a:a + step].to(torch.int64)
        c = lists.tiles[a:a + step, None] * tile + cols[None, :]
        ok = c < cap
        c = c.clamp(max=cap - 1)
        dx = xs[c] - qx[q][:, None]
        dy = ys[c] - qy[q][:, None]
        d2 = dx * dx + dy * dy
        d = (d2 <= lo) & ok
        definite.index_add_(0, q, d.sum(dim=1, dtype=torch.int32))
        band.index_add_(0, q, (~(d2 <= lo) & (d2 <= hi) & ok).sum(
            dim=1, dtype=torch.int32))
    return definite, band


def dwithin_counts(px, py, qx, qy, r2_hi: float, r2_lo: float, nrows: int,
                   xsorted=None):
    """(definite, band) int32[k] on the points' device: per query point
    (qx[q], qy[q]), the rows i < nrows of (px, py) whose f32 squared
    distance is <= r2_lo, and those with r2_lo < d2 <= r2_hi. r2_hi and
    r2_lo are f32 values. On CUDA the kernel walks the rows sorted by x
    (``sorted_by_x``), each query over the tiles its slab meets
    (``dwithin_slabs``, ``tile_lists``); ``xsorted`` passes the (xs, ys)
    of ``sorted_by_x(px, py, nrows)`` where the caller holds them (a
    resident table's cached sort), else the wrapper sorts."""
    cap = px.shape[0]
    _check_vec("px", px, torch.float32)
    _check_vec("py", py, torch.float32, cap)
    _check_vec("qx", qx, torch.float32)
    _check_vec("qy", qy, torch.float32, qx.shape[0])
    if not 0 <= nrows <= cap:
        raise ValueError(f"nrows={nrows} outside [0, {cap}]")
    if _on_cpu((px, py, qx, qy)):
        return dwithin_counts_plain(px, py, qx, qy, r2_hi, r2_lo, nrows)
    k, dev = qx.shape[0], px.device
    definite = torch.zeros(k, dtype=torch.int32, device=dev)
    band = torch.zeros(k, dtype=torch.int32, device=dev)
    if k == 0 or nrows == 0:
        return definite, band
    xs, ys = (sorted_by_x(px, py, nrows) if xsorted is None else xsorted)[:2]
    _check_vec("xs", xs, torch.float32, cap)
    _check_vec("ys", ys, torch.float32, cap)
    _on_cpu((px, xs, ys))
    lists = tile_lists(*dwithin_slabs(xs, qx, r2_hi, r2_lo), cap)
    if lists.total == 0:
        return definite, band
    _dwithin_counts_launch(xs, ys, lists, qx, qy, r2_hi, r2_lo, definite,
                           band)
    return definite, band


def _dwithin_counts_launch(xs, ys, lists, qx, qy, r2_hi, r2_lo, definite,
                           band):
    """The dwithin kernel over the lists: definite, band += the counts."""
    rc = _library().geomesa_dwithin_counts(
        xs.data_ptr(), ys.data_ptr(), xs.shape[0], lists.offsets.data_ptr(),
        lists.objs.data_ptr(), -(-lists.most // JOIN_GROUP), qx.data_ptr(),
        qy.data_ptr(), r2_hi, r2_lo, definite.data_ptr(), band.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(rc, "dwithin_counts")
    launches["dwithin_counts"] += 1


def _check_slabs(xs, ys, order, los, widths):
    """The sorted table's and the slabs' checks (one copy to the host)."""
    cap = xs.shape[0]
    _check_vec("xs", xs, torch.float32)
    _check_vec("ys", ys, torch.float32, cap)
    _check_vec("order", order, torch.int32, cap)
    _check_vec("los", los, torch.int32)
    _check_vec("widths", widths, torch.int32, los.shape[0])
    if los.shape[0]:
        lo, w = los.to(torch.int64), widths.to(torch.int64)
        if bool(((lo < 0) | (w < 0) | (lo + w > cap)).any()):
            raise ValueError(f"slabs must lie within the table's {cap} rows")


def slab_pairs_plain(xs, ys, order, los, widths, qa, r2_hi: float,
                     eps: float, box: bool):
    """(rows, qi) int32[m]: per query in order, its slab columns in order
    that match (box mode: inside qa[q]'s [xmin ymin xmax ymax] widened by
    the f32 eps; radius mode: f32 d2 to qa[q]'s (x, y) <= r2_hi), as
    order[lo + col] and q (a port of _slab_cand_flat and
    _contains_cand_flat mapped to rows)."""
    dev = xs.device
    e, hi = _f32_scalar(eps, dev), _f32_scalar(r2_hi, dev)
    rows, qis = [], []
    for q, (lo, w) in enumerate(zip(los.tolist(), widths.tolist())):
        if w <= 0:
            continue
        hit = _slab_hits(xs[lo:lo + w], ys[lo:lo + w], qa[q], hi, e, box)
        r = order[lo:lo + w][hit]
        rows.append(r)
        qis.append(torch.full_like(r, q))
    if not rows:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    return torch.cat(rows), torch.cat(qis)


def _slab_hits(x, y, a, hi, e, box: bool):
    """The slab test of columns (x, y) against one query's row ``a`` of
    qa (box mode: its box widened by the f32 e; radius mode: f32 d2 <=
    hi)."""
    if box:
        return ((x >= a[0] - e) & (x <= a[2] + e)
                & (y >= a[1] - e) & (y <= a[3] + e))
    dx, dy = x - a[0], y - a[1]
    return dx * dx + dy * dy <= hi


def slab_pairs_tiles_plain(xs, ys, order, los, widths, qa, r2_hi: float,
                           eps: float, box: bool, tile: int = JOIN_TILE):
    """(rows, qi) as slab_pairs_plain, by the slab kernels' walk:
    tile_lists over the slabs; per list entry, the tile's columns inside
    its query's slab through the test, their count and columns kept at
    the entry's object-major index (the counts pass); the inclusive
    prefix of the counts in that order; then each entry's matches
    written from its prefix less its count (the write pass)."""
    dev, cap = xs.device, xs.shape[0]
    lists = tile_lists(los, widths, cap, tile)
    e, hi = _f32_scalar(eps, dev), _f32_scalar(r2_hi, dev)
    lo_h, w_h = los.tolist(), widths.tolist()
    counts = torch.zeros(lists.total, dtype=torch.int64, device=dev)
    cols = [None] * lists.total
    perm = lists.perm.tolist()
    entries = list(zip(lists.tiles.tolist(), lists.objs.tolist(), perm))
    for t, q, at in entries:
        c0 = max(lo_h[q], t * tile)
        c1 = min(lo_h[q] + w_h[q], (t + 1) * tile, cap)
        hit = _slab_hits(xs[c0:c1], ys[c0:c1], qa[q], hi, e, box)
        cols[at] = c0 + torch.nonzero(hit).flatten()
        counts[at] = len(cols[at])
    incl = torch.cumsum(counts, 0)
    total = int(incl[-1]) if lists.total else 0
    rows = torch.empty(total, dtype=torch.int32, device=dev)
    qi = torch.empty(total, dtype=torch.int32, device=dev)
    for t, q, at in entries:
        off, n = int(incl[at] - counts[at]), int(counts[at])
        rows[off:off + n] = order[cols[at]]
        qi[off:off + n] = q
    return rows, qi


def slab_pairs(xs, ys, order, los, widths, qa, r2_hi: float, eps: float,
               box: bool):
    """(rows, qi) int32[m] on the table's device: the matching slab rows
    of every query, query-major and in slab order. ``xs``, ``ys``: the
    x-sorted f32 table (padded rows at x = +inf, y = NaN); ``order``:
    its int32 row ids; ``los``, ``widths``: int32 slabs [lo, lo + width)
    per query; ``qa``: (k, 4) f32 boxes (box mode) or (k, 2) f32 points
    (radius mode); r2_hi and eps are f32 values. On CUDA: the counts
    pass over the tiles each slab meets (``tile_lists``), an inclusive
    prefix of the counts in query order on the card (one copy to the
    host: the total), then the write pass."""
    _check_slabs(xs, ys, order, los, widths)
    k = los.shape[0]
    if (qa.dtype != torch.float32 or qa.shape != (k, 4 if box else 2)
            or not qa.is_contiguous()):
        raise ValueError(f"qa must be a contiguous ({k}, {4 if box else 2}) "
                         f"float32 table")
    if _on_cpu((xs, ys, order, los, widths, qa)):
        return slab_pairs_plain(xs, ys, order, los, widths, qa, r2_hi, eps,
                                box)
    dev, cap = xs.device, xs.shape[0]
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    lists = tile_lists(los, widths, cap)
    if lists.total == 0:
        return empty, empty.clone()
    counts = torch.empty(lists.total, dtype=torch.int32, device=dev)
    bits = torch.empty(lists.total * (JOIN_TILE // 32), dtype=torch.int32,
                       device=dev)
    incl = _slab_counts_launch(xs, ys, los, widths, qa, r2_hi, eps, box,
                               lists, counts, bits)
    total = int(incl[-1])
    if total == 0:
        return empty, empty.clone()
    rows = torch.empty(total, dtype=torch.int32, device=dev)
    qi = torch.empty(total, dtype=torch.int32, device=dev)
    _slab_write_launch(order, los, widths, lists, counts, incl, bits, rows,
                       qi)
    return rows, qi


def _slab_counts_launch(xs, ys, los, widths, qa, r2_hi, eps, box, lists,
                        counts, bits):
    """The slab counts pass over the lists into counts and bits (each
    entry's at its object-major index); returns their inclusive prefix
    (int64, on the device)."""
    rc = _library().geomesa_slab_counts(
        xs.data_ptr(), ys.data_ptr(), xs.shape[0], lists.offsets.data_ptr(),
        lists.objs.data_ptr(), -(-lists.most // SLAB_GROUP),
        lists.perm.data_ptr(), los.data_ptr(), widths.data_ptr(), int(box),
        qa.data_ptr(), r2_hi, eps, counts.data_ptr(), bits.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(rc, "slab_pairs")
    launches["slab_pairs"] += 1
    return torch.cumsum(counts, 0, dtype=torch.int64)


def _slab_write_launch(order, los, widths, lists, counts, incl, bits, rows,
                       qi):
    """The slab write pass over the lists into rows and qi."""
    rc = _library().geomesa_slab_write(
        order.data_ptr(), order.shape[0], lists.offsets.data_ptr(),
        lists.objs.data_ptr(), -(-lists.most // SLAB_GROUP),
        lists.perm.data_ptr(), los.data_ptr(), widths.data_ptr(),
        counts.data_ptr(), incl.data_ptr(), bits.data_ptr(), rows.data_ptr(),
        qi.data_ptr(), torch.cuda.current_stream(order.device).cuda_stream)
    _raise_on(rc, "slab_pairs")
    launches["slab_pairs"] += 1


def _check_polys(xs, ys, order, los, widths, boxes, edges, ecount):
    _check_slabs(xs, ys, order, los, widths)
    kp = los.shape[0]
    if (boxes.dtype != torch.float32 or boxes.shape != (kp, 4)
            or not boxes.is_contiguous()):
        raise ValueError(f"boxes must be a contiguous ({kp}, 4) float32 table")
    if (edges.dtype != torch.float32 or edges.dim() != 3
            or edges.shape[0] != kp or edges.shape[1] < 1
            or edges.shape[2] != 4 or not edges.is_contiguous()):
        raise ValueError(f"edges must be a contiguous ({kp}, ne >= 1, 4) "
                         f"float32 table")
    _check_vec("ecount", ecount, torch.int32, kp)
    ec = ecount.cpu().numpy()
    if len(ec) and ((ec < 0).any() or (ec > edges.shape[1]).any()):
        raise ValueError("ecount must lie in [0, ne]")


def _check_aligned(boxes, edges):
    if boxes.data_ptr() % 16 or edges.data_ptr() % 16:
        raise ValueError("the kernel reads boxes and edges as 16-byte "
                         "vectors: both must be 16-byte aligned")


def _contains_one(xs, ys, order, lo, w, box, edges, ec, e, eps2):
    """(definite, band, band rows in slab order) of one polygon: its slab
    rows inside the widened box, then pip_pairs_plain against its ec
    valid edges (a port of _contains_counts_all's body)."""
    x, y = xs[lo:lo + w], ys[lo:lo + w]
    inbox = ((x >= box[0] - e) & (x <= box[2] + e)
             & (y >= box[1] - e) & (y <= box[3] + e))
    idx = torch.nonzero(inbox).flatten()
    if ec == 0 or not len(idx):
        return 0, 0, order[:0]
    xi, yi, edg = x[idx], y[idx], edges[:ec]
    inside = torch.empty(len(idx), dtype=torch.bool, device=xs.device)
    band = torch.empty_like(inside)
    step = max(1, _PIP_PLAIN_ELEMS // ec)
    for a in range(0, len(idx), step):
        cross, d2 = pip_pairs_plain(xi[a:a + step], yi[a:a + step], edg)
        inside[a:a + step] = (cross.sum(dim=1) % 2) == 1
        band[a:a + step] = d2.min(dim=1).values < eps2
    rows = order[lo:lo + w][idx[band]]
    return int((inside & ~band).sum()), int(band.sum()), rows


def contains_counts_plain(xs, ys, order, los, widths, boxes, edges, ecount,
                          eps: float, eps2: float, band_cap: int):
    """(definite, band, band_rows): int32[kp] counts and the first
    band_cap band rows per polygon, -1 filled (a port of
    _contains_counts_all)."""
    dev = xs.device
    kp = los.shape[0]
    dc = torch.zeros(kp, dtype=torch.int32, device=dev)
    bc = torch.zeros(kp, dtype=torch.int32, device=dev)
    brows = torch.full((kp, band_cap), -1, dtype=torch.int32, device=dev)
    e, e2 = _f32_scalar(eps, dev), _f32_scalar(eps2, dev)
    for p, (lo, w, ec) in enumerate(zip(los.tolist(), widths.tolist(),
                                        ecount.tolist())):
        if w <= 0:
            continue
        d, b, rows = _contains_one(xs, ys, order, lo, w, boxes[p], edges[p],
                                   ec, e, e2)
        dc[p], bc[p] = d, b
        rows = rows[:band_cap]
        brows[p, :len(rows)] = rows
    return dc, bc, brows


def contains_rows_items(lists: TileLists, cband, polys, kp: int,
                        cap: int):
    """int32 (n, 4) work items of the contains kernel's rows pass, on the
    lists' device: (tile, polygon, slot, offset) for each list entry of a
    listed polygon (slot: its index in ``polys``, distinct) with band
    rows (``cband``, the counts pass's band count of each entry) that
    start before ``cap``; the offset is the band rows of the polygon's
    earlier tiles (a prefix of cband in object-major order)."""
    dev = cband.device
    om = torch.empty(lists.total, dtype=torch.int64, device=dev)
    om[lists.perm] = cband.to(torch.int64)
    excl = torch.cumsum(om, 0) - om
    obj = lists.objs.to(torch.int64)
    off = excl[lists.perm] - excl[lists.start[obj]]
    slot = torch.full((kp,), -1, dtype=torch.int64, device=dev)
    slot[torch.as_tensor(polys, dtype=torch.int64, device=dev)] = \
        torch.arange(len(polys), device=dev)
    keep = torch.nonzero((cband > 0) & (off < cap) & (slot[obj] >= 0))
    keep = keep.flatten()
    return torch.stack([lists.tiles[keep], obj[keep], slot[obj[keep]],
                        off[keep]], dim=1).to(torch.int32).contiguous()


def contains_counts_tiles_plain(xs, ys, order, los, widths, boxes, edges,
                                ecount, eps: float, eps2: float,
                                band_cap: int, tile: int = JOIN_TILE):
    """(definite, band, band_rows) as contains_counts_plain, by the
    contains kernels' walk: tile_lists over the polygons' slabs; per
    list entry the tile's columns inside the polygon's slab through the
    box and the edges (the counts pass, with each entry's band count);
    then contains_rows_items and each item's band rows from its offset
    (the rows pass)."""
    dev, cap = xs.device, xs.shape[0]
    kp = los.shape[0]
    dc = torch.zeros(kp, dtype=torch.int32, device=dev)
    bc = torch.zeros(kp, dtype=torch.int32, device=dev)
    brows = torch.full((kp, band_cap), -1, dtype=torch.int32, device=dev)
    lists = tile_lists(los, widths, cap, tile)
    e, e2 = _f32_scalar(eps, dev), _f32_scalar(eps2, dev)
    lo_h, w_h, ec_h = los.tolist(), widths.tolist(), ecount.tolist()

    def entry(t, p):
        c0 = max(lo_h[p], t * tile)
        c1 = min(lo_h[p] + w_h[p], (t + 1) * tile, cap)
        return _contains_one(xs, ys, order, c0, c1 - c0, boxes[p], edges[p],
                             ec_h[p], e, e2)
    cband = torch.zeros(lists.total, dtype=torch.int32, device=dev)
    for i, (t, p) in enumerate(zip(lists.tiles.tolist(),
                                   lists.objs.tolist())):
        d, b, _ = entry(t, p)
        dc[p] += d
        bc[p] += b
        cband[i] = b
    banded = torch.nonzero(bc).flatten().tolist()
    if banded and band_cap > 0:
        for t, p, s, off in contains_rows_items(lists, cband, banded, kp,
                                                band_cap).tolist():
            rows = entry(t, p)[2][:band_cap - off]
            brows[p, off:off + len(rows)] = rows
    return dc, bc, brows


def contains_counts(xs, ys, order, los, widths, boxes, edges, ecount,
                    eps: float, eps2: float, band_cap: int):
    """(definite, band, band_rows) on the table's device: per polygon p,
    its slab rows inside boxes[p] ([xmin ymin xmax ymax] widened by the
    f32 eps) counted as definite (inside by the crossing number, least
    squared distance to its ecount[p] valid edges of edges[p] >= eps2)
    or band (< eps2), and its first band_cap band rows in slab order
    (int32, -1 filled). On CUDA: the counts pass over the table's tiles
    (``tile_lists``), then the rows pass for the polygons with band
    rows."""
    _check_polys(xs, ys, order, los, widths, boxes, edges, ecount)
    if _on_cpu((xs, ys, order, los, widths, boxes, edges, ecount)):
        return contains_counts_plain(xs, ys, order, los, widths, boxes, edges,
                                     ecount, eps, eps2, band_cap)
    _check_aligned(boxes, edges)
    dev = xs.device
    kp = los.shape[0]
    dc = torch.zeros(kp, dtype=torch.int32, device=dev)
    bc = torch.zeros(kp, dtype=torch.int32, device=dev)
    brows = torch.full((kp, band_cap), -1, dtype=torch.int32, device=dev)
    lists = tile_lists(los, widths, xs.shape[0])
    if lists.total == 0:
        return dc, bc, brows
    terms = torch.empty_like(edges)
    cband = _contains_counts_launch(xs, ys, los, widths, boxes, edges, ecount,
                                    eps, eps2, lists, terms, dc, bc)
    banded = np.flatnonzero(bc.cpu().numpy())
    if len(banded) and band_cap > 0:
        brows[torch.from_numpy(banded).to(dev)] = _contains_rows_launch(
            xs, ys, order, los, widths, boxes, edges, ecount, eps, eps2,
            lists, terms, cband, banded, band_cap)
    return dc, bc, brows


def _contains_counts_launch(xs, ys, los, widths, boxes, edges, ecount, eps,
                            eps2, lists, terms, dc, bc):
    """The counts pass over the lists: dc, bc (zeroed) += the counts;
    returns each list entry's band count (on the device). ``terms``: an
    edges-shaped scratch that the pass fills."""
    dev = xs.device
    cband = torch.empty(lists.total, dtype=torch.int32, device=dev)
    rc = _library().geomesa_contains_counts(
        xs.data_ptr(), ys.data_ptr(), xs.shape[0], lists.offsets.data_ptr(),
        lists.objs.data_ptr(), -(-lists.most // JOIN_GROUP), los.data_ptr(),
        widths.data_ptr(), boxes.data_ptr(), edges.data_ptr(),
        ecount.data_ptr(), edges.shape[0], edges.shape[1], eps, eps2,
        terms.data_ptr(), dc.data_ptr(), bc.data_ptr(), cband.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "contains_counts")
    launches["contains_counts"] += 1
    return cband


def _contains_rows_launch(xs, ys, order, los, widths, boxes, edges, ecount,
                          eps, eps2, lists, terms, cband, polys, cap):
    """int32[len(polys), cap]: the rows pass over the list entries of the
    listed polygons (distinct) that hold band rows, each from its offset
    within its polygon, -1 filled."""
    dev = xs.device
    out = torch.full((len(polys), cap), -1, dtype=torch.int32, device=dev)
    items = contains_rows_items(lists, cband, polys, los.shape[0], cap)
    if not items.shape[0]:
        return out
    rc = _library().geomesa_contains_band_rows(
        xs.data_ptr(), ys.data_ptr(), order.data_ptr(), xs.shape[0],
        los.data_ptr(), widths.data_ptr(), items.data_ptr(), items.shape[0],
        boxes.data_ptr(), edges.data_ptr(), ecount.data_ptr(),
        edges.shape[0], edges.shape[1], eps, eps2, terms.data_ptr(), cap,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "contains_counts")
    launches["contains_counts"] += 1
    return out


def contains_band_rows_plain(xs, ys, order, los, widths, boxes, edges, ecount,
                             eps: float, eps2: float, polys, cap: int):
    """int32[len(polys), cap]: each listed polygon's first cap band rows
    in slab order, -1 filled (a port of _contains_band_rows)."""
    dev = xs.device
    out = torch.full((len(polys), cap), -1, dtype=torch.int32, device=dev)
    e, e2 = _f32_scalar(eps, dev), _f32_scalar(eps2, dev)
    for i, p in enumerate(polys):
        lo, w, ec = int(los[p]), int(widths[p]), int(ecount[p])
        if w <= 0:
            continue
        rows = _contains_one(xs, ys, order, lo, w, boxes[p], edges[p], ec,
                             e, e2)[2][:cap]
        out[i, :len(rows)] = rows
    return out


def contains_band_rows(xs, ys, order, los, widths, boxes, edges, ecount,
                       eps: float, eps2: float, polys, cap: int):
    """int32[len(polys), cap] on the table's device: the first cap band
    rows, in slab order, of each listed polygon (distinct indices into
    the tables of ``contains_counts``), -1 filled: a counts pass over the
    listed polygons' tiles, then the rows pass."""
    _check_polys(xs, ys, order, los, widths, boxes, edges, ecount)
    polys = [int(p) for p in polys]
    if any(not 0 <= p < los.shape[0] for p in polys) or cap < 1:
        raise ValueError("polys must index the polygon tables, cap >= 1")
    if _on_cpu((xs, ys, order, los, widths, boxes, edges, ecount)):
        return contains_band_rows_plain(xs, ys, order, los, widths, boxes,
                                        edges, ecount, eps, eps2, polys, cap)
    _check_aligned(boxes, edges)
    dev = xs.device
    if not polys:
        return torch.full((0, cap), -1, dtype=torch.int32, device=dev)
    if len(set(polys)) != len(polys):
        raise ValueError("polys must be distinct")
    # the listed polygons' slabs alone, their band counts by a counts
    # pass into scratch counts, then the rows pass
    sel = torch.tensor(polys, dtype=torch.int64, device=dev)
    listed = torch.zeros_like(widths)
    listed[sel] = widths[sel]
    lists = tile_lists(los, listed, xs.shape[0])
    if lists.total == 0:
        return torch.full((len(polys), cap), -1, dtype=torch.int32, device=dev)
    scratch = torch.zeros((2, los.shape[0]), dtype=torch.int32, device=dev)
    terms = torch.empty_like(edges)
    cband = _contains_counts_launch(xs, ys, los, listed, boxes, edges, ecount,
                                    eps, eps2, lists, terms, scratch[0],
                                    scratch[1])
    return _contains_rows_launch(xs, ys, order, los, listed, boxes, edges,
                                 ecount, eps, eps2, lists, terms, cband, polys,
                                 cap)


def knn_topk_plain(px, py, qx, qy, kpad: int, nrows: int):
    """(d2 f32, idx int64), each (Q, kpad): per query the kpad smallest
    f32 d2 = dx*dx + dy*dy over every row (+inf for rows >= nrows),
    ascending, ties and NaNs (last) by row id: a stable sort, which is
    lax.top_k's order on -d2 (a port of _knn_kernel)."""
    q = qx.shape[0]
    d2 = torch.empty((q, kpad), dtype=torch.float32, device=px.device)
    idx = torch.empty((q, kpad), dtype=torch.int64, device=px.device)
    for i in range(q):
        dx, dy = px - qx[i], py - qy[i]
        v = dx * dx + dy * dy
        v[nrows:] = float("inf")
        s, o = torch.sort(v, stable=True)
        d2[i], idx[i] = s[:kpad], o[:kpad]
    return d2, idx


# the fields of a knn plan (csrc/join.cu's geomesa_knn_plan)
_KNN_PLAN = ("group", "groups", "chunks", "chunk", "cut", "sbuf", "stride",
             "samples", "sample_stride", "launches")
# the bins of the knn kernel's histograms of published keys (a query's)
_KNN_HIST_BINS = 2048


def _knn_plan(length: int, nq: int, kpad: int):
    plan = (ctypes.c_int64 * len(_KNN_PLAN))()
    _raise_on(_library().geomesa_knn_plan(length, nq, kpad, plan),
              "knn_topk")
    return plan


def knn_plan(length: int, nq: int, kpad: int) -> dict:
    """The knn kernel's plan over ``length`` rows (needs the card, for
    the occupancy): queries a rows block (``group``), the groups, the
    chunks of rows and their size, the keys a block keeps at most
    (``cut``), its buffer, the survivor slots a query, the sample pass's
    blocks and their tiles' stride, and the launches."""
    return dict(zip(_KNN_PLAN, _knn_plan(length, nq, kpad)))


def _knn_keys(px, py, qx, qy, q: int, a: int, b: int, nrows: int):
    """int64 keys (d2 bits << 32 | row) of rows [a, b) for query q: f32
    d2 rounded at every step, +inf for rows >= nrows, every NaN one
    NaN."""
    dx, dy = px[a:b] - qx[q], py[a:b] - qy[q]
    d2 = dx * dx + dy * dy
    rows = torch.arange(a, b, dtype=torch.int64, device=px.device)
    d2 = torch.where(rows >= nrows, float("inf"), d2)
    bits = d2.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(d2.isnan(), 0x7FC00000, bits)
    return (bits << 32) | rows


def _bin_top(key: int) -> int:
    """The largest key of ``key``'s bin in the knn kernel's histograms
    (the key's bits 63..52)."""
    return (((key >> 52) + 1) << 52) - 1


def knn_topk_blocks_plain(px, py, qx, qy, kpad: int, nrows: int, chunk: int,
                          group: int, tile: int = 1024):
    """(d2, idx) as knn_topk_plain, by the knn kernel's walk over rows 0
    .. min(cap, nrows + kpad) - 1 (later rows rank after those). The
    sample pass: whole tiles of ``tile`` rows spread over the table (4
    a block, as the kernel's plan spaces them); in each, the least key
    of every group of 32 rows a warp holds (rows 4 * (32 w + l) + i of
    the tile for l < 32) counts in a histogram by the key's bits 63..52,
    and a query's bound is the top of the bin where the counts reach
    kpad. The rows pass: chunks of ``chunk`` rows, a block for each
    chunk and ``group`` queries; per query the block keeps its kpad
    best keys at or below the query's bound, lowers the bound to the
    kpad-th where it has that many (the kernel's cut, exact here), and
    leaves them as the query's survivors. The final pass sorts each
    query's survivors at or below its bound and keeps kpad. (The kernel
    also lowers the bound from the rows pass's own published keys; any
    such bound holds kpad keys below it, so the answer is the same.)"""
    cap, nq = px.shape[0], qx.shape[0]
    length = min(cap, nrows + kpad)
    bound = [(1 << 63) - 1] * nq
    tiles = -(-length // tile)
    samples = min(max(tiles // 128, 1), 4096)
    stride = max(tiles // (samples * 4), 1)
    starts = [i * stride * tile for i in range(samples * 4)
              if i * stride * tile + tile <= length]
    for q in range(nq):
        mins = [_knn_keys(px, py, qx, qy, q, a, a + tile, nrows)
                .view(8, 32, 4).min(dim=1).values.flatten() for a in starts]
        if mins:
            m = torch.sort(torch.cat(mins)).values
            if len(m) >= kpad:
                bound[q] = _bin_top(int(m[kpad - 1]))

    def best(q, k):
        k = torch.sort(k[k <= bound[q]]).values[:kpad]
        if len(k) == kpad:
            bound[q] = min(bound[q], int(k[-1]))
        return k
    surv = [[] for _ in range(nq)]
    for a in range(0, length, chunk):
        for g in range(0, nq, group):
            for q in range(g, min(g + group, nq)):
                surv[q].append(best(q, _knn_keys(px, py, qx, qy, q, a,
                                                 min(a + chunk, length),
                                                 nrows)))
    d2 = torch.empty((nq, kpad), dtype=torch.float32, device=px.device)
    idx = torch.empty((nq, kpad), dtype=torch.int64, device=px.device)
    for q in range(nq):
        k = best(q, torch.cat(surv[q]))
        d2[q] = (k >> 32).to(torch.int32).view(torch.float32)
        idx[q] = k & 0xFFFFFFFF
    return d2, idx


def knn_topk(px, py, qx, qy, kpad: int, nrows: int):
    """(d2 f32, idx int64), each (Q, kpad), on the points' device: per
    query point the kpad smallest (f32 squared distance, row) keys over
    the rows of (px, py), rows >= nrows at +inf, ascending in (d2, row)
    order with NaN above +inf. kpad is at most KNN_MAX_KPAD on CUDA,
    where a sample pass over a 32nd of the rows seeds a bound a query,
    the rows pass reads each row once for a group of queries and keeps
    a block's best keys a query against bounds the blocks share, and a
    final pass cuts and sorts the survivors (``knn_plan``)."""
    cap = px.shape[0]
    _check_vec("px", px, torch.float32)
    _check_vec("py", py, torch.float32, cap)
    _check_vec("qx", qx, torch.float32)
    _check_vec("qy", qy, torch.float32, qx.shape[0])
    if not 1 <= kpad <= cap or not 0 <= nrows <= cap:
        raise ValueError(f"kpad={kpad} must lie in [1, {cap}] and "
                         f"nrows={nrows} in [0, {cap}]")
    if _on_cpu((px, py, qx, qy)):
        return knn_topk_plain(px, py, qx, qy, kpad, nrows)
    if kpad > KNN_MAX_KPAD:
        raise ValueError(f"kpad={kpad}: the knn kernel keeps at most "
                         f"{KNN_MAX_KPAD} keys a query")
    if cap > 1 << 32:
        raise ValueError(f"{cap} rows: the knn kernel keys rows by 32-bit "
                         f"ids")
    dev = px.device
    nq = qx.shape[0]
    if nq == 0:
        return (torch.empty((0, kpad), dtype=torch.float32, device=dev),
                torch.empty((0, kpad), dtype=torch.int64, device=dev))
    # rows past nrows + kpad rank after those before them
    length = min(cap, nrows + kpad)
    plan = _knn_plan(length, nq, kpad)
    # zeroed state (int32 words): the sample pass's and the rows pass's
    # histograms of published keys, the shared bounds (int64, inverted,
    # so zero is the empty bound), the survivor counts
    hist = _KNN_HIST_BINS * nq
    state = torch.zeros(2 * hist + 3 * nq, dtype=torch.int32, device=dev)
    surv = torch.empty(nq * plan[6], dtype=torch.int64, device=dev)
    # the rows pass's buffers: G * sbuf keys a block
    gbuf = torch.empty(plan[1] * plan[2] * plan[0] * plan[5],
                       dtype=torch.int64, device=dev)
    d2 = torch.empty((nq, kpad), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, kpad), dtype=torch.int64, device=dev)
    base = state.data_ptr()
    rc = _library().geomesa_knn_topk(
        px.data_ptr(), py.data_ptr(), nrows, qx.data_ptr(), qy.data_ptr(),
        length, nq, kpad, plan, base, base + 4 * hist, base + 8 * hist,
        base + 8 * hist + 8 * nq, gbuf.data_ptr(), surv.data_ptr(),
        d2.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "knn_topk")
    launches["knn_topk"] += plan[9]
    return d2, idx


# -- tube select (csrc/tube.cu) ----------------------------------------------

# pairs the tube kernel stages in shared memory (it reads the rest through
# the caches), rows a tile of its time pass, and its most bucket bits
TUBE_STAGE = 2048
TUBE_TILE = 2048
TUBE_MAX_BUCKET_BITS = 12

# (rows, pairs) elements per chunk of the plain version
_TUBE_PLAIN_ELEMS = 1 << 26

_MS_DAY = 86_400_000

# an entry of the tube kernel's time-bucket index: the first pair of the
# bucket, ORed with this bit where some interval reaches the bucket
_TUBE_REACHED = 1 << 31


def _check_tube(cols, n: int, boxes, times) -> int:
    _check_cols(cols, n)
    return _check_tube_tables(boxes, times)


def _check_tube_tables(boxes, times) -> int:
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 8 or not boxes.is_contiguous()):
        raise ValueError("boxes must be a contiguous (K, 8) float32 table")
    if (times.dtype != torch.int32 or times.dim() != 2
            or times.shape[1] != 4 or not times.is_contiguous()):
        raise ValueError("times must be a contiguous (K, 4) int32 table")
    if boxes.shape[0] != times.shape[0]:
        raise ValueError("boxes and times must hold the same K pairs")
    return boxes.shape[0]


def tube_mask_plain(cols, n: int, boxes, times):
    """bool[n]: a port of _tube_kernel in torch ops, over chunks of rows
    against every pair: row r matches when, for some pair i, its
    two-float (x, y) lies in box i ([xmin_hi, xmin_lo, xmax_hi, xmax_lo,
    ymin_hi, ymin_lo, ymax_hi, ymax_lo]) AND its (day, ms) in interval i
    ([day_lo, ms_lo, day_hi, ms_hi]), edges inclusive."""
    k = boxes.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    if k == 0:
        return out
    b, t = boxes[None, :, :], times[None, :, :]
    step = max(1, _TUBE_PLAIN_ELEMS // k)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        xh, xl, yh, yl, td, tm = (c[lo:hi, None] for c in cols)
        box = (_ge2(xh, xl, b[..., 0], b[..., 1])
               & _le2(xh, xl, b[..., 2], b[..., 3])
               & _ge2(yh, yl, b[..., 4], b[..., 5])
               & _le2(yh, yl, b[..., 6], b[..., 7]))
        during = (((td > t[..., 0]) | ((td == t[..., 0]) & (tm >= t[..., 1])))
                  & ((td < t[..., 2])
                     | ((td == t[..., 2]) & (tm <= t[..., 3]))))
        out[lo:hi] = (box & during).any(dim=1)
    return out


def _time_keys(day, ms):
    """int64 keys whose order is the lexicographic (day, ms) order of any
    int32 words: day * 2^32 + (ms + 2^31)."""
    return day.to(torch.int64) * (1 << 32) + (ms.to(torch.int64) + (1 << 31))


def tube_pairs(boxes, times):
    """The tube kernel's pair tables, on the tables' device: the pairs
    sorted by their interval's lo key (stable), as (lo, pm, hi) int64[K]
    keys, pm the running max of hi, and the (K, 8) f32 boxes in that
    order. A row of key t can match only the pairs at or before the last
    lo <= t and from the first pm >= t on."""
    lo = _time_keys(times[:, 0], times[:, 1])
    order = torch.sort(lo, stable=True).indices
    hi = _time_keys(times[:, 2], times[:, 3])[order]
    return (lo[order].contiguous(), torch.cummax(hi, dim=0).values,
            hi.contiguous(), boxes[order].contiguous())


def _tube_order(times):
    """The stable argsort of the pairs' lo keys (day * 2^32 + ms + 2^31,
    the low half never negative), on the tables' device."""
    t = times[:, :2].to(torch.int64)
    return torch.argsort((t[:, 0] << 32) | (t[:, 1] + (1 << 31)),
                         stable=True)


def tube_bucket_bits(k: int) -> int:
    """The tube kernel's time buckets for a table of k pairs, as bits:
    about two buckets a pair, at least 2 and at most
    2^TUBE_MAX_BUCKET_BITS (the wrapper passes them to the kernel)."""
    b = 1
    while b < TUBE_MAX_BUCKET_BITS and (1 << b) < 2 * k:
        b += 1
    return b


def _spread(keys):
    """The kernel's monotone map of int64 time keys onto about epoch
    millis: day * 86,400,000 + ms clamped to [0, 86,399,999] (|value| <
    2^58, no overflow)."""
    ms = ((keys & 0xFFFFFFFF) - (1 << 31)).clamp(0, _MS_DAY - 1)
    return (keys >> 32) * _MS_DAY + ms


def tube_index_plain(lo, pm, hi, bits: int):
    """The tube kernel's time-bucket index over ``tube_pairs``' sorted
    tables, as each block builds it: (lo_min, pm_max, base, shift,
    index). A key t >= lo_min lies in bucket (spread(t) - base) >> shift
    (``_spread``; base the least lo's), clamped to 2^bits, with the least
    shift that leaves pm_max's bucket below 2^bits; the map is monotone.
    Entry j of the int64 index (j = 0..2^bits) is the number of pairs
    whose lo lies in a bucket before j, ORed with 2^31 where some
    interval with lo <= hi reaches bucket j (a difference array over the
    buckets and its running sum). Tests only."""
    nb = 1 << bits
    lo_min, top = int(lo[0]), int(pm[-1])
    base = int(_spread(lo[:1]))
    shift = (max(0, (int(_spread(pm[-1:])) - base).bit_length() - bits)
             if top >= lo_min else 0)
    bl = ((_spread(lo) - base) >> shift).clamp(max=nb)
    valid = lo <= hi
    diff = torch.zeros(nb + 1, dtype=torch.int64, device=lo.device)
    diff.index_add_(0, bl[valid], torch.ones_like(bl[valid]))
    bh = ((_spread(hi[valid]) - base) >> shift).clamp(max=nb)
    diff.index_add_(0, bh + 1, -torch.ones_like(bh))
    reach = torch.cumsum(diff, 0) > 0
    reach[nb] = False
    first = torch.searchsorted(bl, torch.arange(nb + 1, device=lo.device))
    return lo_min, top, base, shift, first | (reach.to(torch.int64)
                                              * _TUBE_REACHED)


def tube_mask_index_plain(cols, n: int, lo, pm, hi, boxes,
                          bits: int | None = None, stage: int = TUBE_STAGE):
    """bool[n]: the tube kernel's decomposition in torch ops, over the
    sorted tables of ``tube_pairs`` and the index of
    ``tube_index_plain`` (``bits`` defaults to the kernel's
    ``tube_bucket_bits``): a row outside [lo_min, pm_max] or in a bucket
    no interval reaches is rejected; the rest, packed in row order, each
    binary-search the pairs between their bucket's two index entries for
    the last lo <= t and walk back while pm >= t, testing hi >= t and the
    box. The first ``stage`` pairs are read from a staged copy, the rest
    from the tables, as the kernel reads shared and global memory. Tests
    only; ``tube_mask_plain`` is the version the CPU wrapper runs."""
    k = lo.shape[0]
    bits = tube_bucket_bits(k) if bits is None else bits
    lo_min, top, base, shift, index = tube_index_plain(lo, pm, hi, bits)
    t = _time_keys(cols[4][:n], cols[5][:n])
    hit = torch.zeros(n, dtype=torch.bool, device=t.device)
    if top < lo_min:
        return hit                  # every interval is empty
    inside = (t >= lo_min) & (t <= top)
    j = (_spread(torch.where(inside, t, lo_min)) - base) >> shift
    rows = torch.nonzero(inside & ((index[j] & _TUBE_REACHED) != 0)).flatten()
    t, j = t[rows], j[rows]
    staged = min(k, stage)
    tables = [(tb[:staged].clone(), tb) for tb in (lo, pm, hi, boxes)]

    def pair(which, i):
        s, g = tables[which]
        i = i.clamp(0, k - 1)
        near = i < staged
        got = torch.where(near.view(-1, *[1] * (g.dim() - 1)),
                          s[i.clamp(max=staged - 1)], g[i])
        return got
    a = index[j] & ~_TUBE_REACHED
    b = index[j + 1] & ~_TUBE_REACHED
    while True:
        live = a < b
        if not live.any():
            break
        mid = (a + b) >> 1
        le = pair(0, mid) <= t
        a = torch.where(live & le, mid + 1, a)
        b = torch.where(live & ~le, mid, b)
    i = a - 1
    while True:
        live = (i >= 0) & (pair(1, i) >= t)
        rows, i, t = rows[live], i[live], t[live]
        if not rows.numel():
            break
        bx = pair(3, i)
        x = (cols[0][rows], cols[1][rows], cols[2][rows], cols[3][rows])
        m = ((pair(2, i) >= t) & _ge2(x[0], x[1], bx[:, 0], bx[:, 1])
             & _le2(x[0], x[1], bx[:, 2], bx[:, 3])
             & _ge2(x[2], x[3], bx[:, 4], bx[:, 5])
             & _le2(x[2], x[3], bx[:, 6], bx[:, 7]))
        hit[rows[m]] = True
        rows, i, t = rows[~m], i[~m] - 1, t[~m]
    return hit


def tube_mask(cols, n: int, boxes, times):
    """bool[n] on the columns' device: for each of the first n rows of
    the scan columns (xhi, xlo, yhi, ylo, tday, tms), whether some pair i
    of the (K, 8) f32 ``boxes`` and (K, 4) int32 ``times`` holds it in
    box i AND interval i (both tables on the columns' device; any K, in
    any order, intervals overlapping or not; K = 0 matches nothing). On
    CUDA, two launches, both counted: the pairs' records in their sorted
    order, then the mask (tday and tms read as 16-byte vectors where both
    are 16-byte aligned, as a ScanData's are, else word by word; a table
    that is not is copied, K rows)."""
    k = _check_tube(cols, n, boxes, times)
    if _on_cpu(cols, boxes, times):
        return tube_mask_plain(cols, n, boxes, times)
    boxes, times = (t.clone() if t.data_ptr() % 16 else t
                    for t in (boxes, times))
    dev = cols[0].device
    if n == 0 or k == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    rec = torch.empty((k, 8), dtype=torch.int64, device=dev)
    rc = _library().geomesa_tube_mask(
        *_ptrs(cols), n, times.data_ptr(), boxes.data_ptr(),
        _tube_order(times).data_ptr(), rec.data_ptr(), k,
        tube_bucket_bits(k), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "tube_mask")
    launches["tube_mask"] += 2
    return out


# -- standing filters (csrc/standing.cu) ------------------------------------

# the slot grid: 1-degree cells over the world from (-180, -90); a slot
# whose boxes reach more cells is tested against every row instead; the
# sort kernel's shared-memory tile (ids a segment, else bitmap words)
STANDING_GRID_X, STANDING_GRID_Y = 360, 180
STANDING_CELLS = STANDING_GRID_X * STANDING_GRID_Y
STANDING_MAX_SLOT_CELLS = 1024
STANDING_SORT_TILE = 4096

# a slot's mode in the grid
STANDING_NOWHERE, STANDING_GRID, STANDING_EVERYWHERE = 0, 1, 2

_STANDING_TABLES = (("boxes", torch.float32, 3), ("box_valid", torch.bool, 2),
                    ("box_any", torch.bool, 1), ("times", torch.int32, 2),
                    ("attrs", torch.float32, 3), ("attr_any", torch.bool, 2),
                    ("alive", torch.bool, 1))


class StandingGrid(NamedTuple):
    """The slot grid of a set's seven tables (``standing_grid``): each
    slot's mode (uint8 [F]: STANDING_NOWHERE, _GRID or _EVERYWHERE), each
    cell's start in ``cell_slots`` (int32 [STANDING_CELLS + 1], cell
    ``cy * STANDING_GRID_X + cx``), the grid slots listed once in each
    cell their boxes reach (int32 [entries]), and the everywhere slots
    (int32 [n]). The order within a cell and of ``every`` is the build's
    (the plain version lists them ascending; the kernels in no set
    order)."""
    mode: torch.Tensor
    cell_start: torch.Tensor
    cell_slots: torch.Tensor
    every: torch.Tensor


def _check_standing_tables(tables) -> tuple[int, int, int]:
    """(F, K, A) of a set's seven tables; raises on what the kernels do
    not take."""
    if len(tables) != 7:
        raise ValueError("tables are (boxes, box_valid, box_any, times, "
                         "attrs, attr_any, alive)")
    for t, (name, dt, dims) in zip(tables, _STANDING_TABLES):
        if t.dtype != dt or t.dim() != dims or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dims}-d {dt}")
    f, k, a = tables[0].shape[0], tables[0].shape[1], tables[4].shape[1]
    if (tables[0].shape[2] != 8 or tables[1].shape != (f, k)
            or tables[2].shape != (f,) or tables[3].shape != (f, 4)
            or tables[4].shape != (f, a, 4) or tables[5].shape != (f, a)
            or tables[6].shape != (f,)):
        raise ValueError("standing tables must be boxes (F, K, 8), "
                         "box_valid (F, K), box_any (F,), times (F, 4), "
                         "attrs (F, A, 4), attr_any (F, A), alive (F,)")
    if f < 1 or k < 1:
        raise ValueError("standing tables need a slot and a box width")
    return f, k, a


def _check_standing(rows, tables, n_valid: int):
    """(chunk, F, K, A) of a chunk's launch; raises on what the kernels do
    not take."""
    f, k, a = _check_standing_tables(tables)
    if len(rows) != 8:
        raise ValueError("rows are (xhi, xlo, yhi, ylo, tday, tms, avhi, "
                         "avlo)")
    chunk = rows[0].shape[0]
    for c, dt in zip(rows[:6], _DTYPES):
        if (c.dtype != dt or c.dim() != 1 or c.shape[0] != chunk
                or c.stride(0) != 1):
            raise ValueError(f"row column must be a dense 1-d {dt} of "
                             f"length {chunk}")
    for av in rows[6:]:
        if (av.dtype != torch.float32 or av.dim() != 2
                or av.shape != (a, chunk)
                or (av.numel() and (av.stride(1) != 1
                                    or av.stride() != rows[6].stride()))):
            raise ValueError(f"attribute rows must be ({a}, {chunk}) "
                             f"float32 views with unit row stride, both "
                             f"alike")
    if not 0 <= n_valid <= chunk:
        raise ValueError(f"n_valid={n_valid} outside [0, {chunk}]")
    return chunk, f, k, a


def _check_standing_grid(grid: StandingGrid, f: int):
    if not isinstance(grid, StandingGrid):
        raise ValueError("grid must be a StandingGrid (standing_grid)")
    for name, t, dt, n in (("mode", grid.mode, torch.uint8, f),
                           ("cell_start", grid.cell_start, torch.int32,
                            STANDING_CELLS + 1),
                           ("cell_slots", grid.cell_slots, torch.int32, None),
                           ("every", grid.every, torch.int32, None)):
        if (t.dtype != dt or t.dim() != 1 or not t.is_contiguous()
                or (n is not None and t.shape[0] != n)):
            raise ValueError(f"grid {name} must be a contiguous 1-d {dt}"
                             + (f" of length {n}" if n is not None else ""))


def _check_slot_vec(name: str, t, f: int):
    if t.dtype != torch.int32 or t.shape != (f,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 ({f},)")


def _check_standing_aligned(tables):
    if any(tables[i].data_ptr() % 16 for i in (0, 3, 4)):
        raise ValueError("the standing kernels read boxes, times and attrs "
                         "as 16-byte vectors: they must be 16-byte aligned")


def _standing_axis(h, origin: float, size: int):
    """The grid's cell function on f32 hi words that are not NaN (as
    csrc/standing.cu's cell_of): floor(h + origin), clamped to the axis."""
    return torch.floor(h + origin).clamp(0, size - 1).to(torch.int64)


def standing_cells_plain(xhi, yhi):
    """int64 cell of each row's hi words, -1 where either is NaN."""
    nan = torch.isnan(xhi) | torch.isnan(yhi)
    cx = _standing_axis(torch.where(nan, 0.0, xhi), 180.0, STANDING_GRID_X)
    cy = _standing_axis(torch.where(nan, 0.0, yhi), 90.0, STANDING_GRID_Y)
    return torch.where(nan, -1, cy * STANDING_GRID_X + cx)


def _box_ranges(boxes, box_valid):
    """(x0, x1, y0, y1, ok), each (F, K): each box's cell ranges, and
    whether it can hold a row (valid, no NaN hi bound, not inverted past
    a cell)."""
    hi = boxes[..., 0::2]                     # xmin, xmax, ymin, ymax
    nan = torch.isnan(hi).any(dim=2)
    hi = torch.where(nan[..., None], 0.0, hi)
    x0, x1 = (_standing_axis(hi[..., i], 180.0, STANDING_GRID_X)
              for i in (0, 1))
    y0, y1 = (_standing_axis(hi[..., i], 90.0, STANDING_GRID_Y)
              for i in (2, 3))
    ok = box_valid & ~nan & (x0 <= x1) & (y0 <= y1)
    return x0, x1, y0, y1, ok


def _segments(n):
    """For counts n (int64), each element's segment and its index within
    it."""
    seg = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    first = torch.cumsum(n, 0) - n
    return seg, torch.arange(len(seg), device=n.device) - first[seg]


def standing_grid_plain(tables) -> StandingGrid:
    """The slot grid (csrc/standing.cu's three grid launches), cells
    listed by slot ascending and the everywhere slots ascending."""
    f, k, _ = _check_standing_tables(tables)
    boxes, box_valid, box_any, _, _, _, alive = tables
    dev = boxes.device
    x0, x1, y0, y1, ok = _box_ranges(boxes, box_valid)
    ncell = torch.where(ok, (x1 - x0 + 1) * (y1 - y0 + 1), 0)
    total = ncell.sum(dim=1)
    every = alive & (box_any | (total > STANDING_MAX_SLOT_CELLS))
    gridded = alive & ~every & (total > 0)
    mode = torch.where(every, STANDING_EVERYWHERE,
                       torch.where(gridded, STANDING_GRID, STANDING_NOWHERE))
    fs, ks = torch.nonzero(ok & gridded[:, None], as_tuple=True)
    seg, i = _segments(ncell[fs, ks])
    ef, ek = fs[seg], ks[seg]
    w = x1[ef, ek] - x0[ef, ek] + 1
    cx, cy = x0[ef, ek] + i % w, y0[ef, ek] + i // w
    # a cell an earlier box of the slot reaches is listed once
    earlier = (ok[ef] & (torch.arange(k, device=dev)[None, :] < ek[:, None])
               & (x0[ef] <= cx[:, None]) & (cx[:, None] <= x1[ef])
               & (y0[ef] <= cy[:, None]) & (cy[:, None] <= y1[ef]))
    keep = ~earlier.any(dim=1)
    cell, slot = (cy * STANDING_GRID_X + cx)[keep], ef[keep]
    order = torch.argsort(cell * f + slot)
    start = torch.zeros(STANDING_CELLS + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(torch.bincount(cell, minlength=STANDING_CELLS),
                             0)
    return StandingGrid(mode.to(torch.uint8), start.to(torch.int32),
                        slot[order].to(torch.int32),
                        torch.nonzero(every).flatten().to(torch.int32))


def _standing_candidates(rows, grid: StandingGrid, n_valid: int):
    """(row, slot) int64 pairs that the grid sends to the full test: each
    valid row that has a cell with its cell's slots, then each everywhere
    slot with every valid row."""
    cell = standing_cells_plain(rows[0][:n_valid], rows[2][:n_valid])
    r = torch.nonzero(cell >= 0).flatten()
    start = grid.cell_start.to(torch.int64)
    lo = start[cell[r]]
    seg, i = _segments(start[cell[r] + 1] - lo)
    ev = grid.every.to(torch.int64)
    all_rows = torch.arange(n_valid, device=r.device)
    return (torch.cat([r[seg], all_rows.repeat(len(ev))]),
            torch.cat([grid.cell_slots.to(torch.int64)[lo[seg] + i],
                       ev.repeat_interleave(n_valid)]))


def _standing_holds(rows, tables, r, s):
    """bool per (row, slot) pair: _standing_mask's test of slot s on row r
    (alive, its interval, its attribute bounds, box_any or a valid box)."""
    xhi, xlo, yhi, ylo, tday, tms, avhi, avlo = rows
    boxes, box_valid, box_any, times, attrs, attr_any, alive = tables
    t, td, tm = times[s], tday[r], tms[r]
    ok = (alive[s]
          & ((td > t[:, 0]) | ((td == t[:, 0]) & (tm >= t[:, 1])))
          & ((td < t[:, 2]) | ((td == t[:, 2]) & (tm <= t[:, 3]))))
    if avhi.shape[0]:
        vh, vl, ab = avhi[:, r].t(), avlo[:, r].t(), attrs[s]
        ok &= (attr_any[s] | (_ge2(vh, vl, ab[..., 0], ab[..., 1])
                              & _le2(vh, vl, ab[..., 2], ab[..., 3]))).all(1)
    b = boxes[s]                                              # (P, K, 8)
    xh, xl, yh, yl = (c[r][:, None] for c in (xhi, xlo, yhi, ylo))
    inside = (_ge2(xh, xl, b[..., 0], b[..., 1])
              & _le2(xh, xl, b[..., 2], b[..., 3])
              & _ge2(yh, yl, b[..., 4], b[..., 5])
              & _le2(yh, yl, b[..., 6], b[..., 7]) & box_valid[s])
    return ok & (box_any[s] | inside.any(dim=1))


def _standing_hits(rows, tables, grid, n_valid: int):
    r, s = _standing_candidates(rows, grid, n_valid)
    hit = _standing_holds(rows, tables, r, s)
    return r[hit], s[hit]


def standing_count_plain(rows, tables, grid: StandingGrid, n_valid: int,
                         counts):
    """``counts`` (int32 [F]) plus each slot's hits among the chunk's
    first ``n_valid`` rows, in place."""
    _, s = _standing_hits(rows, tables, grid, n_valid)
    counts += torch.bincount(s, minlength=counts.shape[0]).to(torch.int32)
    return counts


def standing_write_plain(rows, tables, grid: StandingGrid, n_valid: int,
                         row0: int, cursor, out):
    """Each hit's row0 + r written into ``out`` at its slot's ``cursor``
    (int32 [F], advanced in place), row-ascending within the chunk."""
    r, s = _standing_hits(rows, tables, grid, n_valid)
    order = torch.argsort(s * max(n_valid, 1) + r)
    r, s = r[order], s[order]
    n = torch.bincount(s, minlength=cursor.shape[0])
    seg, i = _segments(n)
    out[cursor.to(torch.int64)[seg] + i] = (r + row0).to(torch.int32)
    cursor += n.to(torch.int32)
    return out


def standing_offsets_plain(counts):
    """(starts int32 [F + 1], cursor int32 [F], total): each slot's
    segment of the pairs, exclusive, and the pairs' total."""
    inc = torch.cumsum(counts.to(torch.int64), 0)
    total = int(inc[-1])
    if total >= 1 << 31:
        raise ValueError(f"{total} standing pairs: more than int32 ids")
    starts = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                         device=counts.device)
    starts[1:] = inc.to(torch.int32)
    return starts, starts[:-1].clone(), total


def standing_sort_plain(pairs, starts, counts, mode):
    """Each slot's segment of ``pairs`` ascending (a new tensor)."""
    seg = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=pairs.device),
        counts.to(torch.int64))
    keys = (seg << 31) + pairs.to(torch.int64)
    return (torch.sort(keys).values & ((1 << 31) - 1)).to(torch.int32)


def standing_grid(tables) -> StandingGrid:
    """The slot grid of a set's seven device tables (boxes (F, K, 8) f32,
    box_valid (F, K) bool, box_any (F,) bool, times (F, 4) i32, attrs
    (F, A, 4) f32, attr_any (F, A) bool, alive (F,) bool): each live slot
    listed once in each 1-degree cell its boxes reach, or as everywhere
    (box_any, or more than STANDING_MAX_SLOT_CELLS cells); dead and never
    slots nowhere. On CUDA three launches, counted (a count pass and the
    cells' prefix, then the fill once the entries' total, the build's one
    sync, sizes the lists); on CPU tensors the plain version."""
    f, k, _ = _check_standing_tables(tables)
    if _on_cpu(tables):
        return standing_grid_plain(tables)
    _check_standing_aligned(tables)
    dev = tables[0].device
    i32 = dict(dtype=torch.int32, device=dev)
    mode = torch.empty(f, dtype=torch.uint8, device=dev)
    cell_count = torch.zeros(STANDING_CELLS, **i32)
    every = torch.empty(f, **i32)
    cell_start = torch.empty(STANDING_CELLS + 1, **i32)
    cursor = torch.empty(STANDING_CELLS, **i32)
    sizes = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    tp = [t.data_ptr() for t in tables]
    rc = lib.geomesa_standing_grid_count(
        *tp, f, k, mode.data_ptr(), cell_count.data_ptr(), every.data_ptr(),
        cell_start.data_ptr(), cursor.data_ptr(), sizes.data_ptr(), stream)
    _raise_on(rc, "standing_grid")
    launches["standing_grid"] += 2
    entries, n_every = sizes.tolist()
    cell_slots = torch.empty(entries, **i32)
    if entries:
        rc = lib.geomesa_standing_grid_fill(
            *tp, f, k, mode.data_ptr(), cursor.data_ptr(),
            cell_slots.data_ptr(), stream)
        _raise_on(rc, "standing_grid")
        launches["standing_grid"] += 1
    return StandingGrid(mode, cell_start, cell_slots, every[:n_every])


def _standing_match(write: bool, rows, tables, grid, n_valid: int,
                    row0: int, counts, cursor, out):
    _check_standing_aligned(tables)
    f, k, a = tables[0].shape[0], tables[0].shape[1], tables[4].shape[1]
    dev = rows[0].device
    rc = _library().geomesa_standing_match(
        int(write), *_ptrs(rows[:6]), rows[6].data_ptr(), rows[7].data_ptr(),
        rows[6].stride(0), a, n_valid, *(t.data_ptr() for t in tables), f, k,
        *(t.data_ptr() for t in grid), grid.every.shape[0],
        counts.data_ptr() if counts is not None else 0,
        cursor.data_ptr() if cursor is not None else 0,
        out.data_ptr() if out is not None else 0, row0,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "standing_write" if write else "standing_count"
    _raise_on(rc, name)
    launches[name] += 1


def standing_count(rows, tables, grid: StandingGrid, n_valid: int, counts):
    """One ingest chunk against the grid's candidates: ``counts`` (int32
    [F]) plus each slot's hits among the first ``n_valid`` rows, in
    place. ``rows`` are the chunk's (xhi, xlo, yhi, ylo, tday, tms)
    columns (f32, f32, f32, f32, i32, i32; 1-d views) and its attributes
    (avhi, avlo), (A, chunk) f32 views with unit row stride (A may be 0);
    ``tables`` and ``grid`` as ``standing_grid``'s. On CUDA one launch,
    counted (none when n_valid is 0); on CPU tensors the plain version."""
    _, f, _, _ = _check_standing(rows, tables, n_valid)
    _check_standing_grid(grid, f)
    _check_slot_vec("counts", counts, f)
    if _on_cpu(rows, *tables, *grid, counts):
        return standing_count_plain(rows, tables, grid, n_valid, counts)
    if n_valid:
        _standing_match(False, rows, tables, grid, n_valid, 0, counts, None,
                        None)
    return counts


def standing_offsets(counts):
    """(starts int32 [F + 1], cursor int32 [F], total int): the exclusive
    prefix of the slots' counts, each slot's segment of the pairs, a
    copy of it as the write pass's cursor, and the total on the host (the
    dispatch's one sync). On CUDA one launch, counted; on CPU tensors the
    plain version."""
    if counts.dtype != torch.int32 or counts.dim() != 1 or \
            not counts.is_contiguous() or counts.shape[0] < 1:
        raise ValueError("counts must be a contiguous int32 (F>=1,)")
    if _on_cpu((counts,)):
        return standing_offsets_plain(counts)
    dev = counts.device
    f = counts.shape[0]
    starts = torch.empty(f + 1, dtype=torch.int32, device=dev)
    cursor = torch.empty(f, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    rc = _library().geomesa_standing_offsets(
        counts.data_ptr(), f, starts.data_ptr(), cursor.data_ptr(),
        total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "standing_offsets")
    launches["standing_offsets"] += 1
    t = int(total.item())
    if t >= 1 << 31:
        raise ValueError(f"{t} standing pairs: more than int32 ids")
    return starts, cursor, t


def standing_write(rows, tables, grid: StandingGrid, n_valid: int, row0: int,
                   cursor, out):
    """One chunk's hits written into ``out`` (int32 [total]): each hit row
    as ``row0 + r`` at its slot's ``cursor`` (from ``standing_offsets``,
    advanced in place). An everywhere slot's rows land in row order; a
    grid slot's in no set order (``standing_sort`` orders them). On CUDA
    one launch, counted (none when n_valid is 0); on CPU tensors the
    plain version (row order)."""
    _, f, _, _ = _check_standing(rows, tables, n_valid)
    _check_standing_grid(grid, f)
    _check_slot_vec("cursor", cursor, f)
    if out.dtype != torch.int32 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("out must be a contiguous 1-d int32")
    if not 0 <= row0 <= (1 << 31) - 1 - n_valid:
        raise ValueError(f"row0={row0}: ids past int32")
    if _on_cpu(rows, *tables, *grid, cursor, out):
        return standing_write_plain(rows, tables, grid, n_valid, row0, cursor,
                                    out)
    if n_valid:
        _standing_match(True, rows, tables, grid, n_valid, row0, None,
                        cursor, out)
    return out


def standing_sort(pairs, starts, counts, mode):
    """Each slot's segment of ``pairs`` (``starts``, ``counts`` from
    ``standing_offsets``) ascending, as a new int32 tensor: the
    filter-major, row-ascending order of ``_flat_nonzero``. On CUDA one
    launch, counted (a block a slot: a bitonic sort in shared memory up
    to STANDING_SORT_TILE ids, a bitmap of the ids' range beyond;
    everywhere segments, ascending as written, copied); on CPU tensors
    the plain version."""
    f = counts.shape[0]
    _check_slot_vec("counts", counts, f)
    if (starts.dtype != torch.int32 or starts.shape != (f + 1,)
            or mode.dtype != torch.uint8 or mode.shape != (f,)
            or pairs.dtype != torch.int32 or pairs.dim() != 1
            or not (pairs.is_contiguous() and starts.is_contiguous()
                    and mode.is_contiguous())):
        raise ValueError("sort takes int32 pairs, int32 starts (F + 1,), "
                         "int32 counts (F,) and uint8 mode (F,)")
    if _on_cpu((pairs, starts, counts, mode)):
        return standing_sort_plain(pairs, starts, counts, mode)
    out = torch.empty_like(pairs)
    if pairs.shape[0]:
        rc = _library().geomesa_standing_sort(
            pairs.data_ptr(), out.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), mode.data_ptr(), f,
            torch.cuda.current_stream(pairs.device).cuda_stream)
        _raise_on(rc, "standing_sort")
        launches["standing_sort"] += 1
    return out


def _standing_pairs(steps, chunks, tables, grid):
    grid_fn, count, offsets, write, sort = steps
    if grid is None:
        grid = grid_fn(tables)
    counts = torch.zeros(tables[0].shape[0], dtype=torch.int32,
                         device=tables[0].device)
    for rows, n_valid, _ in chunks:
        count(rows, tables, grid, n_valid, counts)
    starts, cursor, total = offsets(counts)
    pairs = torch.empty(total, dtype=torch.int32, device=counts.device)
    if total:
        for rows, n_valid, row0 in chunks:
            write(rows, tables, grid, n_valid, row0, cursor, pairs)
        pairs = sort(pairs, starts, counts, grid.mode)
    return pairs, counts, grid


def standing_pairs_plain(chunks, tables, grid: StandingGrid | None = None):
    """``standing_pairs`` through the steps' plain versions, on any
    device: the whole function's plain version."""
    return _standing_pairs((standing_grid_plain, standing_count_plain,
                            standing_offsets_plain, standing_write_plain,
                            standing_sort_plain), chunks, tables, grid)


def standing_pairs(chunks, tables, grid: StandingGrid | None = None):
    """(ids int32, counts int32 [F], grid): every (slot, row) pair for
    which ``_standing_mask`` holds, over ``chunks`` ((rows, n_valid,
    row0) each, as ``standing_count`` takes them), as row ids (row0 + r)
    slot-major and row-ascending (``_flat_nonzero``'s order) and each
    slot's count. ``grid`` is built when None. Through the wrappers: a
    count pass a chunk, one prefix (the one sync), a write pass a chunk,
    one sort."""
    return _standing_pairs((standing_grid, standing_count, standing_offsets,
                            standing_write, standing_sort), chunks, tables,
                           grid)
