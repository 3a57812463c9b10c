"""The port's kernels: wrappers, launch counts and plain versions.

Nine kernels, written in CUDA C++ for Hopper in ``csrc/scan.cu``,
``csrc/batch.cu``, ``csrc/geom.cu``, ``csrc/residual.cu`` and
``csrc/density.cu`` (see the notes at their heads for what they replace
and what bounds them):

- ``scan_mask``: the dense tier, bool[cap] over every row;
- ``scan_mask_gather``: the gathered tier, bool[m] over rows ``idx``
  (int32), read from the row-major gather table (``ScanData.rows``);
- ``scan_count``: the predicate summed to one int32 on the device;
- ``scan_batch_bits``: a batch of Qp queries in one pass over the rows,
  as hit and boundary-candidate bitmaps int32[2, Qp, words] with
  per-block popcounts int32[2, Qp, nb], each query's own boxes and
  intervals only (a (Qp, 2) counts table);
- ``compact_prefix``: the exclusive prefix of those popcounts within each
  (kind, query), as int32 offsets, and each (kind, query) total as int64;
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
- ``density_grid``: the weights of the masked points summed into a
  (height, width) f32 pixel grid by atomic adds
  (``scan/aggregations.py``).

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

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["launches", "reset_launches", "scan_mask", "scan_mask_gather",
           "scan_count", "scan_batch_bits", "compact_bits",
           "scan_mask_plain", "scan_mask_gather_plain", "scan_count_plain",
           "scan_batch_bits_plain", "compact_bits_plain", "compact_prefix",
           "compact_prefix_plain", "batch_shape", "unpack_bits",
           "build_library", "BuildInfo", "MAX_TABLE_BYTES",
           "BATCH_ROWS_PER_BLOCK", "BATCH_MAX_GROUP", "pip_mask",
           "pip_mask_plain", "pip_pairs_plain", "pip_edge_terms_plain",
           "pip_skip_plain", "residual_mask", "residual_mask_plain",
           "residual_launcher", "residual_depth", "Op", "Cmp",
           "density_grid", "density_grid_plain", "density_cells_plain"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_PKG, "csrc", f)
            for f in ("scan.cu", "batch.cu", "geom.cu", "residual.cu",
                      "density.cu")]
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

launches = {"scan_mask": 0, "scan_mask_gather": 0, "scan_count": 0,
            "scan_batch_bits": 0, "compact_prefix": 0, "compact_bits": 0,
            "pip_mask": 0, "residual_mask": 0, "density_grid": 0}


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


def compact_bits_plain(bits, partials):
    """(hit ids, candidate ids, counts): per kind the set rows of query
    0, then query 1, ..., ascending within a query (torch.nonzero), as
    int32; counts int64[2, Qp] on the host, query q's share of kind k."""
    counts = partials.sum(dim=2, dtype=torch.int64).cpu().numpy()
    return (*(torch.cat([torch.nonzero(unpack_bits(bits[kind, q])).flatten()
                         .to(torch.int32) for q in range(bits.shape[1])])
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
            lib.geomesa_compact_prefix.argtypes = [p, i32, i64, p, p, p]
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
                                                 f32, f32, i32, i32, p, p]
            for fn in (lib.geomesa_scan_mask, lib.geomesa_scan_mask_gather,
                       lib.geomesa_scan_count, lib.geomesa_scan_batch_bits,
                       lib.geomesa_compact_prefix, lib.geomesa_compact_bits,
                       lib.geomesa_batch_rows_per_block,
                       lib.geomesa_batch_max_group, lib.geomesa_pip_mask,
                       lib.geomesa_residual_mask, lib.geomesa_residual_codes,
                       lib.geomesa_density_grid):
                fn.restype = ctypes.c_int
            if (lib.geomesa_batch_rows_per_block() != BATCH_ROWS_PER_BLOCK
                    or lib.geomesa_batch_max_group() != BATCH_MAX_GROUP
                    or lib.geomesa_batch_smem_bytes(3, 4, 2)
                    != _batch_smem(3, 4, 2)):
                raise RuntimeError("csrc/batch.cu and kernels.py disagree "
                                   "on the batched kernels' block shape")
            codes = (ctypes.c_int32 * 64)()
            got = lib.geomesa_residual_codes(codes, len(codes))
            if tuple(codes[:got]) != RESIDUAL_CODES:
                raise RuntimeError("csrc/residual.cu and kernels.py disagree "
                                   "on the residual program's opcodes")
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


def compact_prefix(partials):
    """(offsets int32[2, Qp, nb], totals int64[2, Qp]) on the partials'
    device: per (kind, query) row the exclusive prefix of its partials
    (a block's first id within its query) and its sum. One block of the
    prefix kernel per row."""
    _check_partials(partials)
    if _on_cpu((partials,)):
        return compact_prefix_plain(partials)
    qp, nb = partials.shape[1], partials.shape[2]
    dev = partials.device
    offsets = torch.empty((2, qp, nb), dtype=torch.int32, device=dev)
    if qp * nb == 0:
        return offsets, torch.zeros((2, qp), dtype=torch.int64, device=dev)
    totals = torch.empty((2, qp), dtype=torch.int64, device=dev)
    rc = _library().geomesa_compact_prefix(
        partials.data_ptr(), 2 * qp, nb, offsets.data_ptr(),
        totals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "compact_prefix")
    launches["compact_prefix"] += 1
    return offsets, totals


def compact_bits(bits, partials):
    """(hit ids, candidate ids, counts): the ids int32 on the bitmaps'
    device, per kind the rows of query 0, then query 1, ..., each
    ascending; counts int64[2, Qp] on the host, query q's share of kind
    k (the sums of ``partials``). ``bits`` and ``partials`` are
    ``scan_batch_bits``'s. ``compact_prefix`` gives the blocks' offsets
    and the totals on the device; the totals' copy to the host (the one
    sync) sizes the outputs, and the kernel sums each query's base from
    the totals on the device."""
    if (bits.dtype != torch.int32 or bits.dim() != 3 or bits.shape[0] != 2
            or not bits.is_contiguous()):
        raise ValueError("bits must be a contiguous int32[2, Qp, words]")
    qp, words = bits.shape[1], bits.shape[2]
    _check_partials(partials)
    if tuple(partials.shape) != (2, qp, batch_shape(32 * words)[1]):
        raise ValueError("partials must be the contiguous int32[2, Qp, nb] "
                         "of these bits")
    if _on_cpu((bits, partials)):
        return compact_bits_plain(bits, partials)
    offsets, totals = compact_prefix(partials)
    counts = totals.cpu().numpy()
    hit_total, cand_total = (int(c) for c in counts.sum(axis=1))
    dev = bits.device
    out_hit = torch.empty(hit_total, dtype=torch.int32, device=dev)
    out_cand = torch.empty(cand_total, dtype=torch.int32, device=dev)
    if hit_total + cand_total == 0:
        return out_hit, out_cand, counts
    rc = _library().geomesa_compact_bits(
        bits.data_ptr(), partials.data_ptr(), offsets.data_ptr(),
        totals.data_ptr(), qp, partials.shape[2], words, out_hit.data_ptr(),
        out_cand.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "compact_bits")
    launches["compact_bits"] += 1
    return out_hit, out_cand, counts


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
    if width < 1 or height < 1 or width * height >= 2**31:
        raise ValueError(f"a {height} x {width} grid is outside 1 .. 2^31 - 1 "
                         f"cells")
    if _on_cpu(tensors):
        return density_grid_plain(x, y, w, mask, xmin, ymin, sx, sy, width,
                                  height)
    if (any(t.data_ptr() % 16 for t in tensors if t is not mask)
            or mask.data_ptr() % 4):
        raise ValueError("the density kernel reads x, y and w as 16-byte "
                         "and the mask as 4-byte vectors: they must be so "
                         "aligned")
    n = x.shape[0]
    grid = torch.zeros((height, width), dtype=torch.float32, device=x.device)
    if n == 0:
        return grid
    rc = _library().geomesa_density_grid(
        x.data_ptr(), y.data_ptr(), 0 if w is None else w.data_ptr(),
        mask.data_ptr(), n, float(xmin), float(ymin), float(sx), float(sy),
        width, height, grid.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "density_grid")
    launches["density_grid"] += 1
    return grid
