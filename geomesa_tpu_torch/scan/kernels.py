"""The scan kernels: wrappers, launch counts and plain versions.

Three kernels, written in CUDA C++ for Hopper in ``csrc/scan.cu`` (see
the note at its head for what they replace and what bounds them):

- ``scan_mask``: the dense tier, bool[cap] over every row;
- ``scan_mask_gather``: the gathered tier, bool[m] over rows ``idx``
  (int32), read from the row-major gather table (``ScanData.rows``);
- ``scan_count``: the predicate summed to one int32 on the device.

Each wrapper takes its plain PyTorch version ONLY when the tensors lie
on the CPU (the tests' device). On CUDA tensors it launches its kernel
or raises; it never falls back. ``launches`` counts kernel launches per
wrapper, so a run can show that its main path went through them.

The kernels build at first use with ``nvcc`` into ``_build/`` beside
this package, keyed on a hash of the sources, and load with ctypes.
Query tables: boxes (K, 8) f32 and times (B, 4) i32 with unused slots
folded into impossible bounds (see ``zscan.make_query``).
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

import torch

__all__ = ["launches", "reset_launches", "scan_mask", "scan_mask_gather",
           "scan_count", "scan_mask_plain", "scan_mask_gather_plain",
           "scan_count_plain", "build_library", "BuildInfo",
           "MAX_TABLE_BYTES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_PKG, "csrc", "scan.cu")]
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the kernels stage both query tables in dynamic shared memory, which a
# launch may use up to 48 KB without opting in to more
MAX_TABLE_BYTES = 48 * 1024

launches = {"scan_mask": 0, "scan_mask_gather": 0, "scan_count": 0}


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
    """Compile csrc/scan.cu (once per source hash) and return where the
    shared library is. Raises on a failed build; there is no fallback."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in _SOURCES:
        with open(p, "rb") as f:
            h.update(f.read())
    path = os.path.join(_BUILD_DIR, f"libgeomesa_scan_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, *_SOURCES],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


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
            for fn in (lib.geomesa_scan_mask, lib.geomesa_scan_mask_gather,
                       lib.geomesa_scan_count):
                fn.restype = ctypes.c_int
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


def _check(cols, boxes, times):
    if len(cols) != 6:
        raise ValueError("cols are (xhi, xlo, yhi, ylo, tday, tms)")
    cap = cols[0].shape[0]
    for c, dt in zip(cols, _DTYPES):
        if c.dtype != dt or c.dim() != 1 or c.shape[0] != cap:
            raise ValueError(f"column must be 1-d {dt} of length {cap}")
        if not c.is_contiguous():
            raise ValueError("columns must be contiguous")
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
    cap = _check(cols, boxes, times)
    if not 0 <= n <= cap:
        raise ValueError(f"n={n} outside [0, {cap}]")
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
    cap = _check(cols, boxes, times)
    if not 0 <= n <= cap:
        raise ValueError(f"n={n} outside [0, {cap}]")
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
