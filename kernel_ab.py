#!/usr/bin/env python
"""Time the port's kernels in several checkouts by one method.

    python3 kernel_ab.py [--seed 0] [--rows 100000000]
                         [--store-rows 10000000] [--predicates-only]
                         [--density-only] [--store-only] TREE [TREE ...]

Each TREE is the root of a checkout of the repo (a ``git archive`` of a
commit unpacked into a git-ignored directory will do). The trees run
one after another on one card, each in a process of its own that
imports that tree's ``geomesa_tpu_torch``, so ``old new new old``
compares two versions within one call. Each process:

- builds the kernels from its tree's ``csrc/scan.cu``;
- makes chip_smoke.py's kernels-phase data (--rows rows from --seed in
  a power-of-two capacity) and its BBOX+time query;
- times ``scan_mask``, ``scan_count`` and ``scan_mask_gather`` (1M
  random row ids from --seed) by two methods: "held", as chip_smoke.py
  times (a spin kernel holds the card while the host enqueues the timed
  launch, so the events time the device alone), and "bare" (events
  around the call on an idle card, which also catch the host's
  enqueue); the gathered kernel also "cold", held with the L2 cache
  flushed before each launch;
- times the gathered kernel the same ways at the main path's shape: the
  north-star query's candidate ids from a z-index over chip_smoke.py's
  store-phase data (--store-rows rows from --seed + 1);
- where the tree has the row-major gather table (``ScanData.rows``),
  times beside it a read of the same rows with no predicate: a probe
  kernel built by this script from PROBE_SOURCE, with the gathered
  kernel's loads, no query tables, and one byte out per id;
- where the tree has the batched kernels, times them held at two
  shapes: the kernels-phase rows with chip_smoke.py's kernels-phase
  batch of 32 queries, and the store-phase rows with its batched-phase
  batch of 32 (``batched_100m``, ``batched_10m``): ``scan_batch_bits``
  (over each query's own slots where the tree's ``stack_queries``
  counts them), ``compact_bits`` through its wrapper and its
  compaction kernel alone, each batch built by the tree's own
  ``stack_queries`` and checked against the plain versions; where the
  tree has the prefix kernel, it on the batch's partials cut into 1x,
  4x and 16x as many (kind, query) rows, beside one ``torch.cumsum``,
  and a probe of the compaction built from PROBE_SOURCE, cut short
  after its loads and before its id stores;
- where the tree has the predicate kernels (``scan/gscan.py``,
  ``scan/residual.py``), times them held at chip_smoke.py's predicates
  phase's shapes (``predicates_10m``): ``pip_mask`` on the rows of its
  polygon query's envelope and DURING (the point-in-polygon candidates)
  against the 340 edges of its polygon, each tree packing the polygon
  with its own ``pack_polygon``; and the residual kernel alone (a
  pointer table built once) and through its wrapper on the phase's
  fullscan attribute filter and its dense secondary with band rows, each
  program compiled by the tree's own ``compile_program`` over its own
  ``DeviceColumns`` of the phase's store data (--store-rows rows from
  chip_smoke.py's ``predicate_data``). Every result is checked against
  the tree's plain version. A tree whose wrapper takes the program on
  the host is timed alone through its ``residual_launcher`` (the launch
  prepared once); an earlier tree's with its pointer table built once.
  Both it and the wrapper are timed held and on an idle card ("bare",
  the host's work included), and a wrapper that keeps prepared launches
  also cold (its cache cleared before each call).
  ``--predicates-only`` times these and nothing else.
- where the tree has the density kernel (``kernels.density_grid``),
  times it held at chip_smoke.py's surface phase's shapes
  (``density_10m``): the rows of its 73-day world query from the
  predicates phase's data, weighted by NumMentions on the 2048x1024
  grid, the same rows in one cell (a 1x1 grid), and the rows of its
  30-day tile unweighted on the 256x256 grid; the inputs made by the
  tree's own ``density_upload`` and ``density_scalars``, each result
  checked against the tree's plain version (unit weights equal,
  weighted within 2 * n_cell * 2^-24 * sum |w| a cell).
  ``--density-only`` times these and nothing else.
- ``--store-only`` times nothing of the above: the tree's store on
  chip_smoke.py's store phase (this checkout's ``phase_store``: the
  same 10M rows and chunked writes), then each of its queries in the
  gathered and the dense tier STORE_RUNS more times, host clock until
  the ids are on the host (``store_10m``: p50 and quartiles in ms); and
  the dense north-star query in parts (the scan kernel with the mask's
  copy to the host, the f64 patch; medians) and in a cProfile of five
  calls.

Medians of 20 launches (CUDA events; 10 for the batched kernels). Every
gathered and batched result is checked against its plain version.
Prints one JSON line per tree, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MS_DAY = 86_400_000
HOLD_CYCLES = 200_000          # ~0.1 ms of GPU spin ahead of each timed launch
L2_FLUSH_BYTES = 256 << 20     # written between cold launches (L2: 50 MB)
GATHERED_IDS = 1_000_000
QUERY = ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)])
NORTH_BOXES = [(-80, 30, -60, 45)]
NORTH_IV = [(17_020 * MS_DAY + 1, 17_050 * MS_DAY - 1)]
T0_DAY, T1_DAY = 17_000, 17_100

# The gathered kernel's loads and nothing else: two threads per 4 ids,
# thread h reads 16-byte half h of each of its 4 rows of the (cap, 8)
# int32 table; the pair folds its words to one byte per id.
PROBE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void read_rows(const int4* __restrict__ rows,
                          const int32_t* __restrict__ idx, int64_t m,
                          uint8_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t j0 = (t / 2) * 4;
  const uint32_t h = threadIdx.x & 1u;
  uint32_t bits = 0;
  if (j0 < m) {
    uint32_t id[4];
    if (j0 + 4 <= m) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(idx + j0));
      id[0] = w.x; id[1] = w.y; id[2] = w.z; id[3] = w.w;
    } else {
      for (int r = 0; r < 4; ++r) id[r] = __ldg(idx + (j0 + r < m ? j0 + r : j0));
    }
    int4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = __ldg(rows + 2u * id[r] + h);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      bits |= static_cast<uint32_t>((a[r].x ^ a[r].y ^ a[r].z ^ a[r].w) & 1)
              << (8 * r);
  }
  bits ^= __shfl_xor_sync(0xffffffffu, bits, 1);
  if (h == 0 && j0 < m) {
    for (int r = 0; r < 4 && j0 + r < m; ++r) out[j0 + r] = (bits >> (8 * r)) & 1u;
  }
}

extern "C" int probe_read_rows(const int32_t* rows, const int32_t* idx,
                               int64_t m, uint8_t* out, void* stream) {
  const int64_t blocks = ((m + 3) / 4 * 2 + 255) / 256;
  read_rows<<<static_cast<int>(blocks), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(rows), idx, m, out);
  return static_cast<int>(cudaGetLastError());
}

// csrc/batch.cu's compaction with its grid, its walk over the pairs and
// its loads, cut short: mode 0 stops after each non-empty pair's loads
// (its 64 words and its offset), mode 1 also sums the query bases, scans
// the popcounts and forms every id, but writes no id. Each thread writes
// one word (an XOR of what it read or formed) so nothing is dropped.
__global__ void compact_probe(const uint32_t* __restrict__ bits,
                              const int32_t* __restrict__ partials,
                              const int32_t* __restrict__ offsets,
                              const int64_t* __restrict__ totals, int qp,
                              int64_t nb, int64_t words, int mode,
                              uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t warp = gt >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  int64_t row = -1;
  long long base = 0;
  uint32_t acc = 0;
  for (int64_t p0 = warp * 32; p0 < pairs; p0 += warps * 32) {
    const int64_t p = p0 + lane;
    const int32_t cnt = p < pairs ? partials[p] : 0;
    uint32_t todo = __ballot_sync(0xffffffffu, cnt != 0);
    const int64_t r0 = p0 / nb;
    while (todo) {
      const int64_t pp = p0 + (__ffs(todo) - 1);
      todo &= todo - 1;
      int64_t r = r0, j = pp - r0 * nb;
      while (j >= nb) {
        ++r;
        j -= nb;
      }
      const int64_t w0 = j * 64 + 2 * lane;
      const uint32_t* src = bits + r * words;
      const uint32_t a0 = w0 < words ? src[w0] : 0u;
      const uint32_t a1 = w0 + 1 < words ? src[w0 + 1] : 0u;
      const int32_t off = offsets[pp];
      if (mode == 0) {
        acc ^= a0 ^ a1 ^ static_cast<uint32_t>(off);
        continue;
      }
      const int kind = r >= qp;
      if (r != row) {
        row = r;
        long long s = 0;
        for (int64_t q = lane; q < r - kind * qp; q += 32)
          s += totals[kind * static_cast<int64_t>(qp) + q];
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        base = s;
      }
      const int mine = __popc(a0) + __popc(a1);
      int incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      long long k = base + off + incl - mine;
      const int32_t r0w = static_cast<int32_t>(w0 * 32);
      for (uint32_t m = a0; m; m &= m - 1)
        acc ^= static_cast<uint32_t>(r0w + __ffs(m) - 1 + k++);
      for (uint32_t m = a1; m; m &= m - 1)
        acc ^= static_cast<uint32_t>(r0w + 32 + __ffs(m) - 1 + k++);
    }
  }
  sink[gt] = acc;
}

extern "C" int probe_compact(const uint32_t* bits, const int32_t* partials,
                             const int32_t* offsets, const int64_t* totals,
                             int qp, int64_t nb, int64_t words, int mode,
                             uint32_t* sink, int64_t sink_len, void* stream) {
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  int64_t blocks = ((pairs + 31) / 32 + 7) / 8;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks * 256 > sink_len) return static_cast<int>(cudaErrorInvalidValue);
  compact_probe<<<static_cast<int>(blocks), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      bits, partials, offsets, totals, qp, nb, words, mode, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build_probe():
    build = os.path.join(ROOT, "geomesa_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "kernel_ab_probe.cu")
    lib = os.path.join(build, "kernel_ab_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    p = ctypes.c_void_p
    dll.probe_read_rows.argtypes = [p, p, ctypes.c_int64, p, p]
    dll.probe_read_rows.restype = ctypes.c_int
    i64 = ctypes.c_int64
    dll.probe_compact.argtypes = [p, p, p, p, ctypes.c_int, i64, i64,
                                  ctypes.c_int, p, i64, p]
    dll.probe_compact.restype = ctypes.c_int
    return dll


def cuda_ms(fn, held: bool, flush=None, iters: int = 20) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        if held:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def three_ways(fn, flush) -> dict:
    return {"cold": cuda_ms(fn, True, flush), "held": cuda_ms(fn, True),
            "bare": cuda_ms(fn, False)}


def _smoke():
    """This checkout's chip_smoke.py, for its query batches."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batched_case(kernels, data, bq, tree: str, probe) -> dict:
    """The tree's batched kernels on batch ``bq``, held: the bitmap
    kernel, the compaction through its wrapper and its kernel alone, and
    (int32 offsets) the compaction probe's two cut-short modes."""
    import torch
    b, t = bq.tables(data.device)
    extra = (bq.counts(data.device),) if hasattr(bq, "counts") else ()

    def bits_k():
        return kernels.scan_batch_bits(data.cols, data.n, b, t, *extra)
    bits, parts = bits_k()
    want = kernels.scan_batch_bits_plain(data.cols, data.n, b, t, *extra)
    if not (torch.equal(bits, want[0]) and torch.equal(parts, want[1])):
        raise SystemExit(f"{tree}: scan_batch_bits != plain")
    del want
    got = kernels.compact_bits(bits, parts)
    want = kernels.compact_bits_plain(bits, parts)
    if not (np.array_equal(got[2], want[2])
            and all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))):
        raise SystemExit(f"{tree}: compact_bits != plain")
    qp, words, nb = bits.shape[1], bits.shape[2], parts.shape[2]
    outs = [torch.empty_like(ids) for ids in got[:2]]
    lib = kernels._library()
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(kernels, "compact_prefix"):
        plan = kernels.compact_prefix(parts)
    else:   # an older wrapper: int64 offsets from torch.cumsum
        plan = kernels._compact_plan(parts)[:1]
    ptrs = [x.data_ptr() for x in plan]

    def comp_kernel():
        rc = lib.geomesa_compact_bits(
            bits.data_ptr(), parts.data_ptr(), *ptrs, qp, nb, words,
            outs[0].data_ptr(), outs[1].data_ptr(), stream)
        if rc:
            raise RuntimeError(f"compact_bits launch failed: cudaError {rc}")
    comp_kernel()
    if not all(torch.equal(o, g) for o, g in zip(outs, got[:2])):
        raise SystemExit(f"{tree}: compaction kernel alone != plain")
    out = {"queries": qp, "own_slots": bool(extra),
           "ids": int(sum(len(g) for g in got[:2])),
           "scan_batch_bits_ms": cuda_ms(bits_k, True, iters=10),
           "compact_bits_ms": cuda_ms(
               lambda: kernels.compact_bits(bits, parts), True, iters=10),
           "compact_kernel_ms": cuda_ms(comp_kernel, True, iters=10)}
    if hasattr(kernels, "compact_prefix"):
        # the prefix kernel runs one block per (kind, query) row: the
        # same partials as 1x, 4x and 16x as many shorter rows, and one
        # torch.cumsum of them
        out["compact_prefix_ms_by_rows"] = {
            str(2 * qp * m): cuda_ms(
                lambda m=m: kernels.compact_prefix(
                    parts.view(2, qp * m, nb // m)), True, iters=10)
            for m in (1, 4, 16) if nb % m == 0}
        out["cumsum_ms"] = cuda_ms(
            lambda: torch.cumsum(parts, dim=2, dtype=torch.int64), True,
            iters=10)
        sink = torch.empty(132 * 16 * 256, dtype=torch.int32,
                           device=bits.device)
        for mode, name in ((0, "probe_loads_ms"), (1, "probe_no_stores_ms")):
            def cut(mode=mode):
                rc = probe.probe_compact(
                    bits.data_ptr(), parts.data_ptr(), *ptrs, qp, nb, words,
                    mode, sink.data_ptr(), sink.numel(), stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            out[name] = cuda_ms(cut, True, iters=10)
    return out


def predicate_case(smoke, seed: int, rows: int) -> dict:
    """The tree's predicate kernels at chip_smoke.py's predicates-phase
    shapes, held, each checked against the tree's plain version."""
    import torch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.geometry import parse_wkt
    from geomesa_tpu_torch.scan import gscan, kernels, residual
    dev = torch.device("cuda")
    d = smoke.predicate_data(seed, rows)
    lo, hi = smoke.PRED_DURING
    sel = (smoke._in_box(d["x"], d["y"], smoke._env(smoke.PRED_SHELL))
           & (d["ms"] > lo * MS_DAY) & (d["ms"] < hi * MS_DAY))
    px, py = (torch.from_numpy(a).to(dev)
              for a in gscan.pip_points(d["x"][sel], d["y"][sel]))
    edges = gscan.pack_polygon(parse_wkt(smoke.PRED_POLYGON), dev).edges

    def pip():
        return kernels.pip_mask(px, py, edges, gscan.EDGE_EPS2)
    got, want = pip(), kernels.pip_mask_plain(px, py, edges, gscan.EDGE_EPS2)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("pip_mask != plain")
    out = {"pip_points": int(px.shape[0]), "pip_edges": int(edges.shape[0]),
           "pip_mask_ms": cuda_ms(pip, True, iters=10)}
    batch = smoke.predicate_batch(parse_spec("gdelt", smoke.PRED_SPEC), d,
                                  np.arange(rows).astype(object))
    cols = residual.DeviceColumns(batch, dev)
    lib = kernels._library()
    stream = torch.cuda.current_stream().cuda_stream
    host_program = hasattr(kernels, "residual_launcher")
    for name, ecql in (("attributes", smoke.PRED_ATTR_FILTER),
                       ("band", smoke.PRED_BAND_FILTER)):
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        # the program on the host (this tree's wrapper), or on the device
        # (the earlier wrapper, which uploads a pointer table per call)
        code, consts, table = (
            torch.from_numpy(a).to("cpu" if host_program else dev)
            for a in (prog.code, prog.consts, prog.table))
        slots = [cols.get(c)["slot"] for c in prog.slots]
        res = kernels.residual_mask(code, consts, table, slots, rows)
        if not torch.equal(res, kernels.residual_mask_plain(
                code, consts, table, slots, rows)):
            raise SystemExit(f"residual_mask != plain ({name})")
        if host_program:
            alone = functools.partial(kernels.residual_launcher(
                code, consts, table, slots, dev), rows, res)
        else:
            ptrs = kernels.slot_table(slots, dev)

            def alone(code=code, consts=consts, table=table, ptrs=ptrs):
                rc = lib.geomesa_residual_mask(
                    code.data_ptr(), code.shape[0], consts.data_ptr(),
                    table.data_ptr(), ptrs.data_ptr(), rows, res.data_ptr(),
                    stream)
                if rc:
                    raise RuntimeError(f"residual launch failed: "
                                       f"cudaError {rc}")

        def wrapper(code=code, consts=consts, table=table, slots=slots):
            kernels.residual_mask(code, consts, table, slots, rows)
        case = out[f"residual_{name}"] = {
            "instructions": int(code.shape[0]), "slots": len(slots),
            "kernel_ms": cuda_ms(alone, True, iters=10),
            "wrapper_ms": cuda_ms(wrapper, True, iters=10),
            "kernel_bare_ms": cuda_ms(alone, False, iters=10),
            "wrapper_bare_ms": cuda_ms(wrapper, False, iters=10)}
        cache = getattr(kernels, "_residual_launches", None)
        if cache is not None:
            # the launch prepared anew each call, as on a new filter or
            # after a flush
            case["wrapper_cold_ms"] = cuda_ms(wrapper, False, cache.clear,
                                              iters=10)
    return out


def density_case(smoke, seed: int, rows: int) -> dict:
    """The tree's density kernel at chip_smoke.py's surface-phase
    shapes, held, each checked against the tree's plain version."""
    import torch
    from geomesa_tpu_torch.scan import aggregations, kernels
    dev = torch.device("cuda")
    d = smoke.predicate_data(seed, rows)
    ms = d["ms"]
    world = ((ms > smoke.SURFACE_WORLD_DAYS[0] * MS_DAY)
             & (ms < smoke.SURFACE_WORLD_DAYS[1] * MS_DAY))
    tile = (smoke._in_box(d["x"], d["y"], smoke.SURFACE_TILE)
            & (ms > smoke.SURFACE_TILE_DAYS[0] * MS_DAY)
            & (ms < smoke.SURFACE_TILE_DAYS[1] * MS_DAY))
    ment = np.where(d["mentions_valid"], d["mentions"], 0)
    out = {}
    for name, sel, bbox, w, h, wts in (
            ("world_2048x1024_NumMentions", world, smoke.WORLD, 2048, 1024,
             ment),
            ("world_1x1_NumMentions", world, smoke.WORLD, 1, 1, ment),
            ("tile_256", tile, smoke.SURFACE_TILE, 256, 256, None)):
        idx = np.flatnonzero(sel)
        mask = (d["mentions_valid"][idx] if wts is not None
                else np.ones(len(idx), bool))
        xt, yt, wt, mt = aggregations.density_upload(
            d["x"][idx], d["y"][idx], mask,
            None if wts is None else wts[idx], dev)
        args = (xt, yt, wt, mt, *aggregations.density_scalars(bbox, w, h),
                w, h)
        got = kernels.density_grid(*args)
        want = kernels.density_grid_plain(*args)
        diff = (got.double() - want.double()).abs().flatten()
        if wt is None:
            ok = torch.equal(got, want)
        else:
            cells = kernels.density_cells_plain(*args[:2], *args[4:])[mt]
            n_cell = torch.bincount(cells, minlength=w * h).double()
            abs_w = torch.bincount(cells, wt[mt].abs().double(),
                                   minlength=w * h)
            ok = bool((diff <= 2 * n_cell * 2.0**-24 * abs_w).all())
        if not ok:
            raise SystemExit(f"density_grid != plain ({name})")
        out[name] = {"rows": len(idx), "max_abs_err": float(diff.max()),
                     "ms": cuda_ms(lambda: kernels.density_grid(*args),
                                   True)}
    return out


STORE_RUNS = 21


def store_case(smoke, seed: int, rows: int) -> dict:
    """The tree's store on chip_smoke.py's store phase, each query of it
    timed STORE_RUNS times per tier (host clock, ids on the host)."""
    import time
    from geomesa_tpu_torch.utils.properties import SystemProperty
    _, ds, _ = smoke.phase_store(seed, rows, {"max_abs_err": 0})
    out = {}
    for tier, (h, thr) in {"gathered": ("0", "1.0"),
                           "dense": ("0", "0")}.items():
        SystemProperty("geomesa.scan.host.rows").set(h)
        SystemProperty("geomesa.scan.index.threshold").set(thr)
        for qi, (ecql, _b, _iv) in enumerate(smoke.STORE_QUERIES):
            times = []
            for _ in range(STORE_RUNS):
                t0 = time.perf_counter()
                ds.query(ecql, "ais").ids
                times.append((time.perf_counter() - t0) * 1e3)
            q1, q2, q3 = statistics.quantiles(times, n=4)
            out[f"{tier}_{qi}"] = {"p50_ms": q2, "q1_ms": q1, "q3_ms": q3}
    # the dense north-star query in parts: the scan kernel with the
    # mask's copy to the host, the f64 boundary patch, and a cProfile
    # of the whole query (top functions by own time)
    from geomesa_tpu_torch.scan import zscan
    st = ds._types["ais"]
    ecql, boxes, iv = smoke.STORE_QUERIES[0]
    sq = zscan.make_query(boxes, [(iv[0] + 1, iv[1] - 1)])

    def device():
        return zscan.scan_mask(st.scan_data, sq)[:st.n].cpu().numpy()

    def patch(mask):
        cand = zscan.boundary_candidates(st.host_xhi, st.host_yhi, sq)
        col = st.batch.col("geom")
        return zscan.exact_patch(mask, cand, col.x, col.y,
                                 st.batch.col("dtg").millis, sq)
    mask = device()
    parts = {"device_ms": [], "patch_ms": []}
    for _ in range(STORE_RUNS):
        t0 = time.perf_counter()
        mask = device()
        t1 = time.perf_counter()
        patch(mask)
        t2 = time.perf_counter()
        parts["device_ms"].append((t1 - t0) * 1e3)
        parts["patch_ms"].append((t2 - t1) * 1e3)
    out["dense_0_parts"] = {k: statistics.median(v) for k, v in parts.items()}
    out["dense_0_profile"] = smoke.profile_top(
        lambda: [ds.query(ecql, "ais").ids for _ in range(5)], top=10)
    return out


def worker(tree: str, seed: int, rows: int, store_rows: int,
           predicates_only: bool = False, density_only: bool = False,
           store_only: bool = False) -> dict:
    sys.path.insert(0, tree)
    import torch
    from geomesa_tpu_torch.index.zkeys import ZKeyIndex, search_rows
    from geomesa_tpu_torch.scan import kernels, zscan
    if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {kernels.__file__}, not from {tree}")
    dev = torch.device("cuda")
    kernels.build_library()
    if predicates_only:
        return {"tree": tree, "predicates_10m": predicate_case(
            _smoke(), seed, store_rows)}
    if store_only:
        return {"tree": tree, "store_10m": store_case(_smoke(), seed,
                                                      store_rows)}
    has_density = hasattr(kernels, "density_grid")
    if density_only:
        return {"tree": tree, "density_10m": density_case(
            _smoke(), seed, store_rows) if has_density else None}
    probe = build_probe()
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        buf.fill_(1)

    def gather_case(data, idx32):
        """The tree's gathered kernel (and the probe, where the tree has
        the row table) on these ids, checked against its plain version."""
        table = getattr(data, "rows", None)
        if table is not None:   # row table, int32 ids
            args = (table, idx32)
        else:                   # six columns, int64 ids
            args = (data.cols, idx32.long())

        def kern():
            return kernels.scan_mask_gather(*args, b, t, q.time_any)
        want = kernels.scan_mask_gather_plain(*args, b, t, q.time_any)
        if not torch.equal(kern(), want):
            raise SystemExit(f"{tree}: gathered kernel != plain")
        out = {"m": int(idx32.shape[0]), "kernel": three_ways(kern, flush)}
        if table is not None:
            res = torch.empty(idx32.shape[0], dtype=torch.uint8, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def read():
                rc = probe.probe_read_rows(table.data_ptr(), idx32.data_ptr(),
                                           idx32.shape[0], res.data_ptr(),
                                           stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            out["read_only"] = three_ways(read, flush)
        return out

    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    data = zscan.build_scan_data(x, y, ms, dev, cap=zscan.next_pow2(rows))
    del x, y, ms
    n = data.n
    q = zscan.make_query(*QUERY)
    b, t = q.tables(dev)
    res = {"tree": tree, "rows": n, "cap": data.cap}
    res["scan_mask"] = {
        k: cuda_ms(lambda: kernels.scan_mask(data.cols, n, b, t, False), h)
        for k, h in (("held", True), ("bare", False))}
    res["scan_count"] = {
        k: cuda_ms(lambda: kernels.scan_count(data.cols, n, b, t, False), h)
        for k, h in (("held", True), ("bare", False))}
    idx = torch.randint(0, n, (GATHERED_IDS,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(seed))
    res["gather_1m"] = gather_case(data, idx)
    smoke = _smoke()
    batched = hasattr(kernels, "scan_batch_bits")
    if batched:
        res["batched_100m"] = batched_case(kernels, data, zscan.stack_queries(
            [zscan.make_query(*q) for q in smoke.kernel_batch_specs(seed)]),
            tree, probe)
    del data, idx
    torch.cuda.empty_cache()

    # the main path's shape: the north-star query's candidates, as the
    # gathered tier gets them (host cap 0, block cap n), in z-order
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-180, 180, store_rows)
    y = rng.uniform(-90, 90, store_rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, store_rows)
    data = zscan.build_scan_data(x, y, ms, dev,
                                 cap=zscan.next_pow2(store_rows))
    kind, cand = search_rows(ZKeyIndex(x, y, ms), "z3", NORTH_BOXES,
                             NORTH_IV, 0, store_rows)
    if kind != "candidates":
        raise SystemExit(f"the z-index gave {kind!r}, not candidates")
    q = zscan.make_query(NORTH_BOXES, NORTH_IV)
    b, t = q.tables(dev)
    idx = torch.from_numpy(np.ascontiguousarray(cand, dtype=np.int32)).to(dev)
    res["gather_main_path"] = gather_case(data, idx)
    if batched:
        res["batched_10m"] = batched_case(
            kernels, data, smoke.store_batch(smoke.store_batch_specs(seed)),
            tree, probe)
    del data, idx
    torch.cuda.empty_cache()
    if os.path.exists(os.path.join(tree, "geomesa_tpu_torch", "scan",
                                   "residual.py")):
        res["predicates_10m"] = predicate_case(smoke, seed, store_rows)
    if has_density:
        res["density_10m"] = density_case(smoke, seed, store_rows)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    ap.add_argument("--predicates-only", action="store_true",
                    help="time only the predicate kernels (predicates_10m)")
    ap.add_argument("--density-only", action="store_true",
                    help="time only the density kernel (density_10m)")
    ap.add_argument("--store-only", action="store_true",
                    help="time only the store's queries (store_10m)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.rows,
                                args.store_rows, args.predicates_only,
                                args.density_only, args.store_only)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree), "--seed", str(args.seed), "--rows",
             str(args.rows), "--store-rows", str(args.store_rows),
             *(["--predicates-only"] if args.predicates_only else []),
             *(["--density-only"] if args.density_only else []),
             *(["--store-only"] if args.store_only else [])],
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["card"] = card
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
