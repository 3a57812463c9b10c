#!/usr/bin/env python
"""Time the port's scan kernels in several checkouts by one method.

    python3 kernel_ab.py [--seed 0] [--rows 100000000]
                         [--store-rows 10000000] TREE [TREE ...]

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
  kernel's loads, no query tables, and one byte out per id.

Medians of 20 launches (CUDA events). Every gathered result is checked
against its plain version. Prints one JSON line per tree, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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


def worker(tree: str, seed: int, rows: int, store_rows: int) -> dict:
    sys.path.insert(0, tree)
    import torch
    from geomesa_tpu_torch.index.zkeys import ZKeyIndex, search_rows
    from geomesa_tpu_torch.scan import kernels, zscan
    if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {kernels.__file__}, not from {tree}")
    dev = torch.device("cuda")
    kernels.build_library()
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
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.rows,
                                args.store_rows)), flush=True)
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
             str(args.rows), "--store-rows", str(args.store_rows)],
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
