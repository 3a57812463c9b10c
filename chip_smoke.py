#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--store-rows 10000000]

Phases, one JSON line each; any failure exits non-zero:

1. build   the CUDA scan kernels from geomesa_tpu_torch/csrc/scan.cu
           (nvcc, sm_90a), with the card's name and power limit.
2. kernels each hand kernel against its plain PyTorch version on the
           same device tensors: 100M rows from --seed, in a capacity
           of 2^27 (so rows n..cap are capacity padding), the four
           reference queries, and a gathered case of 1M random int32
           row ids, in their random order and sorted, and 1M random
           ids within the first 2^20 rows (a 32 MB slice of the table that the L2 cache holds).
           Tolerance: exact (torch.equal / ==). Median kernel and plain
           times (CUDA events, the card held busy while each launch is
           enqueued), and the bound: useful bytes / 3.35 TB/s. The
           gathered kernel is timed with the L2 cache flushed before
           each launch (its 1M rows would otherwise stay in the 50 MB
           L2 between launches), beside its warm time and the sector
           floor (32 B per random row).
3. store   the main path: InMemoryDataStore() on CUDA, 10M rows written
           in chunks through write_dict (in-place appends and one
           capacity rebuild), the BBOX+time north-star query and two
           more through the gathered and the dense tiers, ids and
           query_count checked against a float64 numpy brute force;
           the scan layer's count entry point on the store's columns.
           Launch counts are zeroed before this phase and read after;
           each kernel must have launched. Then, outside the counted
           run, the gathered kernel at the main path's own shape: the
           north-star query's candidate ids from the store's z-index.

Then the kernels summary line, the card line, and the final
{"ok": true, ...} line. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MS_DAY = 86_400_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SECTOR_BYTES = 32              # least device-memory traffic of a random row
L2_FLUSH_BYTES = 256 << 20     # written between cold launches (L2: 50 MB)
HOLD_CYCLES = 200_000          # ~0.1 ms of GPU spin ahead of each timed launch
INT32_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate
T0_DAY, T1_DAY = 17_000, 17_100   # the store's dates: 2016-07-18 .. +100 days

KERNEL_QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),
]

STORE_QUERIES = [
    ("BBOX(geom, -80, 30, -60, 45) AND "
     "dtg DURING 2016-08-07T00:00:00Z/2016-09-06T00:00:00Z",
     [(-80, 30, -60, 45)], (17_020 * MS_DAY, 17_050 * MS_DAY)),
    ("(BBOX(geom, -10, -10, 10, 10) OR BBOX(geom, 100, -50, 140, -10)) AND "
     "dtg DURING 2016-07-20T00:00:00Z/2016-10-01T00:00:00Z",
     [(-10, -10, 10, 10), (100, -50, 140, -10)],
     (17_002 * MS_DAY, 17_075 * MS_DAY)),
    ("BBOX(geom, -120, 20, -70, 50)", [(-120, 20, -70, 50)], None),
]

SOURCES = {
    "scan_mask": "geomesa_tpu/scan/pallas_scan.py:140 _mask_call",
    "scan_mask_gather": "geomesa_tpu/scan/zscan.py:304 _gather_scan_mask",
    "scan_count": "geomesa_tpu/scan/pallas_scan.py:162 _count_call",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, flush=None) -> float:
    """Median milliseconds of fn() on the card (CUDA events); ``flush``
    runs before each timed launch, outside the events. A spin kernel
    holds the card ahead of the first event while the host enqueues
    fn(), so the events time the device's work and not the host's
    launch latency (which exceeds a short kernel's own time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _ops_per_row(k: int, b: int, time_any: bool) -> int:
    # per box 4 two-float compares of ~3 operations, plus the reductions;
    # per interval 2 (day, ms) compares of ~3 operations
    return 13 * k + (0 if time_any else 7 * b)


def _l2_flush(dev):
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


def _err(got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
               .item()) if got.numel() else 0


def gather_timing(rows, idx, b, t, time_any, flush) -> dict:
    """The gathered kernel on ``idx`` against its plain version: cold
    (L2 flushed) and warm medians of 20 launches, the useful-byte bound
    and the sector floor. Launches here are outside any counted run."""
    from geomesa_tpu_torch.scan import kernels
    m = idx.shape[0]
    col_bytes = 16 if time_any else 24
    table_bytes = b.numel() * 4 + t.numel() * 4
    want = kernels.scan_mask_gather_plain(rows, idx, b, t, time_any)

    def kern():
        return kernels.scan_mask_gather(rows, idx, b, t, time_any)
    out = {"m": m, "max_abs_err": _err(kern(), want),
           "ms": cuda_ms(kern, 20, flush=flush), "warm_ms": cuda_ms(kern, 20)}
    out["plain_ms"] = cuda_ms(
        lambda: kernels.scan_mask_gather_plain(rows, idx, b, t, time_any), 3,
        warmup=1)
    out["bound_ms"], out["bound_by"] = bound_ms(
        (4 + col_bytes + 1) * m + table_bytes,
        _ops_per_row(b.shape[0], t.shape[0], time_any) * m)
    out["sector_floor_ms"] = ((SECTOR_BYTES + 4 + 1) * m
                              / HBM_BYTES_PER_S * 1e3)
    out["hits"] = int(want.sum().item())
    return out


def phase_build():
    from geomesa_tpu_torch.scan import kernels
    info = kernels.build_library()
    print(info.log, file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": info.seconds, "library": info.path,
          "card": card_line(), "device": torch.cuda.get_device_name(0)})


def phase_kernels(seed: int, rows: int) -> dict:
    from geomesa_tpu_torch.scan import kernels, zscan
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    cap = zscan.next_pow2(rows)
    t0 = time.perf_counter()
    data = zscan.build_scan_data(x, y, ms, dev, cap=cap)
    del x, y, ms
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n = data.n
    idx = torch.randint(0, n, (1_000_000,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(seed))
    idx_sorted = torch.sort(idx).values
    idx_l2 = torch.randint(0, 1 << 20, idx.shape, device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(dev).manual_seed(seed))
    m = idx.shape[0]
    flush = _l2_flush(dev)
    stats = {k: {"max_abs_err": 0, "per_query": []} for k in SOURCES}
    for qi, (boxes, intervals) in enumerate(KERNEL_QUERIES):
        q = zscan.make_query(boxes, intervals)
        b, t = q.tables(dev)
        k, nb, ta = b.shape[0], t.shape[0], q.time_any
        col_bytes = 16 if ta else 24
        table_bytes = b.numel() * 4 + t.numel() * 4
        ops = _ops_per_row(k, nb, ta)
        cases = {
            "scan_mask": (
                lambda: kernels.scan_mask(data.cols, n, b, t, ta),
                lambda: kernels.scan_mask_plain(data.cols, n, b, t, ta),
                col_bytes * n + cap + table_bytes, ops * n),
            "scan_count": (
                lambda: kernels.scan_count(data.cols, n, b, t, ta),
                lambda: kernels.scan_count_plain(data.cols, n, b, t, ta),
                col_bytes * n + 4 + table_bytes, ops * n),
        }
        for name, (kern, plain, nbytes, nops) in cases.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            err = _err(got, want)
            if name == "scan_mask" and bool(got[n:].any()):
                err = max(err, 1)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            bms, bby = bound_ms(nbytes, nops)
            stats[name]["per_query"].append({
                "query": qi, "ms": cuda_ms(kern, 20), "plain_ms":
                cuda_ms(plain, 3, warmup=1), "bound_ms": bms, "bound_by": bby,
                "hits": int(want.sum().item()), "equal": err == 0})
        # the gathered kernel: random ids, the same ids sorted, and ids
        # the L2 cache can hold
        g = gather_timing(data.rows, idx, b, t, ta, flush)
        g["sorted"] = gather_timing(data.rows, idx_sorted, b, t, ta, flush)
        g["l2_window"] = gather_timing(data.rows, idx_l2, b, t, ta, flush)
        err = max(d["max_abs_err"] for d in (g, g["sorted"], g["l2_window"]))
        g.update(query=qi, equal=err == 0)
        s = stats["scan_mask_gather"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["per_query"].append(g)
    emit({"phase": "kernels", "rows": n, "cap": cap, "gathered_rows": m,
          "upload_s": upload_s, "scan_data_bytes": data.nbytes,
          "kernels": stats})
    bad = [k for k, s in stats.items() if s["max_abs_err"] != 0]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    del data, idx, idx_sorted, idx_l2, flush
    torch.cuda.empty_cache()
    return stats


def _brute(x, y, ms, boxes, iv):
    hit = np.zeros(len(x), dtype=bool)
    for x0, y0, x1, y1 in boxes:
        hit |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if iv is not None:   # DURING: exclusive bounds
        hit &= (ms > iv[0]) & (ms < iv[1])
    return np.flatnonzero(hit)


def phase_store(seed: int, rows: int, gather_stats: dict) -> dict:
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.index.zkeys import search_rows
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    threshold = SystemProperty("geomesa.scan.index.threshold")
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows)
    ids = np.arange(rows).astype(str).astype(object)
    # chunks: a first build at 60%, two in-place appends, one rebuild
    cuts = [0, int(rows * 0.6), int(rows * 0.7), int(rows * 0.8), rows]

    kernels.reset_launches()
    t_main = time.perf_counter()
    ds = InMemoryDataStore()
    ds.create_schema("ais", "dtg:Date,*geom:Point:srid=4326")
    st = ds._types["ais"]
    write_s, appends = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        t0 = time.perf_counter()
        ds.write_dict("ais", ids[lo:hi], {"dtg": ms[lo:hi],
                                          "geom": (x[lo:hi], y[lo:hi])})
        col = st.scan_data.xhi if st.scan_data is not None else None
        ds.query(STORE_QUERIES[0][0], "ais")   # flush + index
        write_s.append(time.perf_counter() - t0)
        appends.append("in_place" if st.scan_data.xhi is col else "build")
    tiers = {}
    for tier, (h, thr) in {"gathered": ("0", "1.0"),
                           "dense": ("0", "0")}.items():
        host_rows.set(h)
        threshold.set(thr)
        per_q = []
        for ecql, boxes, iv in STORE_QUERIES:
            want = _brute(x, y, ms, boxes, iv)
            res = ds.query(ecql, "ais")
            line = ("Index-pruned device scan" if tier == "gathered"
                    else "Device scan:")
            if line not in res.explain.text:
                raise SystemExit(f"{tier} tier did not run for {ecql!r}")
            ok = (np.array_equal(res.rows, want)
                  and np.array_equal(res.ids, ids[want])
                  and ds.query_count(ecql, "ais") == len(want))
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                ds.query(ecql, "ais")
                times.append((time.perf_counter() - t0) * 1e3)
            per_q.append({"query": ecql, "hits": len(want), "exact": ok,
                          "p50_ms": statistics.median(times)})
            if not ok:
                raise SystemExit(f"{tier} tier wrong for {ecql!r}")
        tiers[tier] = per_q
    host_rows.set(None)
    threshold.set(None)
    # the scan layer's count entry point on the store's own columns
    # the north-star query's DURING as the store's inclusive interval
    north_iv = [(17_020 * MS_DAY + 1, 17_050 * MS_DAY - 1)]
    sq = zscan.make_query(STORE_QUERIES[0][1], north_iv)
    count = zscan.scan_count(st.scan_data, sq)
    mask_sum = int(zscan.scan_mask(st.scan_data, sq).sum().item())
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = dict(kernels.launches)
    # the gathered kernel at the main path's shape: the north-star
    # query's candidates as the gathered tier gets them (host cap 0,
    # block cap n), in the index's z-order
    kind, cand = search_rows(st.zindex, "z3", STORE_QUERIES[0][1], north_iv,
                             0, st.n)
    if kind != "candidates":
        raise SystemExit(f"the z-index gave {kind!r}, not candidates")
    b, t = sq.tables(st.device)
    main_gather = gather_timing(st.scan_data.rows,
                                torch.from_numpy(cand).to(st.device), b, t,
                                sq.time_any, _l2_flush(st.device))
    gather_stats["max_abs_err"] = max(gather_stats["max_abs_err"],
                                      main_gather["max_abs_err"])
    emit({"phase": "store", "rows": rows, "cap": st.scan_data.cap,
          "scan_data_bytes": st.scan_data.nbytes,
          "write_s": write_s, "appends": appends, "tiers": tiers,
          "scan_count": count, "scan_mask_sum": mask_sum,
          "launches": counts, "seconds": main_s,
          "main_path_gather": main_gather})
    if main_gather["max_abs_err"] != 0:
        raise SystemExit("scan_mask_gather disagrees with its plain version "
                         "at the main path's shape")
    if count != mask_sum:
        raise SystemExit("scan_count disagrees with the mask on the store")
    if appends[0] != "build" or "in_place" not in appends:
        raise SystemExit(f"no in-place append among the writes: {appends}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_build()
    stats = phase_kernels(args.seed, args.rows)
    launches = phase_store(args.seed, args.store_rows,
                           stats["scan_mask_gather"])
    summary = []
    for name, s in stats.items():
        q0 = s["per_query"][0]   # the BBOX+time query (1M random ids
                                 # for the gathered kernel, L2 cold)
        summary.append({
            "name": name, "route": "cuda",
            "source": "geomesa_tpu_torch/csrc/scan.cu",
            "replaces": SOURCES[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": q0["ms"],
            "plain_ms": q0["plain_ms"], "bound_ms": q0["bound_ms"],
            "bound_by": q0["bound_by"], "library_ms": None})
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
