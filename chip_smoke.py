#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--store-rows 10000000]

Phases, one JSON line each; any failure exits non-zero:

1. build   the CUDA kernels from geomesa_tpu_torch/csrc/scan.cu and
           csrc/batch.cu (one nvcc per source, started together, then
           one link; sm_90a), with the card's name and power limit.
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
           floor (32 B per random row). The batched kernels at the
           same 100M rows with a batch of 32 queries (the four reference
           queries, then seeded ones: boxes 1-40 degrees wide, a quarter
           time-free, an eighth with two boxes), each query over its own
           slots: bitmaps, partials, the prefix kernel's offsets and
           totals, and compacted ids held exactly against the plain
           versions; the compaction timed through its wrapper and alone,
           the prefix kernel beside one torch.cumsum of the partials.
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
4. batched the serving path on the store phase's 10M rows: 32 seeded
           queries in the store's dates through query_batched at batch
           sizes 2, 8 and 32, every query's ids equal to the float64
           brute force and to scalar query(), with the fused path shown
           by the explain text; p50 of one batched call beside the same
           queries as sequential query() calls. Then QueryBatcher(ds)
           with 32 threads each submitting 8 queries: all exact, with
           queries/s, the coalesce ratio and the batch count. Launch
           counts are zeroed before this phase and read after; the
           three batched kernels must have launched. Every stacked batch
           that the path ran (batch sizes and the batcher's) is recorded
           and, outside the counted run, the batched kernels are held
           exactly against their plain versions on it over the store's
           columns. Then where one call of 32 queries spends its time:
           the device path alone, the gather of the result ids, and a
           cProfile of the call (host clock); and the batched kernels
           timed at this phase's own shape beside their bounds
           (``kernels_32``).

Then the kernels summary line, the card line, and the final
{"ok": true, ...} line. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
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
    "scan_batch_bits": "geomesa_tpu/scan/zscan.py:536 _batch_mask_cand "
                       "(+ :558 _batch_count)",
    "compact_prefix": "geomesa_tpu/scan/zscan.py:563 _batch_nonzero "
                      "(its offsets; + :558 _batch_count's totals)",
    "compact_bits": "geomesa_tpu/scan/zscan.py:563 _batch_nonzero",
}
SOURCE_FILES = {k: "geomesa_tpu_torch/csrc/batch.cu"
                for k in ("scan_batch_bits", "compact_prefix", "compact_bits")}
BATCH = 32          # queries per batch in the kernels phase
STORE_BATCH_QUERIES = 32
BATCH_SIZES = (2, 8, 32)
BATCHER_THREADS, BATCHER_PER_THREAD = 32, 8


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


def random_queries(rng, count: int, lo_ms: int, hi_ms: int):
    """``count`` seeded (boxes, interval or None) queries: boxes 1-40
    degrees wide on a 0.001-degree grid, a quarter time-free, an eighth
    with two boxes; intervals of 1-40 days on whole seconds in
    [lo_ms, hi_ms)."""
    out = []
    for i in range(count):
        boxes = []
        for _ in range(2 if i % 8 == 7 else 1):
            w, h = (round(float(v), 3) for v in rng.uniform(1, 40, 2))
            x0 = round(float(rng.uniform(-180, 180 - w)), 3)
            y0 = round(float(rng.uniform(-90, 90 - h)), 3)
            boxes.append((x0, y0, round(x0 + w, 3), round(y0 + h, 3)))
        iv = None
        if i % 4 != 1:
            span = int(rng.integers(1, 41)) * MS_DAY
            lo = int(rng.integers(lo_ms // 1000, (hi_ms - span) // 1000)) * 1000
            iv = (lo, lo + span)
        out.append((boxes, iv))
    return out


def batch_stats(data, bq, plain: bool = True) -> dict:
    """The batched kernels on the batch ``bq`` over ``data``: each
    against its plain version (exact), timed held (medians of 10
    launches; the plain versions of 1 when ``plain``) beside its bound;
    ``compact_bits`` through its wrapper (prefix kernel, the totals'
    copy to the host, compaction kernel) and its kernel alone."""
    from geomesa_tpu_torch.scan import kernels
    b, t = bq.tables(data.device)
    c = bq.counts(data.device)
    n, qp, k, nb_ = data.n, bq.n_queries, b.shape[1], t.shape[1]
    words, nblocks = kernels.batch_shape(data.cap)

    def bits_k():
        return kernels.scan_batch_bits(data.cols, n, b, t, c)

    def bits_p():
        return kernels.scan_batch_bits_plain(data.cols, n, b, t, c)
    bits, parts = bits_k()
    torch.cuda.synchronize()
    want_bits, want_parts = bits_p()
    equal = torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
    del want_bits, want_parts

    def prefix_k():
        return kernels.compact_prefix(parts)

    def prefix_p():
        return kernels.compact_prefix_plain(parts)
    offsets, totals = prefix_k()
    prefix_equal = all(torch.equal(g, w) for g, w in zip((offsets, totals),
                                                         prefix_p()))

    def comp_k():
        return kernels.compact_bits(bits, parts)

    def comp_p():
        return kernels.compact_bits_plain(bits, parts)
    comp_equal = _compact_equal(comp_k(), comp_p())
    counts = totals.cpu().numpy()
    outs = [torch.empty(int(x), dtype=torch.int32, device=data.device)
            for x in counts.sum(axis=1)]
    lib = kernels._library()
    stream = torch.cuda.current_stream(data.device).cuda_stream

    def comp_kernel():   # the compaction kernel alone, outside the counts
        lib.geomesa_compact_bits(
            bits.data_ptr(), parts.data_ptr(), offsets.data_ptr(),
            totals.data_ptr(), qp, nblocks, words, outs[0].data_ptr(),
            outs[1].data_ptr(), stream)
    n_ids = int(counts.sum())
    table_bytes = b.numel() * 4 + t.numel() * 4
    bits_bytes = 24 * n + 2 * qp * words * 4 + 2 * qp * nblocks * 4 + table_bytes
    # per row and query: 13 operations per box of the predicate, 8 of the
    # candidate test, 7 per interval; counted over each query's own boxes
    # and intervals (the padded slots are no work the function needs),
    # and over the padded (Qp, K, B)
    ops = n * sum(21 * q.n_boxes + 7 * len(q.host_intervals)
                  for q in bq.queries)
    bits_bound = bound_ms(bits_bytes, ops)
    padded_bound = bound_ms(bits_bytes, n * qp * (13 * k + 7 * nb_ + 8 * k))
    nonempty = int((parts != 0).sum().item())
    # the bytes the compaction needs: every partial, the int32 offset
    # and the 64 words of each non-empty block, 4 B per id written
    comp_bound = bound_ms(
        2 * qp * nblocks * 4 + nonempty * (4 + 64 * 4) + 4 * n_ids,
        4 * n_ids)
    # the yardstick of the first compaction design, kept so that times
    # compare: partials read and int64 offsets for every block
    comp_bound_int64 = bound_ms(
        2 * qp * nblocks * (4 + 8) + nonempty * 64 * 4 + 4 * n_ids,
        4 * n_ids)
    prefix_bound = bound_ms(2 * qp * nblocks * (4 + 4) + 2 * qp * 8,
                            2 * qp * nblocks)

    def timed(kern, plain_fn):
        out = {"ms": cuda_ms(kern, 10)}
        if plain:
            out["plain_ms"] = cuda_ms(plain_fn, 1, 1)
        return out
    out = {
        "scan_batch_bits": {
            "max_abs_err": 0 if equal else 1, "queries": qp, "k": k, "b": nb_,
            **timed(bits_k, bits_p),
            "bound_ms": bits_bound[0], "bound_by": bits_bound[1],
            "padded_bound_ms": padded_bound[0],
            "hits": int(parts[0].sum().item()),
            "candidates": int(parts[1].sum().item())},
        "compact_prefix": {
            "max_abs_err": 0 if prefix_equal else 1, "rows": 2 * qp,
            "partials": 2 * qp * nblocks, **timed(prefix_k, prefix_p),
            # one PyTorch call for the same scan (inclusive, int64)
            "library_ms": cuda_ms(
                lambda: torch.cumsum(parts, dim=2, dtype=torch.int64), 10),
            "bound_ms": prefix_bound[0], "bound_by": prefix_bound[1]},
        "compact_bits": {
            "max_abs_err": 0 if comp_equal else 1, "ids": n_ids,
            "nonempty_blocks": nonempty, "blocks": 2 * qp * nblocks,
            **timed(comp_k, comp_p), "kernel_ms": cuda_ms(comp_kernel, 10),
            "bound_ms": comp_bound[0], "bound_by": comp_bound[1],
            "int64_offsets_bound_ms": comp_bound_int64[0]},
    }
    del bits, parts, offsets, totals, outs
    return out


def batch_kernel_stats(data, seed: int) -> dict:
    """The batched kernels at the kernels phase's rows with a batch of
    BATCH queries (the four reference queries, then seeded ones)."""
    from geomesa_tpu_torch.scan import zscan
    return batch_stats(data, zscan.stack_queries(
        [zscan.make_query(*q) for q in kernel_batch_specs(seed)]))


def kernel_batch_specs(seed: int) -> list:
    """The kernels phase's BATCH queries as (boxes, intervals)."""
    rng = np.random.default_rng(seed + 7)
    return list(KERNEL_QUERIES) + [
        (boxes, [iv] if iv else [])
        for boxes, iv in random_queries(rng, BATCH - len(KERNEL_QUERIES), 0,
                                        1000 * MS_DAY)]


def store_batch_specs(seed: int) -> list:
    """The batched phase's STORE_BATCH_QUERIES seeded queries in the
    store's dates as (boxes, DURING interval or None)."""
    rng = np.random.default_rng(seed + 2)
    return random_queries(rng, STORE_BATCH_QUERIES, T0_DAY * MS_DAY,
                          T1_DAY * MS_DAY)


def store_batch(specs):
    """``specs`` as the store stacks them: DURING's exclusive bounds as
    inclusive millis."""
    from geomesa_tpu_torch.scan import zscan
    return zscan.stack_queries([zscan.make_query(
        boxes, [(iv[0] + 1, iv[1] - 1)] if iv else [])
        for boxes, iv in specs])


def _compact_equal(got, want) -> bool:
    """compact_bits' (hit ids, candidate ids, counts) equal, exactly."""
    return (np.array_equal(got[2], want[2])
            and all(torch.equal(g, w) for g, w in zip(got[:2], want[:2])))


def check_batch(data, bq) -> bool:
    """The batched kernels against their plain versions on the batch
    ``bq`` over ``data``: bitmaps, partials, offsets, totals, ids and
    counts equal."""
    from geomesa_tpu_torch.scan import kernels
    b, t = bq.tables(data.device)
    c = bq.counts(data.device)
    bits, parts = kernels.scan_batch_bits(data.cols, data.n, b, t, c)
    torch.cuda.synchronize()
    want_bits, want_parts = kernels.scan_batch_bits_plain(data.cols, data.n,
                                                          b, t, c)
    return (torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
            and all(torch.equal(g, w) for g, w in zip(
                kernels.compact_prefix(parts),
                kernels.compact_prefix_plain(parts)))
            and _compact_equal(kernels.compact_bits(bits, parts),
                               kernels.compact_bits_plain(bits, parts)))


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
    for name, st in batch_kernel_stats(data, seed).items():
        stats[name] = {"max_abs_err": st["max_abs_err"], "per_query": [st]}
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


def phase_store(seed: int, rows: int, gather_stats: dict):
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
    missing = [k for k in ("scan_mask", "scan_mask_gather", "scan_count")
               if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")
    return counts, ds, (x, y, ms, ids)


def _ecql(boxes, iv) -> str:
    bb = " OR ".join(f"BBOX(geom, {x0!r}, {y0!r}, {x1!r}, {y1!r})"
                     for x0, y0, x1, y1 in boxes)
    if len(boxes) > 1:
        bb = f"({bb})"
    if iv is None:
        return bb
    lo, hi = (str(np.datetime64(v // 1000, "s")) + "Z" for v in iv)
    return f"{bb} AND dtg DURING {lo}/{hi}"


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_batched(seed: int, ds, rows) -> dict:
    """The micro-batched serving path on the store phase's rows."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan import kernels, zscan
    from geomesa_tpu_torch.scan.batcher import QueryBatcher
    x, y, ms, ids = rows
    specs = store_batch_specs(seed)
    ecqls = [_ecql(boxes, iv) for boxes, iv in specs]
    truth = [_brute(x, y, ms, boxes, iv) for boxes, iv in specs]
    scalar = [ds.query(e, "ais") for e in ecqls]   # also warms the planner
    for e, res, want in zip(ecqls, scalar, truth):
        if not np.array_equal(res.rows, want):
            raise SystemExit(f"scalar query() wrong for {e!r}")

    # every stacked batch that the store hands the device path while the
    # path is checked and while the batcher serves, to hold the kernels
    # against their plain versions at those shapes afterwards
    seen = []
    device_path = zscan.batch_hit_rows

    def recording(data, bq):
        seen.append(bq)
        return device_path(data, bq)

    kernels.reset_launches()
    t_main = time.perf_counter()
    zscan.batch_hit_rows = recording
    sizes = {}
    try:
        for size in BATCH_SIZES:
            chunks = [list(range(i, i + size))
                      for i in range(0, len(ecqls), size)]
            for chunk in chunks:
                res = ds.query_batched([Query("ais", ecqls[i])
                                        for i in chunk])
                for i, r in zip(chunk, res):
                    if not (np.array_equal(r.rows, truth[i])
                            and np.array_equal(r.ids, scalar[i].ids)):
                        raise SystemExit(f"query_batched wrong for "
                                         f"{ecqls[i]!r} at batch size {size}")
                    if "Fused device scan" not in r.explain.text:
                        raise SystemExit(f"{ecqls[i]!r} did not take the "
                                         f"fused path at batch size {size}")
            zscan.batch_hit_rows = device_path
            batched, seq = [], []
            for _ in range(3):
                for chunk in chunks:
                    qs = [Query("ais", ecqls[i]) for i in chunk]
                    batched.append(_timed(lambda: ds.query_batched(qs)))
                    seq.append(_timed(lambda: [ds.query(q) for q in qs]))
            sizes[size] = {"calls": len(batched),
                           "batched_p50_ms": statistics.median(batched),
                           "sequential_p50_ms": statistics.median(seq)}
            zscan.batch_hit_rows = recording
        batcher_runs = {"default": run_batcher(QueryBatcher(ds), ecqls,
                                               truth)}
    finally:
        zscan.batch_hit_rows = device_path
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = dict(kernels.launches)

    # outside the counted run: both kernels against their plain versions
    # on every batch the path ran, at its own (Q, K, B) over the store's
    # columns
    st = ds._types["ais"]
    data = st.scan_data
    shapes = sorted({(bq.n_queries, bq.boxes_np.shape[1], bq.times_np.shape[1])
                     for bq in seen})
    wrong = [bq.n_queries for bq in seen if not check_batch(data, bq)]
    checked = {"batches": len(seen), "shapes": shapes, "wrong": wrong}

    # the same callers with a static 200 ms linger
    batcher_runs["linger_200ms_static"] = run_batcher(
        QueryBatcher(ds, linger_us=200_000, adaptive=False), ecqls, truth)

    # where one call of 32 queries spends its time: the device path
    # alone (both kernels, the sync, the ids' copy to the host), the
    # gather of the result ids from the id column as query_batched does
    # it, and a cProfile of the call
    qs = [Query("ais", e) for e in ecqls]
    bq = store_batch(specs)
    res = ds.query_batched(qs)
    breakdown = {
        "call_ms": statistics.median(_timed(lambda: ds.query_batched(qs))
                                     for _ in range(5)),
        "batch_hit_rows_ms": statistics.median(
            _timed(lambda: zscan.batch_hit_rows(data, bq)) for _ in range(5)),
        "id_gather_ms": statistics.median(
            _timed(lambda: [st.batch.ids[r.rows] for r in res])
            for _ in range(5)),
        "ids": sum(r.n for r in res),
        "profile": profile_top(lambda: ds.query_batched(qs)),
    }
    # the batched kernels at this phase's own shape (the store's
    # columns, the 32-query batch), beside their bounds
    kernels_32 = batch_stats(data, bq, plain=False)
    emit({"phase": "batched", "rows": len(x), "queries": len(ecqls),
          "hits": [len(w) for w in truth], "sizes": sizes,
          "batcher": batcher_runs, "checked": checked,
          "breakdown_32": breakdown, "kernels_32": kernels_32,
          "launches": counts, "seconds": main_s})
    bad = [k for k, v in kernels_32.items() if v["max_abs_err"]]
    if wrong or not seen or bad:
        raise SystemExit(f"batched kernels disagree with their plain "
                         f"versions on the batched path: {checked} {bad}")
    bad = {k: r["errors"] for k, r in batcher_runs.items() if r["errors"]}
    if bad:
        raise SystemExit(f"QueryBatcher results wrong: {bad}")
    missing = [k for k in ("scan_batch_bits", "compact_prefix",
                           "compact_bits") if counts[k] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the batched path: "
                         f"{missing}")
    return counts


def profile_top(fn, top: int = 12) -> list:
    """cProfile of one fn() call: the ``top`` functions by own time,
    as [where, own ms, cumulative ms, calls]."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: kv[1][2], reverse=True)[:top]
    return [[f"{os.path.basename(f)}:{line}({name})", tt * 1e3, ct * 1e3, nc]
            for (f, line, name), (_cc, nc, tt, ct, _callers) in rows]


def run_batcher(batcher, ecqls, truth) -> dict:
    """BATCHER_THREADS callers each submitting BATCHER_PER_THREAD of the
    queries through ``batcher``; every result checked against the brute
    force."""
    import threading
    results, errors = {}, []

    def caller(t):
        try:
            for j in range(BATCHER_PER_THREAD):
                i = (t * BATCHER_PER_THREAD + j) % len(ecqls)
                results[t, j] = (i, batcher.query(ecqls[i], "ais"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(BATCHER_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    errors += [f"wrong ids for query {i}" for (i, r) in results.values()
               if not np.array_equal(r.rows, truth[i])]
    if len(results) != BATCHER_THREADS * BATCHER_PER_THREAD:
        errors.append(f"{len(results)} results")
    st = batcher.stats()
    return {"threads": BATCHER_THREADS, "per_thread": BATCHER_PER_THREAD,
            "seconds": wall, "queries_per_s": len(results) / wall,
            "coalesce_ratio": st["coalesce_ratio"], "batches": st["batches"],
            "stats": st, "errors": errors[:3]}


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
    launches, ds, rows = phase_store(args.seed, args.store_rows,
                                     stats["scan_mask_gather"])
    batched = phase_batched(args.seed, ds, rows)
    for name in ("scan_batch_bits", "compact_prefix", "compact_bits"):
        launches[name] = batched[name]
    summary = []
    for name, s in stats.items():
        q0 = s["per_query"][0]   # the BBOX+time query (1M random ids
                                 # for the gathered kernel, L2 cold); the
                                 # batch of 32 for the batched kernels
        summary.append({
            "name": name, "route": "cuda",
            "source": SOURCE_FILES.get(name,
                                       "geomesa_tpu_torch/csrc/scan.cu"),
            "replaces": SOURCES[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": q0["ms"],
            "plain_ms": q0["plain_ms"], "bound_ms": q0["bound_ms"],
            "bound_by": q0["bound_by"],
            "library_ms": q0.get("library_ms")})
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
