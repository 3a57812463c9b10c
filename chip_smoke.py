#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--store-rows 10000000]

Phases, one JSON line each; any failure exits non-zero:

1. build   the CUDA kernels from geomesa_tpu_torch/csrc/scan.cu,
           csrc/batch.cu, csrc/geom.cu, csrc/residual.cu and
           csrc/density.cu (one nvcc per source, started together, then
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
5. predicates  exact polygon and attribute predicates: the earlier
           stores freed, a store of --store-rows rows shaped like a GDELT
           1.0 event record (EventCode:String:index=true with 320
           CAMEO-like codes, Zipf-skewed; Actor1CountryCode:String, 250
           codes, 15 % null; NumMentions:Integer, heavy-tailed, 0.1 %
           null; AvgTone:Double in -10..10, a fifth rounded to 0.1 and
           0.2 % on f64 neighbours of one threshold; IsRootEvent:Boolean;
           dtg; geom) written through write() with the string columns
           built from their vocabularies and int32 codes; the residual's
           device columns uploaded and timed apart; then eight queries
           (PRED_QUERIES: a 300-vertex polygon with a hole AND DURING and
           a two-part multipolygon through the point-in-polygon kernel,
           attribute-only filters through the residual kernel as the
           fullscan secondary, the dense secondary with f64 band rows and
           a wide attribute-index range, an attribute-index equality, a
           fid IN of 1,000 ids, a DISJOINT), each query's ids and
           query_count equal to a float64 numpy brute force. Launch
           counts are zeroed before the queries and read after; both
           kernels must have launched. Outside the counted run, every
           call the path made to either kernel is held exactly against
           its plain version (torch.equal), both kernels are timed at the
           path's own shapes beside their bounds, and each query's p50
           (host clock, 3 runs) is printed with its strategy. pip_mask's
           bound counts the pairs its skip leaves (counted on the device:
           within each edge's expanded y range, inside its whole box),
           beside the earlier all-pairs count (bound_all_pairs_ms); the
           residual kernel is timed alone (a launch prepared once) and
           through its wrapper, held (wrapper_ms) and on an idle card,
           so that the host's work counts: warm (wrapper_bare_ms, the
           prepared launch found) and cold (wrapper_cold_ms, prepared
           anew each call, as on a new filter or after a flush), beside
           the prepared launch on an idle card (kernel_bare_ms).
6. surface the query surface and the pushdowns on the predicates
           phase's store, before it is freed. Launch counts are zeroed,
           then density() draws three grids (a 256x256 tile over a
           BBOX and 30 days; the world at 2048x1024 over 73 days
           weighted by NumMentions, and by AvgTone), each held to a
           float32 numpy brute force that casts as the reference does
           and sums with np.add.at: exact where the weights are unit or
           integers with a cell total under 2^24, else each cell within
           2 * n_cell * 2^-24 * sum |w|; bin_query on the tile, plain and
           time-sorted, labelled by EventCode, record for record; a sort
           by NumMentions descending with max_features, a projection,
           SAMPLING 0.1 with and without SAMPLE_BY EventCode, id-exact;
           and a store of 1M rows with four distinct visibility labels at
           feature and at attribute level, id-exact per auth set (the
           leak guard's case included); then the density kernel's count
           is read: it must have launched. Outside the counted run,
           every recorded launch is held to its plain version on the
           card (unit weights equal, weighted within the bound), the
           kernel is timed at the weighted world call's shape beside
           its byte bound (13 B a row, 4 B a cell), its plain version
           and one index_add_ over the same cells, and with every row in
           one cell (a 1x1 grid); one density() call is split into the
           query, the column gather, the f32 conversion and upload, the
           kernel and the copy back. Then 1,000 ids are deleted (delete
           and rebuild timed) and a z3, a polygon and an attribute query
           are held to the brute force over the kept rows; then
           remove_schema, with torch.cuda.memory_allocated falling.

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
PRED_KERNELS = ("pip_mask", "residual_mask")   # the predicates phase's
SOURCES.update({
    "pip_mask": "geomesa_tpu/scan/gscan.py:239 _pip_kernel",
    "residual_mask": "geomesa_tpu/scan/residual.py:132 device_mask "
                     "(+ :214 _pair_cmp, :313 _vocab_gather)",
})
SURFACE_KERNELS = ("density_grid",)           # the surface phase's
SOURCES["density_grid"] = "geomesa_tpu/scan/aggregations.py:28 _density_kernel"
SOURCE_FILES = {k: "geomesa_tpu_torch/csrc/batch.cu"
                for k in ("scan_batch_bits", "compact_prefix", "compact_bits")}
SOURCE_FILES.update({"pip_mask": "geomesa_tpu_torch/csrc/geom.cu",
                     "residual_mask": "geomesa_tpu_torch/csrc/residual.cu",
                     "density_grid": "geomesa_tpu_torch/csrc/density.cu"})
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


def cuda_ms(fn, iters: int, warmup: int = 2, flush=None,
            held: bool = True) -> float:
    """Median milliseconds of fn() on the card (CUDA events); ``flush``
    runs before each timed launch, outside the events. Held (the
    default), a spin kernel holds the card ahead of the first event
    while the host enqueues fn(), so the events time the device's work
    and not the host's launch latency (which exceeds a short kernel's
    own time); not held, the card is idle and the events take in the
    host's work between them too."""
    for _ in range(warmup):
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
    stats = {k: {"max_abs_err": 0, "per_query": []} for k in SOURCES
             if k not in PRED_KERNELS + SURFACE_KERNELS}
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
                ds.query(ecql, "ais").ids
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
                    batched.append(_timed(lambda: [
                        r.ids for r in ds.query_batched(qs)]))
                    seq.append(_timed(lambda: [ds.query(q).ids
                                               for q in qs]))
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
        "call_ms": statistics.median(
            _timed(lambda: [r.ids for r in ds.query_batched(qs)])
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
                r = batcher.query(ecqls[i], "ais")
                r.ids   # the ids on the host inside the timed run
                results[t, j] = (i, r)
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


# -- the predicates phase ----------------------------------------------------

PRED_SPEC = ("EventCode:String:index=true,Actor1CountryCode:String,"
             "NumMentions:Integer,AvgTone:Double,IsRootEvent:Boolean,"
             "dtg:Date,*geom:Point:srid=4326")
TONE_T = -5.123456789     # AvgTone threshold; its f64 neighbours are data
PRED_RUNS = 3             # host-clock runs per query for its p50


def event_codes() -> np.ndarray:
    """320 CAMEO-like event codes: 20 roots, each with its base code,
    nine 3-digit and six 4-digit refinements, sorted."""
    out = []
    for r in range(1, 21):
        out += [f"{r:02d}{k}" for k in range(10)]
        out += [f"{r:02d}{k}{m}" for k in (1, 2) for m in (1, 2, 3)]
    return np.array(sorted(out))


def country_codes(rng) -> np.ndarray:
    """250 three-letter country codes, sorted, with a few real ones."""
    real = {"USA", "GBR", "CHN", "RUS", "UKR", "UGA", "URY", "UZB", "FRA"}
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    out = set(real)
    while len(out) < 250:
        out.add("".join(rng.choice(letters, 3)))
    return np.array(sorted(out))


def star_ring(cx, cy, rx, ry, n, k=0, wobble=0.0, phase=0.0):
    """A counter-clockwise ring of n vertices, star-shaped about (cx,
    cy): radius (rx, ry) * (1 + wobble sin(k t + phase)) at parameter
    angles t in (-pi, pi)."""
    t = -np.pi + (np.arange(n) + 0.5) * (2 * np.pi / n)
    r = 1 + wobble * np.sin(k * t + phase)
    return np.c_[cx + rx * r * np.cos(t), cy + ry * r * np.sin(t)]


def _ring_wkt(ring) -> str:
    closed = np.vstack([ring, ring[:1]])
    return "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in closed) + ")"


PRED_SHELL = star_ring(10.0, 0.0, 95.0, 60.0, 300, k=7, wobble=0.15, phase=0.3)
PRED_HOLE = star_ring(20.0, 10.0, 20.0, 20.0, 40)
PRED_PARTS = [star_ring(-95.0, 0.0, 70.0, 55.0, 64, k=5, wobble=0.1),
              star_ring(95.0, 5.0, 70.0, 55.0, 64, k=4, wobble=0.1, phase=1.0)]
PRED_SMALL = star_ring(120.0, -20.0, 15.0, 15.0, 24, k=3, wobble=0.2)
PRED_POLYGON = f"POLYGON({_ring_wkt(PRED_SHELL)}, {_ring_wkt(PRED_HOLE)})"
PRED_DURING = (T0_DAY + 5, T0_DAY + 95)   # days, exclusive
PRED_ATTR_FILTER = ("AvgTone < -5 AND NumMentions >= 10 AND "
                    "Actor1CountryCode LIKE 'U%'")
PRED_BAND_FILTER = (f"AvgTone = {TONE_T!r} OR NOT (Actor1CountryCode IN "
                    f"('USA', 'GBR', 'CHN', 'RUS'))")


def in_star(x, y, ring, cx, cy, rx, ry) -> np.ndarray:
    """Float64 brute force of a point in a ring star-shaped about (cx,
    cy), boundary included: the ray from the centre to the point crosses
    the edge of the point's angular sector, and the point lies on the
    centre's side of that edge or on it (the orientation sign of the
    edge and the point in f64)."""
    ang = np.arctan2((ring[:, 1] - cy) / ry, (ring[:, 0] - cx) / rx)
    phi = np.arctan2((y - cy) / ry, (x - cx) / rx)
    i = np.searchsorted(ang, phi, side="right") - 1   # -1: the wrap edge
    x0, y0 = ring[i, 0], ring[i, 1]
    j = (i + 1) % len(ring)
    x1, y1 = ring[j, 0], ring[j, 1]
    return (x1 - x0) * (y - y0) - (y1 - y0) * (x - x0) >= 0


def _in_box(x, y, box):
    return (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])


def _env(ring):
    return (ring[:, 0].min(), ring[:, 1].min(), ring[:, 0].max(),
            ring[:, 1].max())


def predicate_data(seed: int, rows: int) -> dict:
    """The GDELT-shaped columns from ``seed``: strings as sorted vocab +
    int32 codes (-1 null), numbers with validity, points and dates."""
    rng = np.random.default_rng(seed + 5)
    ev_vocab = event_codes()
    rank = rng.permutation(len(ev_vocab))     # frequency rank -> code
    ev = rank[np.minimum(rng.zipf(1.4, rows) - 1,
                         len(ev_vocab) - 1)].astype(np.int32)
    ac_vocab = country_codes(rng)
    ac = np.minimum(rng.zipf(1.2, rows) - 1, len(ac_vocab) - 1)
    ac = rng.permutation(len(ac_vocab))[ac].astype(np.int32)
    ac[rng.random(rows) < 0.15] = -1
    mentions = (np.floor(rng.pareto(1.1, rows) * 3) + 1).astype(np.int64)
    mentions_valid = rng.random(rows) >= 0.001
    tone = rng.uniform(-10.0, 10.0, rows)
    tone = np.where(rng.random(rows) < 0.2, np.round(tone, 1), tone)
    near = np.flatnonzero(rng.random(rows) < 0.002)
    tone[near] = TONE_T + rng.integers(-8, 9, len(near)) * np.spacing(TONE_T)
    return {"ev": ev, "ev_vocab": ev_vocab, "ac": ac, "ac_vocab": ac_vocab,
            "mentions": mentions, "mentions_valid": mentions_valid,
            "tone": tone, "root": rng.random(rows) < 0.4,
            "ms": rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, rows),
            "x": rng.uniform(-180, 180, rows),
            "y": rng.uniform(-90, 90, rows)}


def predicate_batch(sft, d: dict, ids):
    """The store's batch from ``predicate_data``'s columns (the string
    columns from their vocabularies and codes, no Python strings)."""
    from geomesa_tpu_torch.features.batch import (BoolColumn, DateColumn,
                                                  FeatureBatch, NumericColumn,
                                                  PointColumn, StringColumn)
    n = len(d["x"])
    ones = np.ones(n, dtype=bool)
    return FeatureBatch(sft, ids, {
        "EventCode": StringColumn("EventCode", d["ev"],
                                  d["ev_vocab"].astype(object)),
        "Actor1CountryCode": StringColumn("Actor1CountryCode", d["ac"],
                                          d["ac_vocab"].astype(object)),
        "NumMentions": NumericColumn("NumMentions", d["mentions"],
                                     d["mentions_valid"]),
        "AvgTone": NumericColumn("AvgTone", d["tone"], ones),
        "IsRootEvent": BoolColumn("IsRootEvent", d["root"], ones),
        "dtg": DateColumn("dtg", d["ms"], ones),
        "geom": PointColumn("geom", d["x"], d["y"], ones)})


def _iso(day: int) -> str:
    return str(np.datetime64(day, "D")) + "T00:00:00Z"


def predicate_queries(d: dict, ids) -> list:
    """The phase's eight queries as (name, ecql, brute-force mask): each
    mask in float64 / int64 numpy over the raw columns."""
    x, y, ms = d["x"], d["y"], d["ms"]
    ev, ac = d["ev"], d["ac"]
    ev_vocab, ac_vocab = d["ev_vocab"], d["ac_vocab"]

    def during(lo_day, hi_day):
        return (ms > lo_day * MS_DAY) & (ms < hi_day * MS_DAY)

    def star(ring, cx, cy, rx, ry):
        box = _env(ring)
        inside = np.zeros(len(x), dtype=bool)
        sel = np.flatnonzero(_in_box(x, y, box))
        inside[sel] = in_star(x[sel], y[sel], ring, cx, cy, rx, ry)
        return inside

    shell = star(PRED_SHELL, 10.0, 0.0, 95.0, 60.0)
    hole = star(PRED_HOLE, 20.0, 10.0, 20.0, 20.0)
    # a point on the hole's boundary stays in: the strict interior goes
    hole_strict = hole & ~_on_ring(x, y, PRED_HOLE, hole)
    q1 = shell & ~hole_strict & during(*PRED_DURING)
    parts = (star(PRED_PARTS[0], -95.0, 0.0, 70.0, 55.0)
             | star(PRED_PARTS[1], 95.0, 5.0, 70.0, 55.0))
    like_u = np.char.startswith(ac_vocab, "U")
    q3 = ((d["tone"] < -5) & (d["mentions"] >= 10) & d["mentions_valid"]
          & (ac >= 0) & like_u[np.maximum(ac, 0)])
    big4 = np.isin(ac_vocab, ["USA", "GBR", "CHN", "RUS"])
    q4 = (_in_box(x, y, (-179, -89, 179, 89)) & during(T0_DAY + 1,
                                                       T0_DAY + 99)
          & ((d["tone"] == TONE_T) | ~((ac >= 0) & big4[np.maximum(ac, 0)])))
    # an equality on a code of middling frequency; a range >= the code
    # at the lexicographic median of the rows
    counts = np.bincount(ev, minlength=len(ev_vocab))
    order = np.argsort(-counts)
    eq_code = ev_vocab[order[10]]
    ge_code = ev_vocab[np.searchsorted(np.cumsum(counts), len(ev) // 2)]
    q5 = (ev_vocab[ev] == eq_code) & during(T0_DAY + 10, T0_DAY + 40)
    q6 = ev_vocab[ev] >= ge_code
    fid_rows = np.random.default_rng(99).choice(len(x), 1000, replace=False)
    q7 = np.zeros(len(x), dtype=bool)
    q7[fid_rows] = True
    small_box = (100.0, -40.0, 140.0, 0.0)
    q8 = _in_box(x, y, small_box) & ~star(PRED_SMALL, 120.0, -20.0, 15.0,
                                          15.0)
    multi = ("MULTIPOLYGON(" + ", ".join(f"({_ring_wkt(p)})"
                                         for p in PRED_PARTS) + ")")
    fids = ", ".join(f"'{ids[i]}'" for i in fid_rows)
    return [
        ("polygon_hole_during",
         f"INTERSECTS(geom, {PRED_POLYGON}) AND dtg DURING "
         f"{_iso(PRED_DURING[0])}/{_iso(PRED_DURING[1])}", q1),
        ("multipolygon_within", f"WITHIN(geom, {multi})", parts),
        ("attributes_fullscan", PRED_ATTR_FILTER, q3),
        ("dense_secondary_band",
         f"BBOX(geom, -179, -89, 179, 89) AND dtg DURING "
         f"{_iso(T0_DAY + 1)}/{_iso(T0_DAY + 99)} AND ({PRED_BAND_FILTER})",
         q4),
        ("attr_equality_during",
         f"EventCode = '{eq_code}' AND dtg DURING "
         f"{_iso(T0_DAY + 10)}/{_iso(T0_DAY + 40)}", q5),
        ("attr_wide_range", f"EventCode >= '{ge_code}'", q6),
        ("fid_in_1000", f"IN ({fids})", q7),
        ("bbox_disjoint",
         f"BBOX(geom, {small_box[0]}, {small_box[1]}, {small_box[2]}, "
         f"{small_box[3]}) AND DISJOINT(geom, POLYGON({_ring_wkt(PRED_SMALL)}))",
         q8),
    ]


def _on_ring(x, y, ring, cand):
    """Exactly on one of the ring's edges (f64 orientation zero within
    the edge's box), over the rows ``cand`` only."""
    out = np.zeros(len(x), dtype=bool)
    sel = np.flatnonzero(cand)
    if not len(sel):
        return out
    px, py = x[sel], y[sel]
    hit = np.zeros(len(sel), dtype=bool)
    for a, b in zip(ring, np.roll(ring, -1, axis=0)):
        cross = (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])
        hit |= ((cross == 0) & (px >= min(a[0], b[0]))
                & (px <= max(a[0], b[0])) & (py >= min(a[1], b[1]))
                & (py <= max(a[1], b[1])))
    out[sel] = hit
    return out


def _strategy(res) -> str:
    text = res.explain.text
    notes = [k for k, line in (
        ("pip_kernel", "Device point-in-polygon residual"),
        ("residual_dense", "Device residual scan (dense)"),
        ("attr_too_wide", "Attribute bounds too wide"),
        ("attr_index_scan", "Attribute index scan"),
        ("device_scan", "Device scan:"),
        ("gathered_scan", "Index-pruned device scan"),
        ("host_scan", "Index-pruned host scan")) if line in text]
    return "+".join([res.plan.index] + notes)


# pip_mask's operations, each add, subtract, multiply, division, compare,
# select or xor counted as one at the f32 rate, as csrc/geom.cu's note
# counts what these inputs need: per point its slab (four); per pair
# within the y reach the y test's two, the span test's three, the x
# reach's two and the crossing's two; per pair inside the expanded box
# the full path's 21, five more where the edge spans the point's y; per
# edge the prologue's 29
PIP_OPS = {"point": 4, "y_reach": 9, "in_box": 21, "in_box_span": 5,
           "edge": 29}
# the count before the skip, kept for continuity: per (point, edge) the
# crossing test's two compares and xor, t's two subtracts, two
# multiplies, add and division, the clamp's two, dx's and dy's three
# each, d2's three and the minimum's one; three more (xint's multiply,
# division and add) and two (px < xint, the parity flip) where the edge
# spans the point's y; once per edge ex, ey, len2 and the two zero guards
PIP_OPS_PAIR, PIP_OPS_CROSSING, PIP_OPS_EDGE = 21, 5, 9


def pip_crossings(py, edges) -> int:
    """(point, edge) pairs whose edge spans the point's y, the crossing
    test's ``(y0 > py) != (y1 > py)``: py in [min(y0, y1), max(y0, y1))."""
    ys = torch.sort(py).values
    lo = torch.minimum(edges[:, 1], edges[:, 3]).contiguous()
    hi = torch.maximum(edges[:, 1], edges[:, 3]).contiguous()
    return int((torch.searchsorted(ys, hi) - torch.searchsorted(ys, lo))
               .sum().item())


def pip_pair_counts(px, py, edges, eps2) -> dict:
    """The pairs the kernel's walk needs, counted on the device over
    chunks of points: within each edge's expanded y range (or not
    testable: a NaN, infinite or huge point or edge), inside the whole
    expanded box, and inside it with the edge spanning the point's y
    (``kernels.pip_edge_terms_plain``: the kernel's own margins)."""
    from geomesa_tpu_torch.scan import kernels
    lox, hix, loy, hiy = kernels.pip_edge_terms_plain(edges, eps2)
    y0, y1 = edges[:, 1], edges[:, 3]
    out = {"y_reach": 0, "in_box": 0, "in_box_span": 0}
    step = max(1, (1 << 24) // max(1, edges.shape[0]))
    for lo in range(0, px.shape[0], step):
        x, y = px[lo:lo + step], py[lo:lo + step]
        tame = (x.abs() <= 2.0**60) & (y.abs() <= 2.0**60)
        sx = torch.where(tame, x, float("nan"))[:, None]
        sy = torch.where(tame, y, float("nan"))[:, None]
        iny = ~((sy < loy) | (sy > hiy))
        inbox = iny & ~((sx < lox) | (sx > hix))
        cond = (y0 > y[:, None]) != (y1 > y[:, None])
        out["y_reach"] += int(iny.sum().item())
        out["in_box"] += int(inbox.sum().item())
        out["in_box_span"] += int((inbox & cond).sum().item())
    return out


def _residual_bytes(slots, n: int) -> int:
    """Bytes the residual kernel must move: each slot column read once
    per row, one byte out per row."""
    return n * (1 + sum(t.element_size() for s in slots for t in s
                        if t is not None))


PIP_STEP_SIZES = (100, 1_000, 10_000, 50_000, 500_000)   # candidates


def pip_step_times(ds, st, d: dict) -> list:
    """The polygon query's exact-geometry step both ways on the same
    candidates (the first k rows inside the polygon's envelope): the
    host's float64 crossing number over the candidates' coordinates, and
    the store's point-in-polygon path (``pip_mask`` plus its float64 band
    recheck). Host-clock medians of PRED_RUNS interleaved runs each, in
    ms (a host run of over a second is made once); the two keep masks
    must agree."""
    from geomesa_tpu_torch.filters.ecql import parse_ecql
    f = parse_ecql(f"INTERSECTS(geom, {PRED_POLYGON})")
    col = st.batch.col("geom")
    env = np.flatnonzero(_in_box(d["x"], d["y"], _env(PRED_SHELL)))
    out = []
    for k in PIP_STEP_SIZES:
        idx = env[:k]

        def host():
            return f.geom.contains_points(col.x[idx], col.y[idx]) \
                & col.valid[idx]

        def device():
            return ds._pip_residual(st, f, col, idx, lambda _: None)
        times = {"host": [], "device": []}
        keep = {}
        for r in range(PRED_RUNS):
            for name, fn in (("device", device), ("host", host)):
                if name == "host" and r and times["host"][0] > 1e3:
                    continue
                t0 = time.perf_counter()
                keep[name] = fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
        row = {"candidates": len(idx), "hits": int(keep["host"].sum()),
               "same": bool(np.array_equal(keep["host"], keep["device"]))}
        for name, ts in times.items():
            row[f"{name}_ms"] = statistics.median(ts)
        out.append(row)
    return out


def phase_predicates(seed: int, rows: int, ids) -> dict:
    """Exact polygon and attribute predicates on a GDELT-shaped store."""
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.scan import kernels
    d = predicate_data(seed, rows)
    queries = predicate_queries(d, ids)
    ds = InMemoryDataStore()
    ds.create_schema("gdelt", PRED_SPEC)
    t0 = time.perf_counter()
    ds.write("gdelt", predicate_batch(ds.get_schema("gdelt"), d, ids))
    st = ds._types["gdelt"]
    st.ensure_index()
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    # the residual's device columns, uploaded apart from the queries
    t0 = time.perf_counter()
    cols = st.device_cols()
    for name in ("EventCode", "Actor1CountryCode", "NumMentions", "AvgTone",
                 "IsRootEvent"):
        cols.get(name)
    torch.cuda.synchronize()
    upload = {"seconds": time.perf_counter() - t0, "bytes": cols.nbytes}

    # the counted run; every call the path makes to either kernel is
    # recorded for the checks and timings below
    calls = {"pip_mask": [], "residual_mask": []}
    real = {k: getattr(kernels, k) for k in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return real[name](*args)
        return call
    kernels.reset_launches()
    t_main = time.perf_counter()
    per_q = []
    try:
        for name in calls:
            setattr(kernels, name, recorder(name))
        for qname, ecql, want in queries:
            res = ds.query(ecql, "gdelt")
            rows_want = np.flatnonzero(want)
            ok = (np.array_equal(res.rows, rows_want)
                  and np.array_equal(res.ids, ids[rows_want])
                  and ds.query_count(ecql, "gdelt") == len(rows_want))
            per_q.append({"query": qname, "hits": len(rows_want),
                          "strategy": _strategy(res), "exact": ok})
            if not ok:
                raise SystemExit(f"predicates: {qname} disagrees with the "
                                 f"float64 brute force")
    finally:
        for name in calls:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = {k: kernels.launches[k] for k in calls}

    # outside the counted run: every recorded call against the plain
    # version, exactly; then both kernels timed at the path's shapes
    wrong = []
    for px, py, edges, eps2 in calls["pip_mask"]:
        got = kernels.pip_mask(px, py, edges, eps2)
        want = kernels.pip_mask_plain(px, py, edges, eps2)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            wrong.append(("pip_mask", px.shape[0], edges.shape[0]))
    for args in calls["residual_mask"]:
        got = kernels.residual_mask(*args)
        if not torch.equal(got, kernels.residual_mask_plain(*args)):
            wrong.append(("residual_mask", args[4], args[0].shape[0]))
    stats = {}
    if calls["pip_mask"]:
        px, py, edges, eps2 = max(
            calls["pip_mask"], key=lambda a: a[0].shape[0] * a[2].shape[0])
        n, e = px.shape[0], edges.shape[0]
        crossings = pip_crossings(py, edges)
        pairs = pip_pair_counts(px, py, edges, eps2)
        all_ms, _ = bound_ms(10 * n + 16 * e, PIP_OPS_PAIR * n * e
                             + PIP_OPS_CROSSING * crossings + PIP_OPS_EDGE * e)
        bms, bby = bound_ms(10 * n + 16 * e, PIP_OPS["point"] * n + sum(
            PIP_OPS[k] * pairs[k] for k in pairs) + PIP_OPS["edge"] * e)
        stats["pip_mask"] = {
            "points": n, "edges": e, "crossing_pairs": crossings, **pairs,
            "max_abs_err": 0,
            "ms": cuda_ms(lambda: kernels.pip_mask(px, py, edges, eps2), 10),
            "plain_ms": cuda_ms(
                lambda: kernels.pip_mask_plain(px, py, edges, eps2), 1, 1),
            "bound_ms": bms, "bound_by": bby, "bound_all_pairs_ms": all_ms,
            "library_ms": None,
            "band": int(kernels.pip_mask_plain(px, py, edges, eps2)[1]
                        .sum().item())}
    if calls["residual_mask"]:
        args = max(calls["residual_mask"], key=lambda a: a[4])
        code, consts, table, slots, n = args[:5]
        bms, bby = bound_ms(_residual_bytes(slots, n)
                            + code.numel() * 4 + consts.numel() * 4
                            + table.numel(), n * code.shape[0])
        out = kernels.residual_mask(*args)
        launch = kernels.residual_launcher(code, consts, table, slots,
                                           out.device)
        stats["residual_mask"] = {
            "rows": n, "instructions": code.shape[0], "slots": len(slots),
            "max_abs_err": 0,
            "ms": cuda_ms(lambda: launch(n, out), 10),
            "wrapper_ms": cuda_ms(lambda: kernels.residual_mask(*args), 10),
            "kernel_bare_ms": cuda_ms(lambda: launch(n, out), 10,
                                      held=False),
            "wrapper_bare_ms": cuda_ms(lambda: kernels.residual_mask(*args),
                                       10, held=False),
            "wrapper_cold_ms": cuda_ms(
                lambda: kernels.residual_mask(*args), 10,
                flush=kernels._residual_launches.clear, held=False),
            "plain_ms": cuda_ms(lambda: kernels.residual_mask_plain(*args),
                                3, 1),
            "bound_ms": bms, "bound_by": bby, "library_ms": None,
            "band": int(((out & 2) != 0).sum().item())}
    for name, _, _ in wrong:
        stats.setdefault(name, {})["max_abs_err"] = 1
    pip_step = pip_step_times(ds, st, d)
    wrong += [("pip_step", r["candidates"], 0) for r in pip_step
              if not r["same"]]
    for q, (qname, ecql, _) in zip(per_q, queries):
        times = []
        for _ in range(PRED_RUNS):
            t0 = time.perf_counter()
            ds.query(ecql, "gdelt").ids
            times.append((time.perf_counter() - t0) * 1e3)
        q["p50_ms"] = statistics.median(times)
    emit({"phase": "predicates", "rows": rows, "write_s": write_s,
          "device_columns": upload, "queries": per_q,
          "kernel_calls": {k: len(v) for k, v in calls.items()},
          "kernels": stats, "launches": counts, "seconds": main_s,
          "pip_step": pip_step, "wrong": wrong})
    if wrong:
        raise SystemExit(f"predicates: kernels disagree with their plain "
                         f"versions, or the exact step's two ways "
                         f"disagree: {wrong}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the predicates path: "
                         f"{missing}")
    del calls
    return stats, counts, ds, d, queries


# -- the surface phase -------------------------------------------------------

SURFACE_TILE = (-80.0, 30.0, -60.0, 45.0)
SURFACE_TILE_DAYS = (T0_DAY + 20, T0_DAY + 50)     # 30 days, exclusive
SURFACE_WORLD_DAYS = (T0_DAY + 2, T0_DAY + 75)     # 73 days, exclusive
SURFACE_WIDE = (-120.0, 20.0, -70.0, 50.0)         # no time
WORLD = (-180.0, -90.0, 180.0, 90.0)
SURFACE_RUNS = 3          # host-clock runs per call for its p50
VIS_ROWS = 1_000_000
VIS_LABELS = [None, "a", "a&b", "b|c"]            # feature level
# attribute level, one part per attribute of VIS_SPEC
ATTR_VIS_LABELS = [",,,", "a,,,", ",b,a&b,", "c,c,c,c"]
VIS_SPEC = "EventCode:String,NumMentions:Integer,dtg:Date,*geom:Point:srid=4326"
AUTH_SETS = ([], ["a"], ["a", "b"], ["a", "b", "c"])


def _label_ok(label, auths) -> bool:
    """An Accumulo visibility label of VIS_LABELS' forms against auths."""
    if not label:
        return True
    if "|" in label:
        return any(t in auths for t in label.split("|"))
    return all(t in auths for t in label.split("&"))


def java_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= 1 << 31 else h


def density_brute(x, y, mask, bbox, width, height, w=None):
    """(grid, flat): the float32 numpy brute force of the density grid,
    cast as the reference casts (f32 coordinates rounded to nearest, the
    scalars in f64 rounded to f32, f32 arithmetic, a saturating
    truncation with NaN as 0, the clip) and summed in row order by
    np.add.at in f32; ``flat`` each row's cell."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    sx = np.float32(width / (xmax - xmin) if xmax > xmin else 0.0)
    sy = np.float32(height / (ymax - ymin) if ymax > ymin else 0.0)

    def bins(v, lo, scale, size):
        with np.errstate(invalid="ignore", over="ignore"):
            t = np.trunc((v.astype(np.float32) - np.float32(lo)) * scale)
        t = np.where(np.isnan(t), 0.0, t.astype(np.float64))
        return np.clip(t, 0, size - 1).astype(np.int64)
    flat = bins(y, ymin, sy, height) * width + bins(x, xmin, sx, width)
    vals = np.where(mask, np.float32(1.0) if w is None
                    else np.asarray(w, np.float32), np.float32(0.0))
    grid = np.zeros(height * width, dtype=np.float32)
    np.add.at(grid, flat, vals.astype(np.float32))
    return grid.reshape(height, width), flat


def grid_bound(flat, mask, w, cells: int):
    """(bound, exact) float64 and bool [cells]: per cell 2 * n_cell *
    2^-24 * sum |w|, how far f32 sums of the cell's weights may move
    with the order of the adds; and the cells that every order sums
    exactly (unit or integer weights with sum |w| under 2^24, so every
    partial sum is an exact f32 integer)."""
    f = flat[mask]
    n_cell = np.bincount(f, minlength=cells)
    wm = (np.ones(len(f)) if w is None
          else np.asarray(w, np.float64)[mask])
    abs_w = np.bincount(f, np.abs(wm), minlength=cells)
    exact = ((abs_w < 2**24) if np.all(wm == np.round(wm))
             else np.zeros(cells, dtype=bool))
    return 2 * n_cell * 2.0**-24 * abs_w, exact


def grid_verdict(got, want, flat, mask, w) -> dict:
    """Exact on grid_bound's exact cells, within its bound elsewhere."""
    diff = np.abs(got.astype(np.float64).ravel() - want.astype(np.float64)
                  .ravel())
    bound, exact = grid_bound(flat, mask, w, want.size)
    ok = bool(np.all(diff[exact] == 0) and np.all(diff[~exact]
                                                  <= bound[~exact]))
    return {"max_abs_err": float(diff.max()) if diff.size else 0.0,
            "exact_cells": int(exact.sum()),
            "bound_cells": int((~exact).sum()), "ok": ok}


def _p50(fn, runs: int = SURFACE_RUNS) -> float:
    return statistics.median(_timed(fn) for _ in range(runs))


def density_split(ds, ecql, bbox, width, height, attr) -> dict:
    """Where one density() call spends its time, each step synchronised
    (host clock, medians of SURFACE_RUNS): the query, the gather of the
    result's point (and weight) columns, their f32 conversion and
    upload, the kernel, the grid's copy back; and the whole call."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan import aggregations, kernels
    from geomesa_tpu_torch.store.memory import density_columns
    steps = {k: [] for k in ("query", "gather", "upload", "kernel",
                             "copy_back", "call")}
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    for _ in range(SURFACE_RUNS):
        t0 = time.perf_counter()
        res = ds.query(Query("gdelt", ecql))
        t1 = time.perf_counter()
        x, y, mask, w = density_columns(res, "geom", bbox, attr)
        t2 = time.perf_counter()
        xt, yt, wt, mt = aggregations.density_upload(x, y, mask, w, ds.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        grid = kernels.density_grid(xt, yt, wt, mt, xmin, ymin, sx, sy,
                                    width, height)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        grid.cpu().numpy()
        t5 = time.perf_counter()
        for k, a, b in (("query", t0, t1), ("gather", t1, t2),
                        ("upload", t2, t3), ("kernel", t3, t4),
                        ("copy_back", t4, t5)):
            steps[k].append((b - a) * 1e3)
        steps["call"].append(_timed(lambda: ds.density(
            "gdelt", ecql, bbox, width, height, attr)))
    return {"rows": int(res.n), **{f"{k}_ms": statistics.median(v)
                                   for k, v in steps.items()}}


def _tile_ecql() -> str:
    x0, y0, x1, y1 = SURFACE_TILE
    return (f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND dtg DURING "
            f"{_iso(SURFACE_TILE_DAYS[0])}/{_iso(SURFACE_TILE_DAYS[1])}")


def _sample_brute(rows, rate, by=None):
    k = max(1, int(round(1.0 / rate)))
    if by is None:
        return rows[np.arange(len(rows)) % k == 0]
    order = np.argsort(by, kind="stable")
    g = by[order]
    start = np.r_[True, g[1:] != g[:-1]]
    pos = np.arange(len(rows))
    rank = np.empty(len(rows), dtype=np.int64)
    rank[order] = pos - np.maximum.accumulate(np.where(start, pos, 0))
    return rows[rank % k == 0]


def surface_queries(ds, d, ids, during) -> list:
    """The query surface on the store, each result id-exact against
    the brute force: a sort with max_features, a projection, SAMPLING
    with and without SAMPLE_BY (with query_count equal to query().n)."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.index.api import QueryHints
    x, y, ms = d["x"], d["y"], d["ms"]
    tile = np.flatnonzero(_in_box(x, y, SURFACE_TILE) & during(
        *SURFACE_TILE_DAYS))
    wide = np.flatnonzero(_in_box(x, y, SURFACE_WIDE))
    ev = d["ev_vocab"][d["ev"]]
    x0, y0, x1, y1 = SURFACE_WIDE
    wide_ecql = f"BBOX(geom, {x0}, {y0}, {x1}, {y1})"
    order = np.argsort(d["mentions"][tile], kind="stable")[::-1]
    cases = [
        ("sort_desc_limit", Query("gdelt", _tile_ecql(),
                                  sort_by="NumMentions", sort_desc=True,
                                  max_features=1000), tile[order[:1000]]),
        ("projection", Query("gdelt", _tile_ecql(),
                             properties=["EventCode", "geom"]), tile),
        ("sampling_0.1", Query("gdelt", wide_ecql,
                               hints={QueryHints.SAMPLING: 0.1}),
         _sample_brute(wide, 0.1)),
        ("sampling_0.1_by_EventCode",
         Query("gdelt", wide_ecql, hints={QueryHints.SAMPLING: 0.1,
                                          QueryHints.SAMPLE_BY: "EventCode"}),
         _sample_brute(wide, 0.1, ev[wide])),
    ]
    out = []
    for name, q, want in cases:
        res = ds.query(q)
        ok = (np.array_equal(res.rows, want)
              and np.array_equal(res.ids, ids[want])
              and ds.query_count(q) == res.n == len(want))
        if name == "projection":
            b = res.batch
            ok = ok and (set(b.columns) == {"EventCode", "geom"}
                         and np.array_equal(b.col("geom").x, x[want])
                         and np.array_equal(b.col("EventCode").vocab[
                             b.col("EventCode").codes], ev[want])
                         and set(b.feature(0)) == {"id", "EventCode",
                                                   "geom"})
        out.append({"query": name, "hits": len(want), "exact": bool(ok),
                    "p50_ms": _p50(lambda: ds.query(q).ids)})
    return out


def visibility_cases(d, ids, during) -> list:
    """A store of VIS_ROWS rows (the first rows of the phase's data)
    with four distinct labels, at feature and at attribute level; the
    tile query (and at attribute level one on a possibly hidden
    attribute, the leak guard's case) per auth set, id-exact against
    the brute force."""
    from geomesa_tpu_torch import InMemoryDataStore, Query
    from geomesa_tpu_torch.features.batch import (DateColumn, FeatureBatch,
                                                  NumericColumn, PointColumn,
                                                  StringColumn)
    n = min(VIS_ROWS, len(d["x"]))
    rng = np.random.default_rng(31)
    pick = rng.integers(0, 4, n)
    x, y, ms, ment = d["x"][:n], d["y"][:n], d["ms"][:n], d["mentions"][:n]
    ones = np.ones(n, dtype=bool)
    out = []
    for level, labels in (("feature", VIS_LABELS),
                          ("attribute", ATTR_VIS_LABELS)):
        ds = InMemoryDataStore()
        spec = VIS_SPEC + (";geomesa.visibility.level='attribute'"
                           if level == "attribute" else "")
        ds.create_schema("vis", spec)
        batch = FeatureBatch(ds.get_schema("vis"), ids[:n], {
            "EventCode": StringColumn("EventCode", d["ev"][:n],
                                      d["ev_vocab"].astype(object)),
            "NumMentions": NumericColumn("NumMentions", ment,
                                         d["mentions_valid"][:n]),
            "dtg": DateColumn("dtg", ms, ones),
            "geom": PointColumn("geom", x, y, ones)})
        t0 = time.perf_counter()
        ds.write("vis", batch, visibilities=np.array(labels,
                                                     dtype=object)[pick])
        ds.query(_tile_ecql(), "vis")
        write_s = time.perf_counter() - t0
        tile = _in_box(x, y, SURFACE_TILE) & (ms > SURFACE_TILE_DAYS[0]
                                              * MS_DAY) & (
            ms < SURFACE_TILE_DAYS[1] * MS_DAY)
        x0, y0, x1, y1 = SURFACE_TILE
        probe = (f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND NumMentions >= 5")
        probe_hit = (_in_box(x, y, SURFACE_TILE) & (ment >= 5)
                     & d["mentions_valid"][:n])
        for auths in AUTH_SETS:
            if level == "feature":
                seen = np.array([_label_ok(lb, auths) for lb in labels])
                cases = [("tile", _tile_ecql(), tile & seen[pick])]
            else:
                # per label and attribute (EventCode, NumMentions, dtg,
                # geom): visible; a row shows when any attribute does,
                # and a filter on a hidden attribute drops it
                attr_ok = np.array([[_label_ok(p, auths)
                                     for p in lb.split(",")]
                                    for lb in labels])[pick]
                any_ok = attr_ok.any(axis=1)
                cases = [("tile", _tile_ecql(),
                          tile & any_ok & attr_ok[:, 2] & attr_ok[:, 3]),
                         ("hidden_probe", probe,
                          probe_hit & any_ok & attr_ok[:, 1]
                          & attr_ok[:, 3])]
            for name, ecql, want in cases:
                q = Query("vis", ecql, auths=list(auths))
                res = ds.query(q)
                rows = np.flatnonzero(want)
                ok = (np.array_equal(res.rows, rows)
                      and np.array_equal(res.ids, ids[rows])
                      and ds.query_count(q) == len(rows))
                if level == "attribute" and ok and len(rows):
                    # redacted cells read as null
                    code_ok = attr_ok[rows, 0]
                    ok = bool(np.array_equal(
                        res.batch.col("EventCode").codes >= 0, code_ok))
                out.append({"level": level, "query": name,
                            "auths": list(auths), "hits": len(rows),
                            "exact": bool(ok), "write_s": write_s,
                            "p50_ms": _p50(lambda: ds.query(q).ids)})
        del ds
    torch.cuda.empty_cache()
    return out


def phase_surface(ds, d: dict, ids, queries) -> dict:
    """The query surface and the density and BIN pushdowns on the
    predicates phase's store, then a delete and remove_schema."""
    import gc
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan import kernels
    t_phase = time.perf_counter()
    x, y, ms = d["x"], d["y"], d["ms"]

    def during(lo_day, hi_day):
        return (ms > lo_day * MS_DAY) & (ms < hi_day * MS_DAY)
    tile = _in_box(x, y, SURFACE_TILE) & during(*SURFACE_TILE_DAYS)
    world = during(*SURFACE_WORLD_DAYS)
    world_ecql = (f"dtg DURING {_iso(SURFACE_WORLD_DAYS[0])}/"
                  f"{_iso(SURFACE_WORLD_DAYS[1])}")
    ment = np.where(d["mentions_valid"], d["mentions"], 0)
    grids = [
        ("tile_256", _tile_ecql(), SURFACE_TILE, 256, 256, None, tile, None),
        ("world_2048x1024_NumMentions", world_ecql, WORLD, 2048, 1024,
         "NumMentions", world & d["mentions_valid"], ment),
        ("world_2048x1024_AvgTone", world_ecql, WORLD, 2048, 1024,
         "AvgTone", world, d["tone"]),
    ]

    # the counted run: every call of the density kernel is recorded for
    # the checks and timings below
    calls = []
    real = kernels.density_grid

    def recorder(*args):
        calls.append(args)
        return real(*args)
    kernels.reset_launches()
    t_main = time.perf_counter()
    density, wrong = [], []
    try:
        kernels.density_grid = recorder
        for name, ecql, bbox, w, h, attr, mask, wts in grids:
            got = ds.density("gdelt", ecql, bbox, w, h, attr)
            sel = np.flatnonzero(mask)
            want, flat = density_brute(x[sel], y[sel], np.ones(len(sel), bool),
                                       bbox, w, h,
                                       None if wts is None else wts[sel])
            v = grid_verdict(got, want, flat, np.ones(len(sel), bool),
                             None if wts is None else wts[sel])
            v.update(grid=name, rows=len(sel), mass=float(got.sum(
                dtype=np.float64)))
            density.append(v)
            if not v["ok"]:
                wrong.append(("density", name))
        # BIN records of the tile query, plain and time-sorted
        rows = np.flatnonzero(tile)
        track = np.array([java_hash(str(i)) for i in ids[rows]], np.int32)
        secs = (ms[rows] // 1000).astype(np.int32)
        label = np.array([c[:8].encode() for c in
                          d["ev_vocab"][d["ev"][rows]]], dtype="S8")
        bins = []
        for sort in (False, True):
            payload = ds.bin_query("gdelt", _tile_ecql(), label="EventCode",
                                   sort=sort)
            rec = np.frombuffer(payload, dtype=[
                ("track", "<i4"), ("secs", "<i4"), ("lat", "<f4"),
                ("lon", "<f4"), ("label", "S8")])
            o = (np.argsort(secs, kind="stable") if sort
                 else np.arange(len(rows)))
            ok = (len(rec) == ds.query_count(_tile_ecql(), "gdelt")
                  == len(rows)
                  and np.array_equal(rec["track"], track[o])
                  and np.array_equal(rec["secs"], secs[o])
                  and np.array_equal(rec["lat"], y[rows][o].astype(np.float32))
                  and np.array_equal(rec["lon"], x[rows][o].astype(np.float32))
                  and np.array_equal(rec["label"], label[o])
                  and (not sort or bool(np.all(np.diff(rec["secs"]) >= 0))))
            bins.append({"sort": sort, "records": len(rec), "exact": bool(ok),
                         "p50_ms": _p50(lambda: ds.bin_query(
                             "gdelt", _tile_ecql(), label="EventCode",
                             sort=sort))})
            if not ok:
                wrong.append(("bin_query", sort))
        surface = surface_queries(ds, d, ids, during)
        vis = visibility_cases(d, ids, during)
    finally:
        kernels.density_grid = real
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = kernels.launches["density_grid"]
    wrong += [("surface", q["query"]) for q in surface if not q["exact"]]
    wrong += [("visibility", v["level"], v["query"], str(v["auths"]))
              for v in vis if not v["exact"]]

    # outside the counted run: every recorded launch against the plain
    # version on the card (unit weights equal, weights within the bound),
    # then the kernel timed at the largest call's shape
    errs = []
    for args in calls:
        xt, yt, wt, mt, xmin, ymin, sx, sy, w, h = args
        got = kernels.density_grid(*args)
        want = kernels.density_grid_plain(*args)
        cells = kernels.density_cells_plain(xt, yt, xmin, ymin, sx, sy, w,
                                            h)[mt]
        diff = (got.double() - want.double()).abs().flatten()
        errs.append(float(diff.max().item()) if diff.numel() else 0.0)
        if wt is None:
            ok = torch.equal(got, want)
        else:
            n_cell = torch.bincount(cells, minlength=w * h).double()
            abs_w = torch.bincount(cells, wt[mt].abs().double(),
                                   minlength=w * h)
            ok = bool((diff <= 2 * n_cell * 2.0**-24 * abs_w).all())
        if not ok:
            wrong.append(("density_grid", xt.shape[0], w, h))
    args = max(calls, key=lambda a: (a[2] is not None, a[0].shape[0]))
    xt, yt, wt, mt, xmin, ymin, sx, sy, w, h = args
    n = xt.shape[0]
    flat = kernels.density_cells_plain(xt, yt, xmin, ymin, sx, sy, w, h)
    vals = torch.where(mt, wt, torch.zeros_like(wt))
    bms, bby = bound_ms(n * 13 + 4 * w * h, 0)
    one_cell = (*args[:8], 1, 1)
    stats = {
        "rows": n, "width": w, "height": h, "weighted": True,
        "max_abs_err": max(errs), "launches": launches,
        "ms": cuda_ms(lambda: kernels.density_grid(*args), 20),
        "plain_ms": cuda_ms(lambda: kernels.density_grid_plain(*args), 3, 1),
        "library_ms": cuda_ms(lambda: torch.zeros(
            w * h, dtype=torch.float32, device=xt.device).index_add_(
                0, flat, vals), 20),
        "bound_ms": bms, "bound_by": bby,
        "one_cell_ms": cuda_ms(lambda: kernels.density_grid(*one_cell), 20),
        "one_cell_bound_ms": bound_ms(n * 13 + 4, 0)[0],
        "one_cell_call_ms": _p50(lambda: ds.density(
            "gdelt", grids[1][1], WORLD, 1, 1, "NumMentions")),
    }
    tile_args = next(a for a in calls if a[2] is None)
    stats["unweighted"] = {
        "rows": tile_args[0].shape[0], "width": tile_args[8],
        "height": tile_args[9],
        "ms": cuda_ms(lambda: kernels.density_grid(*tile_args), 20),
        "bound_ms": bound_ms(tile_args[0].shape[0] * 9
                             + 4 * tile_args[8] * tile_args[9], 0)[0]}
    del calls, args, one_cell, tile_args, xt, yt, wt, mt, flat, vals
    split = {name: density_split(ds, ecql, bbox, w, h, attr)
             for name, ecql, bbox, w, h, attr, _m, _w in grids[:2]}
    for g, (name, ecql, bbox, w, h, attr, _m, _w) in zip(density, grids):
        g["p50_ms"] = (split[name]["call_ms"] if name in split else _p50(
            lambda: ds.density("gdelt", ecql, bbox, w, h, attr)))

    # delete 1,000 ids, then the rebuild and three strategies
    gone = np.random.default_rng(41).choice(len(x), 1000, replace=False)
    keep = np.ones(len(x), dtype=bool)
    keep[gone] = False
    st = ds._types["gdelt"]
    t0 = time.perf_counter()
    ds.delete("gdelt", ids[gone])
    delete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st.ensure_index()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    del st
    by_name = {qn: (e, m) for qn, e, m in queries}
    after = []
    for name, ecql, want in (
            ("z3_tile", _tile_ecql(), tile),
            ("polygon_within", *by_name["multipolygon_within"]),
            ("attr_equality", *by_name["attr_equality_during"])):
        t0 = time.perf_counter()
        res = ds.query(ecql, "gdelt")
        first_ms = (time.perf_counter() - t0) * 1e3
        kept = np.flatnonzero(want & keep)
        ok = (np.array_equal(res.ids, ids[kept])
              and ds.query_count(ecql, "gdelt") == len(kept))
        after.append({"query": name, "hits": len(kept), "exact": bool(ok),
                      "first_ms": first_ms,
                      "strategy": _strategy(res)})
        if not ok:
            wrong.append(("after_delete", name))

    # remove_schema releases the type's device memory
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds.remove_schema("gdelt")
    gc.collect()
    torch.cuda.synchronize()
    removed = {"seconds": time.perf_counter() - t0,
               "allocated_before": before,
               "allocated_after": torch.cuda.memory_allocated(),
               "types_after": ds.get_type_names()}
    if not removed["allocated_after"] < before or removed["types_after"]:
        wrong.append(("remove_schema", before, removed["allocated_after"]))
    emit({"phase": "surface", "density": density, "bin_query": bins,
          "queries": surface, "visibility": vis,
          "delete": {"ids": len(gone), "delete_s": delete_s,
                     "rebuild_s": rebuild_s, "queries": after},
          "remove_schema": removed, "density_split": split,
          "kernels": {"density_grid": stats}, "launches": {
              "density_grid": launches}, "counted_s": main_s,
          "seconds": time.perf_counter() - t_phase, "wrong": wrong})
    if wrong:
        raise SystemExit(f"surface: wrong results: {wrong}")
    if launches == 0:
        raise SystemExit("density_grid never launched on the surface path")
    return {"density_grid": stats}, {"density_grid": launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    del ds
    torch.cuda.empty_cache()
    pred_stats, pred_counts, pred_ds, pred_data, pred_queries = \
        phase_predicates(args.seed, args.store_rows, rows[3])
    launches.update(pred_counts)
    surf_stats, surf_counts = phase_surface(pred_ds, pred_data, rows[3],
                                            pred_queries)
    launches.update(surf_counts)
    pred_stats.update(surf_stats)
    del pred_ds
    torch.cuda.empty_cache()
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
    for name, s in pred_stats.items():   # at the predicates and surface
                                         # paths' shapes
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE_FILES[name],
            "replaces": SOURCES[name], "launches": launches[name],
            **{k: s[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
