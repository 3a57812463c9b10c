"""Package rules of the PyTorch port, and its CUDA kernels on the card.

This file imports no JAX, so the GPU tests can run where JAX is not
installed: ``python -m pytest --noconftest -m gpu tests/test_torch_package.py``.
On a machine without CUDA the ``gpu`` tests skip.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import geomesa_tpu_torch
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan import aggregations, gscan, kernels, residual, zscan

PKG = os.path.dirname(geomesa_tpu_torch.__file__)
MS_DAY = 86_400_000


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, geomesa_tpu_torch, geomesa_tpu_torch.store, "
            "geomesa_tpu_torch.scan.kernels, geomesa_tpu_torch.scan.batcher, "
            "geomesa_tpu_torch.metrics, geomesa_tpu_torch.security, "
            "geomesa_tpu_torch.scan.aggregations, "
            "geomesa_tpu_torch.store.common\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'geomesa_tpu' "
            "or m.startswith('geomesa_tpu.')]\n"
            "print(','.join(bad))")
    root = os.path.dirname(PKG)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_source_imports_jax_or_reference():
    pat = re.compile(r"^\s*(from|import)\s+(jax\b|geomesa_tpu\b(?!_torch))",
                     re.M)
    offenders, seen = [], set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                seen.add(os.path.relpath(path, PKG))
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert offenders == []
    assert {"metrics/__init__.py", "metrics/registry.py",
            "scan/batcher.py", "scan/zscan.py", "scan/residual.py",
            "scan/gscan.py", "index/attr.py",
            "analytics/st_functions.py", "scan/aggregations.py",
            "security/__init__.py", "security/visibility.py",
            "store/common.py"} <= seen


def test_store_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InMemoryDataStore()
    assert InMemoryDataStore(device="cpu").device.type == "cpu"


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _data(n, cap, device, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n) * scale
    y = rng.uniform(-90, 90, n) * scale
    ms = rng.integers(0, 100 * MS_DAY, n)
    return x, y, ms, zscan.build_scan_data(x, y, ms, device, cap=cap)


QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY), (40 * MS_DAY, 41 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("boxes,intervals", QUERIES)
def test_kernels_match_plain(cuda, boxes, intervals):
    _, _, _, d = _data(300_001, 524_288, cuda)
    q = zscan.make_query(boxes, intervals)
    b, t = q.tables(cuda)
    want = kernels.scan_mask_plain(d.cols, d.n, b, t, q.time_any)
    got = kernels.scan_mask(d.cols, d.n, b, t, q.time_any)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[d.n:].any()
    cnt = kernels.scan_count(d.cols, d.n, b, t, q.time_any)
    assert int(cnt.item()) == int(want.sum())
    idx = torch.randint(0, d.n, (70_001,), device=cuda, dtype=torch.int32,
                        generator=torch.Generator(cuda).manual_seed(1))
    got = kernels.scan_mask_gather(d.rows, idx, b, t, q.time_any)
    assert torch.equal(got, kernels.scan_mask_gather_plain(
        d.rows, idx, b, t, q.time_any))


@pytest.fixture(scope="module")
def gather_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return _data(2_000_003, 2**21, torch.device("cuda"), seed=4)[3]


@pytest.mark.gpu
@pytest.mark.parametrize("time_any", [False, True])
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("m", [1, 31, 33, 4097, 1_000_000])
def test_gather_kernel_matches_plain(gather_data, m, order, time_any):
    """The kernel equals the plain version on the gather table, ragged
    edges included, and each call is one launch."""
    d = gather_data
    dev = d.device
    q = zscan.make_query(*QUERIES[1 if time_any else 0])
    b, t = q.tables(dev)
    idx = torch.randint(0, d.n, (m,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(m))
    if order == "sorted":
        idx = torch.sort(idx).values
    want = kernels.scan_mask_gather_plain(d.rows, idx, b, t, time_any)
    kernels.reset_launches()
    got = kernels.scan_mask_gather(d.rows, idx, b, t, time_any)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.launches["scan_mask_gather"] == 1
    with pytest.raises(ValueError, match="int32"):
        kernels.scan_mask_gather(d.rows, idx.long(), b, t, time_any)
    with pytest.raises(ValueError, match="aligned"):
        kernels.scan_mask_gather(d.rows, torch.cat([idx, idx])[1:m + 1], b,
                                 t, time_any)
    flat = torch.zeros(8 * 16 + 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kernels.scan_mask_gather(flat[4:].view(16, 8), idx % 16, b, t,
                                 time_any)


@pytest.mark.gpu
def test_kernels_keep_subnormals(cuda):
    """Built without flush-to-zero: subnormal words compare as numbers."""
    _, _, _, d = _data(100_000, 131_072, cuda, seed=3, scale=1e-42)
    q = zscan.make_query([(-5e-41, -2e-41, 7e-41, 3e-41)], [])
    b, t = q.tables(cuda)
    want = kernels.scan_mask_plain(d.cols, d.n, b, t, True)
    got = kernels.scan_mask(d.cols, d.n, b, t, True)
    assert 0 < int(want.sum()) < d.n
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_plain(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")
    for name in ("scan_mask_plain", "scan_mask_gather_plain",
                 "scan_count_plain", "scan_batch_bits_plain",
                 "compact_bits_plain", "compact_prefix_plain", "_predicate",
                 "_candidates", "pip_mask_plain", "residual_mask_plain",
                 "density_grid_plain", "density_cells_plain"):
        monkeypatch.setattr(kernels, name, refuse)
    x, y, _, d = _data(10_000, 16_384, cuda)
    q = zscan.make_query(*QUERIES[0])
    kernels.reset_launches()
    zscan.scan_mask(d, q)
    zscan.scan_mask_at(d, q, np.arange(0, 10_000, 7))
    zscan.scan_count(d, q)
    zscan.batch_hit_rows(d, zscan.stack_queries(
        [zscan.make_query(*qq) for qq in QUERIES]))
    gscan.points_in_polygon_device(x, y, gscan.pack_polygon(
        parse_wkt(STAR), cuda))
    batch = _attr_batch(10_000)
    residual.device_mask(parse_ecql("age > 5 AND name LIKE 'w0%'"), batch,
                         residual.DeviceColumns(batch, cuda))
    aggregations.density_grid(x, y, np.ones(len(x), bool), (-90, -45, 90, 45),
                              64, 32, device=cuda)
    assert kernels.launches == {"scan_mask": 1, "scan_mask_gather": 1,
                                "scan_count": 1, "scan_batch_bits": 1,
                                "compact_prefix": 1, "compact_bits": 1,
                                "pip_mask": 1, "residual_mask": 1,
                                "density_grid": 1}


@pytest.mark.gpu
def test_store_on_cuda_matches_cpu(cuda, monkeypatch):
    rng = np.random.default_rng(9)
    n = 40_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    ids = [f"f{i}" for i in range(n)]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    q = ("BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
         "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z")
    for host, thr in (("0", "1.0"), ("0", "0")):
        monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", host)
        monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", thr)
        kernels.reset_launches()
        got = stores[0].query(q, "pts")
        assert sum(kernels.launches.values()) == 1
        assert list(got.ids) == list(stores[1].query(q, "pts").ids)


def _batch(count, k_boxes=None, intervals=None, seed=0):
    """``count`` stacked queries: the QUERIES cycled, or ``k_boxes``
    seeded boxes and ``intervals`` intervals each (the split path)."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(count):
        if k_boxes is None:
            qs.append(zscan.make_query(*QUERIES[i % len(QUERIES)]))
            continue
        corners = rng.uniform([-180, -90], [170, 80], (k_boxes, 2))
        boxes = [(x0, y0, x0 + 10, y0 + 10) for x0, y0 in corners]
        ivs = [(j * 5 * MS_DAY, (j * 5 + 3) * MS_DAY) for j in range(intervals)]
        qs.append(zscan.make_query(boxes, ivs))
    return zscan.stack_queries(qs)


def _mixed_batch(count, seed=0):
    """``count`` queries whose own slot counts differ within the batch:
    1 to 4 boxes, and no interval (time-free), one, or three."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(count):
        boxes = []
        for _ in range(1 + i % 4):
            w, h = rng.uniform(5, 120, 2)
            x0, y0 = rng.uniform(-180, 180 - w), rng.uniform(-90, 90 - h)
            boxes.append((x0, y0, x0 + w, y0 + h))
        ivs = [(j * 30 * MS_DAY, (j * 30 + 20) * MS_DAY)
               for j in range((0, 1, 3)[i % 3])]
        qs.append(zscan.make_query(boxes, ivs))
    return zscan.stack_queries(qs)


def _check_batch(d, bq, n_launch=1, every_slot=False):
    """Both batched kernels and the prefix kernel against their plain
    versions on the card, exactly; the bitmap kernel in ``n_launch``
    launches, over each query's own slots (or, with ``every_slot``,
    counts of K boxes and B intervals: the unused NaN and impossible
    slots too)."""
    b, t = bq.tables(d.device)
    c = bq.counts(d.device)
    if every_slot:
        c = torch.tensor([[b.shape[1], t.shape[1]]] * b.shape[0],
                         dtype=torch.int32, device=d.device)
    want_bits, want_parts = kernels.scan_batch_bits_plain(d.cols, d.n, b, t, c)
    kernels.reset_launches()
    bits, parts = kernels.scan_batch_bits(d.cols, d.n, b, t, c)
    torch.cuda.synchronize()
    assert kernels.launches["scan_batch_bits"] == n_launch
    assert torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
    offsets, totals = kernels.compact_prefix(parts)
    torch.cuda.synchronize()
    want_offsets, want_totals = kernels.compact_prefix_plain(want_parts)
    assert torch.equal(offsets, want_offsets) and torch.equal(totals,
                                                              want_totals)
    kernels.reset_launches()
    *ids, counts = kernels.compact_bits(bits, parts)
    torch.cuda.synchronize()
    *want, want_counts = kernels.compact_bits_plain(want_bits, want_parts)
    assert np.array_equal(counts, want_counts)
    for got, exp in zip(ids, want):
        assert torch.equal(got, exp)
    assert kernels.launches["compact_prefix"] == (1 if d.cap else 0)
    assert kernels.launches["compact_bits"] == (1 if sum(map(len, want)) else 0)
    return want


BATCH_N = [0, 1, 3, 5, 31, 33, 2047, 2049, 4097, 1_000_000, 2**20 - 1]


@pytest.fixture(scope="module")
def batch_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    out = {}
    for n in BATCH_N:
        # capacity padding beyond n, and a capacity off a word boundary;
        # the last case is n = cap - 1 at a power-of-two capacity
        cap = n + 1 if n == 2**20 - 1 else max(n + 77, 64)
        out[n] = _data(n, cap, torch.device("cuda"), seed=n)[3]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1, 2, 3, 32, 64])
@pytest.mark.parametrize("n", BATCH_N)
def test_batch_kernels_match_plain(batch_data, n, count):
    """Qp = 1, 2, 3, 32 in one launch; 64 in two (32 queries per
    launch)."""
    d = batch_data[n]
    bq = _batch(count)
    hits, cands = _check_batch(d, bq, -(-count // 32))
    if n == 1_000_000:
        assert len(hits) > 0
    if count == 1:
        # a batch of one through scan_mask_batch is the scalar dense mask
        q = zscan.make_query(*QUERIES[0])
        assert torch.equal(zscan.scan_mask_batch(d, bq)[0],
                           zscan.scan_mask(d, q))


@pytest.mark.gpu
@pytest.mark.parametrize("every_slot", [False, True])
@pytest.mark.parametrize("count", [3, 32, 64])
@pytest.mark.parametrize("n", [5, 2049, 1_000_000])
def test_batch_kernels_own_slots(batch_data, n, count, every_slot):
    """Queries with 1 to 4 boxes, time-free, one or three intervals in
    one launch: the kernel over each query's own slots, and with counts
    that take in every padded slot, equals the plain version."""
    hits, _ = _check_batch(batch_data[n], _mixed_batch(count, seed=count),
                           -(-count // 32), every_slot)
    if n == 1_000_000:
        assert len(hits) > 0


def _boundary_case(device):
    """Rows on the bounds of four boxes: on each bound's hi word with
    the lo word below, equal to and above the bound's lo word, on the hi
    word alone, and at +0.0 and -0.0 against zero bounds (one box has
    bounds at +0.0, one at -0.0); then the queries, each with its own
    box, the last two over two boxes and two intervals."""
    boxes = [(-10.3, 5.7, 20.1, 30.9), (0.0, 0.0, 12.5, 7.25),
             (-0.0, -0.0, 3.0, 3.0), (-3.0, -3.0, -0.0, -0.0)]
    qs = [zscan.make_query([bx], []) for bx in boxes]
    qs.append(zscan.make_query(boxes[:2], [(0, 10 * MS_DAY),
                                           (20 * MS_DAY, 30 * MS_DAY)]))
    qs.append(zscan.make_query(boxes[2:], [(5 * MS_DAY, 5 * MS_DAY),
                                           (6 * MS_DAY, 90 * MS_DAY)]))
    xs, ys = [], []
    for x0, y0, x1, y1 in boxes:
        mid_x, mid_y = (x0 + x1) / 2, (y0 + y1) / 2
        for v, on_x in ((x0, True), (x1, True), (y0, False), (y1, False)):
            hi, lo = zscan.split_two_float(np.float64(v))
            for dlo in (-1, 0, 1, None):
                if dlo is None:
                    pair = (hi, np.float32(0))
                else:
                    pair = (hi, np.nextafter(lo, np.float32(dlo * np.inf))
                            if dlo else lo)
                xs.append(pair if on_x else
                          zscan.split_two_float(np.float64(mid_x)))
                ys.append(zscan.split_two_float(np.float64(mid_y))
                          if on_x else pair)
    for z in (0.0, -0.0):
        for w in (0.0, -0.0, 1.0, -1.0):
            xs += [(np.float32(z), np.float32(0)), (np.float32(w),
                                                    np.float32(0))]
            ys += [(np.float32(w), np.float32(0)), (np.float32(z),
                                                    np.float32(0))]
    n = len(xs)
    reps = 41   # the rows again at every offset of a thread's eight rows
    xy = np.array([[a, b, c, e] for (a, b), (c, e) in zip(xs, ys)],
                  dtype=np.float32)
    xy = np.tile(xy, (reps, 1))
    rng = np.random.default_rng(2)
    days = rng.integers(0, 40, len(xy)).astype(np.int32)
    msd = rng.integers(0, MS_DAY, len(xy)).astype(np.int32)
    msd[::5] = 0
    msd[1::5] = MS_DAY - 1
    data = zscan.scan_data_from_numpy(
        *(np.ascontiguousarray(xy[:, j]) for j in range(4)), days, msd,
        len(xy), device)
    assert n * reps == data.n
    return data, zscan.stack_queries(qs)


@pytest.mark.gpu
def test_batch_kernels_exact_on_bounds(cuda):
    """Rows on each bound's hi word and hi + lo pair, and +-0.0 in bounds
    and coordinates: the bitmaps equal the plain version's bit for bit,
    and every box has candidate rows."""
    d, bq = _boundary_case(cuda)
    hits, cands = _check_batch(d, bq)
    per_query = kernels.compact_bits_plain(
        *kernels.scan_batch_bits_plain(d.cols, d.n, *bq.tables(cuda),
                                       bq.counts(cuda)))[2]
    assert (per_query[1] > 0).all() and (per_query[0] > 0).all()


@pytest.mark.gpu
def test_compact_prefix_past_int32(cuda):
    """Synthetic partials (no bitmaps) whose totals over the queries pass
    2^31: int32 offsets within each query, int64 totals, and the int64
    bases (the prefix of the totals) exact."""
    qp, nb = 64, 32_768
    parts = torch.full((2, qp, nb), 2048, dtype=torch.int32, device=cuda)
    parts[:, :, 7::13] = 5
    parts[1, 3] = 0
    offsets, totals = kernels.compact_prefix(parts)
    want_offsets, want_totals = kernels.compact_prefix_plain(parts.cpu())
    assert torch.equal(offsets.cpu(), want_offsets)
    assert torch.equal(totals.cpu(), want_totals)
    host = parts.cpu().numpy().astype(np.int64)
    assert np.array_equal(totals.cpu().numpy(), host.sum(axis=2))
    bases = np.cumsum(totals.cpu().numpy(), axis=1) - totals.cpu().numpy()
    assert bases[0, -1] > 2**31 and bases[1, -1] > 2**31
    assert np.array_equal(bases, np.cumsum(host.sum(axis=2), axis=1)
                          - host.sum(axis=2))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [33, 2049, 1_000_000, 2**20 - 1])
def test_compact_empty_and_full_bitmaps(batch_data, n):
    """A query that matches every row (every bit up to n set) and one
    that matches none, and a batch of only the empty one."""
    d = batch_data[n]
    full = zscan.make_query([(-180.0, -90.0, 180.0, 90.0)], [])
    empty = zscan.make_query([(10.0, 10.0, 10.5, 10.5)],
                             [(200 * MS_DAY, 300 * MS_DAY)])
    hits, _ = _check_batch(d, zscan.stack_queries([full, empty, full]))
    assert len(hits) == 2 * d.n
    hits, cands = _check_batch(d, zscan.stack_queries([empty]))
    assert len(hits) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1024, 1030])
def test_batch_kernels_many_queries(batch_data, count):
    """Batches of over a thousand queries: each compaction warp sums a
    query's base from 1024 or more totals."""
    hits, _ = _check_batch(batch_data[2049], _mixed_batch(count, seed=5),
                           -(-count // 32))
    assert len(hits) > 0


@pytest.mark.gpu
def test_store_batched_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(19)
    n = 40_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    ids = [f"f{i}" for i in range(n)]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    qs = ["BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
          "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z",
          "BBOX(geom, -10, -10, 10, 10)",
          "(BBOX(geom, 0, 0, 30, 20) OR BBOX(geom, 100, -50, 140, -10)) AND "
          "dtg DURING 2020-01-05T00:00:00Z/2020-03-01T00:00:00Z"]
    stores[0].query(qs[0], "pts")   # builds the index
    kernels.reset_launches()
    got = stores[0].query_batched([Query("pts", q) for q in qs])
    assert kernels.launches["scan_batch_bits"] == 1
    assert kernels.launches["compact_bits"] == 1
    want = stores[1].query_batched([Query("pts", q) for q in qs])
    for g, w, q in zip(got, want, qs):
        assert "Fused device scan" in g.explain.text
        assert list(g.ids) == list(w.ids) == list(stores[1].query(q, "pts").ids)


@pytest.mark.gpu
def test_batch_kernels_split_wide_tables(batch_data):
    """Tables past the shared memory of one launch run as several
    launches over query groups, and still equal the plain version."""
    bq = _batch(32, k_boxes=64, intervals=8)
    b, t = bq.tables("cuda")
    group = kernels._batch_group(b, t)
    assert b.numel() * 4 + t.numel() * 4 > kernels.MAX_TABLE_BYTES
    hits, _ = _check_batch(batch_data[1_000_000], bq, -(-32 // group))
    assert len(hits) > 0


@pytest.mark.gpu
def test_batch_kernels_keep_subnormals(cuda):
    _, _, _, d = _data(100_000, 131_072, cuda, seed=3, scale=1e-42)
    bq = zscan.stack_queries([
        zscan.make_query([(-5e-41, -2e-41, 7e-41, 3e-41)], []),
        zscan.make_query([(0.0, 0.0, 2e-41, 2e-41)], [(0, 50 * MS_DAY)])])
    hits, _ = _check_batch(d, bq)
    assert 0 < len(hits) < 2 * d.n


# -- the predicate kernels (csrc/geom.cu, csrc/residual.cu) ------------------

def _star(cx, cy, r1, r2, k):
    a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
    r = np.where(np.arange(2 * k) % 2 == 0, r1, r2)
    pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a)]
    pts = np.vstack([pts, pts[:1]])
    return "POLYGON((" + ", ".join(f"{float(x)!r} {float(y)!r}"
                                   for x, y in pts) + "))"


STAR = _star(-20.5, 10.25, 60, 25, 9)
# 2,400 edges: the kernel walks three shared-memory tiles
BIG_STAR = _star(3.0, -4.0, 70, 30, 1200)
HOLED = ("POLYGON((-120 -60, 120 -60, 120 60, -120 60, -120 -60), "
         "(-30 -30, 30 -30, 30 30, -30 30, -30 -30))")
MULTI = ("MULTIPOLYGON(((-100 -50, -20 -50, -20 20, -100 20, -100 -50)), "
         "((20 0, 90 0, 90 70, 20 70, 20 0), (40 20, 60 20, 60 40, 40 40, "
         "40 20)))")
ATTR_SPEC = ("name:String,age:Integer,big:Long,score:Double,flag:Boolean,"
             "dtg:Date,*geom:Point:srid=4326")


def _attr_batch(n, seed=6):
    rng = np.random.default_rng(seed)
    names = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    name = names[rng.integers(0, 40, n)]
    name[::29] = None
    age = rng.integers(0, 100, n).astype(object)
    age[::31] = None
    score = rng.uniform(0, 1, n)
    score[::17] = np.nan
    score[3::23] = 0.25
    score[4::23] = np.nextafter(0.25, 1)
    return FeatureBatch.from_dict(parse_spec("t", ATTR_SPEC),
                                  [f"f{i}" for i in range(n)], {
        "name": name, "age": age, "big": rng.integers(-(2**40), 2**40, n),
        "score": score, "flag": rng.integers(0, 2, n).astype(bool),
        "dtg": 1_609_459_200_000 + rng.integers(0, 300 * MS_DAY, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


RESIDUAL_FILTERS = [
    "name = 'w007'", "name <> 'w007'", "name < 'w010'", "name >= 'w035'",
    "name IN ('w001', 'w002', 'nope')", "name LIKE 'w00%'",
    "name ILIKE 'W01_'", "name IS NULL", "NOT (name = 'w007')",
    "age = 41", "age <> 41.5", "age BETWEEN 19.5 AND 30.5",
    "age IN (" + ", ".join(str(i) for i in range(300)) + ")", "age IS NULL",
    "big > -3", "big <= 1099511627776", "big BETWEEN -5000000000 AND 7",
    "score < 0.25 OR score > 0.9", "score = 0.25", "score <> 0.25",
    "NOT (score >= 0.25)", "score IS NULL", "flag = true", "flag <> 0.5",
    "dtg DURING 2021-03-01T00:00:00Z/2021-04-01T00:00:00Z",
    "dtg BEFORE 2021-02-01T00:00:00Z OR dtg TEQUALS 2021-05-01T00:00:00Z",
    "age > 50 AND name = 'w002' AND score <= 0.5 AND flag = false",
    "EXCLUDE OR (INCLUDE AND big < 0)",
]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 17, 255, 257, 1_000_003])
def test_residual_kernel_matches_plain(cuda, n):
    """Every leaf kind and the band bit, byte for byte against the plain
    version on the same device columns."""
    batch = _attr_batch(n)
    cols = residual.DeviceColumns(batch, cuda)
    for ecql in RESIDUAL_FILTERS:
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        kernels.reset_launches()
        got = prog.run(cols, n)
        torch.cuda.synchronize()
        assert kernels.launches["residual_mask"] == 1
        slots = [cols.get(name)["slot"] for name in prog.slots]
        want = kernels.residual_mask_plain(
            *(torch.from_numpy(a).to(cuda)
              for a in (prog.code, prog.consts, prog.table)), slots, n)
        assert torch.equal(got, want), ecql


@pytest.mark.gpu
@pytest.mark.parametrize("wkt", [STAR, BIG_STAR, HOLED, MULTI])
@pytest.mark.parametrize("n", [1, 257, 300_001])
def test_pip_kernel_matches_plain(cuda, wkt, n):
    """inside and band bit for bit against the plain version, with
    points on vertices and edges among uniform ones."""
    rng = np.random.default_rng(n)
    poly = parse_wkt(wkt)
    px, py = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    on = np.vstack(poly.coords_list())[:n]
    px[:len(on)], py[:len(on)] = on[:, 0], on[:, 1]
    edges = gscan.pack_polygon(poly, cuda).edges
    x32, y32 = (torch.from_numpy(a).to(cuda) for a in gscan.pip_points(px, py))
    kernels.reset_launches()
    got = kernels.pip_mask(x32, y32, edges, gscan.EDGE_EPS2)
    torch.cuda.synchronize()
    assert kernels.launches["pip_mask"] == 1
    want = kernels.pip_mask_plain(x32, y32, edges, gscan.EDGE_EPS2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n > 1000:
        assert 0 < int(got[0].sum()) < n and int(got[1].sum()) > 0


@pytest.mark.gpu
def test_predicate_wrappers_raise_on_cuda(cuda):
    """On CUDA tensors a wrapper launches or raises; it never falls back
    to its plain version."""
    e = gscan.pack_polygon(parse_wkt(STAR), cuda).edges
    x = torch.zeros(8, dtype=torch.float32, device=cuda)
    flat = torch.zeros(4 * 9, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kernels.pip_mask(x, x, flat[1:33].view(8, 4), gscan.EDGE_EPS2)
    with pytest.raises(ValueError, match="devices"):
        kernels.pip_mask(x, x, e.cpu(), gscan.EDGE_EPS2)
    batch = _attr_batch(100)
    cols = residual.DeviceColumns(batch, cuda)
    prog = residual.compile_program(parse_ecql("age > 5"), batch, cols)
    # the program is host data; the columns share one device
    with pytest.raises(ValueError, match="host"):
        kernels.residual_mask(*(torch.from_numpy(a).to(cuda) for a in
                                (prog.code, prog.consts, prog.table)),
                              [cols.get("age")["slot"]], 100)
    age = cols.get("age")["slot"]
    with pytest.raises(ValueError, match="devices"):
        kernels.residual_mask(
            *(torch.from_numpy(a) for a in (prog.code, prog.consts,
                                            prog.table)),
            [(age[0], age[1].cpu(), age[2])], 100)


@pytest.mark.gpu
def test_store_predicates_on_cuda_match_cpu(cuda):
    """The predicate path on the card, through both kernels, equals the
    same store on the CPU id for id."""
    batch = _attr_batch(60_000, seed=11)
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("t", ATTR_SPEC.replace("age:Integer",
                                               "age:Integer:index=true"))
        s.write("t", FeatureBatch(s.get_schema("t"), batch.ids,
                                  batch.columns))
    qs = [f"INTERSECTS(geom, {STAR}) AND dtg DURING "
          f"2021-02-01T00:00:00Z/2021-09-01T00:00:00Z",
          f"WITHIN(geom, {MULTI})", f"INTERSECTS(geom, {HOLED}) AND "
          f"score < 0.5",
          "score = 0.25 OR (name LIKE 'w01%' AND big > -3)",
          "BBOX(geom, -179, -89, 179, 89) AND NOT (name IN ('w001'))",
          "age >= 2", "IN ('f1', 'f77')"]
    kernels.reset_launches()
    for q in qs:
        assert list(stores[0].query(q, "t").ids) == \
            list(stores[1].query(q, "t").ids), q
    assert kernels.launches["pip_mask"] >= 3
    assert kernels.launches["residual_mask"] >= 3


# -- the redesigned predicate kernels: edges of the skip, tails, limits -------

def _adversarial_points(edges, n_random, seed):
    """Points on every vertex and edge midpoint, one ulp either side of
    each edge's expanded box (the kernel's skip margin) beside its ends
    and middle, seeded ones around the edges, and NaN, infinite and huge
    ones."""
    lox, hix, loy, hiy = (t.numpy() for t in kernels.pip_edge_terms_plain(
        torch.from_numpy(edges), gscan.EDGE_EPS2))
    x0, y0, x1, y1 = edges.T
    xs, ys = [x0, x1, (x0 + x1) / 2], [y0, y1, (y0 + y1) / 2]
    px, py = list(xs), list(ys)
    for lo, hi, along, other in ((lox, hix, px, py), (loy, hiy, py, px)):
        for bound, inward in ((lo, np.inf), (hi, -np.inf)):
            for at in (np.nextafter(bound, -inward), bound,
                       np.nextafter(bound, inward)):
                for c in (ys if along is px else xs):
                    along.append(at)
                    other.append(c)
    rng = np.random.default_rng(seed)
    scale = np.abs(edges).max()
    px.append(rng.uniform(-1, 1, n_random) * scale)
    py.append(rng.uniform(-1, 1, n_random) * scale)
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, 3e38, 2.0**61])
    sx, sy = np.meshgrid(special, special)
    px.append(sx.ravel())
    py.append(sy.ravel())
    return (np.concatenate(px).astype(np.float32),
            np.concatenate(py).astype(np.float32))


ODD_EDGES = np.array([[-180.0, 10.0, 180.0, 10.5], [180.0, -3.0, -180.0, -3.0],
                      [5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 0.0, 0.0],
                      [1e-3, 2e-3, 1.0001e-3, 2e-3],
                      [-7.25, 1e-30, -7.25, -1e-30],
                      [-9.0e5, 4.0e5, 1.0e6, -6.0e5]], dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("wkt", [STAR, HOLED, MULTI, "odd", "5000"])
def test_pip_kernel_skip_margins_match_plain(cuda, wkt):
    """inside and band bit for bit against the plain version on points at
    the skip's margins, NaN, ±inf and huge points, horizontal,
    zero-length, 360-degree and 1e6-scale edges, and 5,000 edges (ten
    shared tiles); every n from 1 to past the points of one block, none
    a multiple of the points per thread."""
    if wkt == "odd":
        edges = ODD_EDGES
    elif wkt == "5000":
        edges = gscan.pack_polygon(parse_wkt(_star(1.0, 2.0, 80, 35, 2500)),
                                   "cpu").edges.numpy()
    else:
        edges = gscan.pack_polygon(parse_wkt(wkt), "cpu").edges.numpy()
    px, py = _adversarial_points(edges, 20_000, seed=len(edges))
    e = torch.from_numpy(edges).to(cuda)
    for n in (1, 3, 1023, 1025, 4097, len(px)):
        x = torch.from_numpy(px[-n:].copy()).to(cuda)
        y = torch.from_numpy(py[-n:].copy()).to(cuda)
        got = kernels.pip_mask(x, y, e, gscan.EDGE_EPS2)
        want = kernels.pip_mask_plain(x, y, e, gscan.EDGE_EPS2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n


INF_SPEC = "v:Double,w:Float,dtg:Date,*geom:Point:srid=4326"
INF_FILTERS = ["v = 1e300", "v > 1e299", "v > 1e308", "v < -1e308",
               "w > 3.5e38", "w < -3.5e38", "v = 1e309", "v < 1e309",
               "v >= 1e309", "v <> 1e309", "v > -1e309", "v <= -1e309",
               "w = 1e309", "v IN (1e309, -1e309, 1e300)"]


def _inf_batch(n):
    rng = np.random.default_rng(9)
    v = rng.uniform(-1e3, 1e3, n)
    v[::7], v[1::7] = np.inf, -np.inf
    v[2::11] = np.nan
    v[3::13], v[4::13] = 1e300, -1e300
    v[5::17], v[6::17] = 1e308, 3.5e38
    w = np.round(rng.uniform(-2, 2, n), 2)
    w[::5], w[1::9] = np.inf, -np.inf
    w[2::11] = np.nan
    w[3::7], w[4::7] = 3.6e38, -3.6e38
    return FeatureBatch.from_dict(parse_spec("t", INF_SPEC),
                                  [f"f{i}" for i in range(n)], {
        "v": v, "w": w,
        "dtg": 1_609_459_200_000 + rng.integers(0, 10**9, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


@pytest.mark.gpu
def test_residual_infinities_on_cuda(cuda):
    """±inf, NaN and values past the f32 range: the kernel equals its
    plain version byte for byte, and the store on the card returns the
    host evaluator's ids (the ±inf repair)."""
    from geomesa_tpu_torch.filters import evaluate
    batch = _inf_batch(20_011)
    cols = residual.DeviceColumns(batch, cuda)
    ds = InMemoryDataStore()
    ds.create_schema("t", INF_SPEC)
    ds.write("t", FeatureBatch(ds.get_schema("t"), batch.ids, batch.columns))
    for ecql in INF_FILTERS:
        f = parse_ecql(ecql)
        prog = residual.compile_program(f, batch, cols)
        got = prog.run(cols, batch.n)
        want = kernels.residual_mask_plain(
            *(torch.from_numpy(a) for a in (prog.code, prog.consts,
                                            prog.table)),
            [cols.get(name)["slot"] for name in prog.slots], batch.n)
        assert torch.equal(got, want), ecql
        truth = evaluate(f, batch)
        assert np.array_equal(residual.device_mask(f, batch, cols), truth)
        assert np.array_equal(ds.query(ecql, "t").rows,
                              np.flatnonzero(truth)), ecql


@pytest.mark.gpu
def test_residual_long_programs_match_plain(cuda):
    """Long programs (an IN of 48 values, 33 thresholds, ten vocab
    tables) and a short one run from device memory, byte for byte as
    the plain version."""
    n = 100_003
    batch = _attr_batch(n)
    cols = residual.DeviceColumns(batch, cuda)
    long_in = "age IN (" + ", ".join(str(i) for i in range(48)) + ")"
    many = " OR ".join(f"score = 0.{i:03d}" for i in range(33))
    tables = " OR ".join(f"name LIKE 'w{i}%'" for i in range(10))
    for ecql in ("age > 5 AND name LIKE 'w0%'", long_in, many, tables):
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        args = [torch.from_numpy(a) for a in (prog.code, prog.consts,
                                              prog.table)]
        slots = [cols.get(name)["slot"] for name in prog.slots]
        got = kernels.residual_mask(*args, slots, n)
        assert torch.equal(got, kernels.residual_mask_plain(*args, slots, n))


@pytest.mark.gpu
def test_residual_refuses_misaligned_columns(cuda):
    """The kernel reads 16-byte vectors: a column view that is not
    16-byte aligned raises; it does not fall back."""
    batch = _attr_batch(1_000)
    cols = residual.DeviceColumns(batch, cuda)
    prog = residual.compile_program(parse_ecql("age > 5"), batch, cols)
    hi, lo, valid = cols.get("age")["slot"]
    shifted = (hi[1:], lo[1:], valid[1:])
    with pytest.raises(ValueError, match="aligned"):
        kernels.residual_mask(*(torch.from_numpy(a) for a in
                                (prog.code, prog.consts, prog.table)),
                              [shifted], 999)


# -- the density kernel --------------------------------------------------------

def _density_inputs(n, bbox, weights, device, seed=0):
    """``n`` seeded points around ``bbox`` (a tenth outside each side,
    some on xmax/ymax, the first ones at +-1e30, +-inf and NaN), a
    mask of about nine in ten, and unit (None), integer or fractional
    weights, as the kernel's tensors on ``device``."""
    rng = np.random.default_rng(seed + n)
    xmin, ymin, xmax, ymax = bbox
    wx, wy = max(xmax - xmin, 1.0), max(ymax - ymin, 1.0)
    x = rng.uniform(xmin - 0.2 * wx, xmax + 0.2 * wx, n)
    y = rng.uniform(ymin - 0.2 * wy, ymax + 0.2 * wy, n)
    x[n // 3:n // 3 + n // 20] = xmax
    y[n // 2:n // 2 + n // 20] = ymax
    special = [1e30, -1e30, np.inf, -np.inf, np.nan]
    x[:min(n, 5)] = special[:min(n, 5)]
    y[5:min(n, 10)] = special[:max(0, min(n, 10) - 5)]
    mask = rng.random(n) < 0.9
    w = {"unit": None,
         "integer": rng.integers(-100, 1000, n).astype(np.float32),
         "fractional": rng.uniform(-3.0, 7.0, n).astype(np.float32)}[weights]
    xt, yt, wt, mt = aggregations.density_upload(x, y, mask, w, device)
    return (xt, yt, wt, mt, *aggregations.density_scalars(
        bbox, 1, 1)[:2])


def _density_check(xt, yt, wt, mt, bbox, width, height, exact):
    """The kernel against its plain version on the same device tensors:
    equal with unit weights; with ``exact`` integer weights, equal on
    every cell whose sum |w| is under 2^24 (every partial sum an exact
    f32 integer); else each cell within 2 * n_cell * 2^-24 * sum |w|."""
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    kernels.reset_launches()
    got = kernels.density_grid(xt, yt, wt, mt, xmin, ymin, sx, sy, width,
                               height)
    torch.cuda.synchronize()
    assert kernels.launches["density_grid"] == (1 if xt.shape[0] else 0)
    want = kernels.density_grid_plain(xt, yt, wt, mt, xmin, ymin, sx, sy,
                                      width, height)
    if wt is None:
        assert torch.equal(got, want)
        return got
    cells = kernels.density_cells_plain(xt, yt, xmin, ymin, sx, sy, width,
                                        height)[mt]
    n_cell = torch.bincount(cells, minlength=width * height).double()
    abs_w = torch.bincount(cells, wt[mt].abs().double(),
                           minlength=width * height)
    bound = (2 * n_cell * 2.0**-24 * abs_w).view(height, width)
    diff = (got.double() - want.double()).abs()
    if exact:
        small = (abs_w < 2**24).view(height, width)
        assert bool((diff[small] == 0).all())
        bound = torch.where(small, torch.zeros_like(bound), bound)
    assert bool((diff <= bound).all())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["unit", "integer", "fractional"])
@pytest.mark.parametrize("width,height", [(1, 1), (256, 256), (2048, 1024)])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 4097, 1_000_000])
def test_density_kernel_matches_plain(cuda, n, width, height, weights):
    bbox = (-30.0, -20.0, 50.0, 40.0)
    xt, yt, wt, mt, _, _ = _density_inputs(n, bbox, weights, cuda)
    _density_check(xt, yt, wt, mt, bbox, width, height, weights != "fractional")


@pytest.mark.gpu
@pytest.mark.parametrize("bbox", [(3.0, 3.0, 3.0, 3.0), (0.0, 5.0, 0.0, 9.0),
                                  (-1e-3, 7.0, 2e-3, 7.000001),
                                  (-180.0, -90.0, 180.0, 90.0)])
@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_density_kernel_degenerate_and_huge(cuda, bbox, weights):
    """Degenerate bboxes (a scale of 0: inf * 0 is NaN, read as 0), tiny
    ones, and points at +-1e30, +-inf and NaN, exactly."""
    xt, yt, wt, mt, _, _ = _density_inputs(100_003, bbox, weights, cuda, 7)
    _density_check(xt, yt, wt, mt, bbox, 300, 200, True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 1_000_000])
def test_density_kernel_every_row_in_one_cell(cuda, n):
    x = torch.full((n,), 2.5, device=cuda)
    y = torch.full((n,), -1.25, device=cuda)
    m = torch.ones(n, dtype=torch.bool, device=cuda)
    got = _density_check(x, y, None, m, (0, -2, 4, 0), 8, 8, True)
    assert int(got.max().item()) == n


@pytest.mark.gpu
def test_density_wrapper_raises_on_cuda(cuda):
    x = torch.zeros(64, device=cuda)
    m = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        kernels.density_grid(x, x.cpu(), None, m, 0, 0, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="devices"):
        kernels.density_grid(x, x, None, m.cpu(), 0, 0, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="aligned"):
        kernels.density_grid(x[1:33], x[:32], None, m[:32], 0, 0, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="aligned"):
        kernels.density_grid(x[:32], x[:32], None, m[1:33], 0, 0, 1, 1, 4, 4)


@pytest.mark.gpu
def test_store_density_and_bin_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(13)
    n = 60_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    x[::101] = np.nan
    ms = 1_577_836_800_000 + rng.integers(0, 60 * MS_DAY, n)
    wt = rng.integers(0, 50, n)
    tone = rng.uniform(-10, 10, n)
    tone[::37] = np.nan
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "code:String,wt:Integer,tone:Double,"
                        "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", [f"f{i}" for i in range(n)], {
            "code": [f"c{i % 23}" for i in range(n)], "wt": wt, "tone": tone,
            "dtg": ms, "geom": (x, y)})
    ecql = ("BBOX(geom, -100, -50, 60, 70) AND dtg DURING "
            "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z")
    for attr in (None, "wt"):
        kernels.reset_launches()
        got = stores[0].density("pts", ecql, (-100, -50, 60, 70), 640, 480,
                                attr)
        assert kernels.launches["density_grid"] == 1
        assert np.array_equal(got, stores[1].density(
            "pts", ecql, (-100, -50, 60, 70), 640, 480, attr))
    got = stores[0].density("pts", "INCLUDE", (-180, -90, 180, 90), 37, 19,
                            "tone")
    want = stores[1].density("pts", "INCLUDE", (-180, -90, 180, 90), 37, 19,
                             "tone")
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= 2 * n * 2.0**-24 * np.nansum(np.abs(tone)))
    for kw in ({}, {"sort": True, "label": "code"}):
        assert stores[0].bin_query("pts", ecql, **kw) == stores[1].bin_query(
            "pts", ecql, **kw)


@pytest.mark.gpu
def test_store_residual_after_delete_on_cuda(cuda):
    """The residual kernel's prepared launches are keyed on column
    pointers; after a delete, and after remove_schema + create_schema of
    the same name, the columns are uploaded again (possibly at the same
    addresses). The CUDA store still answers as the CPU store does."""
    ecqls = ["BBOX(geom, -170, -80, 170, 80) AND age > 30",
             "age >= 10 AND score < 0.5 AND name LIKE 'w0%'"]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema(parse_spec("t", ATTR_SPEC))
        s.write("t", _attr_batch(50_000))

    def same():
        for e in ecqls:
            kernels.reset_launches()
            got = stores[0].query(e, "t")
            assert kernels.launches["residual_mask"] >= 1
            assert list(got.ids) == list(stores[1].query(e, "t").ids)
    same()
    for s in stores:
        s.delete("t", [f"f{i}" for i in range(0, 50_000, 7)])
    same()
    for s in stores:
        s.remove_schema("t")
        s.create_schema(parse_spec("t", ATTR_SPEC))
        s.write("t", _attr_batch(50_000, seed=8))
    same()
