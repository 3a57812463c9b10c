"""The port's scan layer against the JAX reference on the CPU.

The same device columns (the reference's DeviceScanData, fetched as
numpy and carried across with scan_data_from_numpy) go through the
port's plain scan functions and through the reference's XLA scan
(zscan.scan_mask / scan_mask_at) and Pallas kernels (interpret mode).
Tolerance: exact. The predicate is a pure comparison of identical
f32/i32 words, so masks, row sets and counts must be equal.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.scan import pallas_scan as jpallas
from geomesa_tpu.scan import zscan as jzscan
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.index.zkeys import ZKeyIndex
from geomesa_tpu_torch.scan import kernels
from geomesa_tpu_torch.scan import zscan as tzscan

MS_DAY = 86_400_000

QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),                      # no time
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],                         # 3 boxes -> pad 4
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),   # whole world
]


def _carry(d, device="cpu"):
    """The reference's device columns as the port's ScanData."""
    return tzscan.scan_data_from_numpy(
        *(np.asarray(a) for a in (d.xhi, d.xlo, d.yhi, d.ylo, d.tday, d.tms)),
        d.n, device)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n = 300_001
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(0, 100 * MS_DAY, n).astype(np.int64)
    jd = jzscan.build_scan_data(x, y, ms)
    return x, y, ms, jd, _carry(jd), jpallas.build_pallas_data(x, y, ms)


@pytest.mark.parametrize("boxes,intervals", QUERIES)
def test_mask_matches_xla_and_pallas(data, boxes, intervals):
    _, _, _, jd, td, pd = data
    got = tzscan.scan_mask(td, tzscan.make_query(boxes, intervals)).numpy()
    jq = jzscan.make_query(boxes, intervals)
    assert np.array_equal(got, np.asarray(jzscan.scan_mask(jd, jq)))
    assert np.array_equal(got, jpallas.pallas_scan_mask(pd, jq))


@pytest.mark.parametrize("boxes,intervals", QUERIES)
def test_count_matches_pallas(data, boxes, intervals):
    _, _, _, _, td, pd = data
    got = tzscan.scan_count(td, tzscan.make_query(boxes, intervals))
    want = jpallas.pallas_scan_count(pd, jzscan.make_query(boxes, intervals))
    assert got == want


def _gather_ids(order, data, boxes, intervals):
    """int32 row ids: distinct in random order, heavily repeated, or the
    z-index's candidates in its z-order (as the store's gathered tier
    gets them)."""
    x, y, ms, jd, _, _ = data
    rng = np.random.default_rng(7)
    if order == "random":
        return rng.choice(jd.n, 20_001, replace=False).astype(np.int32)
    if order == "repeated":
        pool = rng.choice(jd.n, 2_000).astype(np.int32)
        return pool[rng.integers(0, len(pool), 20_001)]
    index = "z3" if intervals else "z2"
    kind, rows = ZKeyIndex(x, y, ms).query_rows(index, boxes, intervals,
                                                0, jd.n)
    assert kind == "candidates" and rows.dtype == np.int32
    return rows


@pytest.mark.parametrize("order", ["random", "repeated", "zorder"])
@pytest.mark.parametrize("boxes,intervals", QUERIES)
def test_gathered_matches_xla(data, boxes, intervals, order):
    _, _, _, jd, td, _ = data
    rows = _gather_ids(order, data, boxes, intervals)
    got = tzscan.scan_mask_at(td, tzscan.make_query(boxes, intervals), rows)
    want = jzscan.scan_mask_at(jd, jzscan.make_query(boxes, intervals), rows)
    assert got.shape == (len(rows),)
    assert np.array_equal(got, want)


def _interleaved(td):
    """The gather table the columns imply: their int32 words in row
    order, then two zero words."""
    words = [c.numpy().view(np.int32) for c in td.cols]
    zero = np.zeros(td.cap, dtype=np.int32)
    return np.stack(words + [zero, zero], axis=1)


@pytest.mark.parametrize("path", ["build", "extend", "rebuild",
                                  "from_numpy"])
def test_rows_table_interleaves_columns(data, path):
    """The gather table holds the columns' words on every path that
    fills the columns, capacity padding included."""
    rng = np.random.default_rng(17)
    x = rng.uniform(-180, 180, 1000)
    y = rng.uniform(-90, 90, 1000)
    ms = rng.integers(0, 100 * MS_DAY, 1000)
    if path in ("build", "extend"):
        td = tzscan.build_scan_data(x[:600], y[:600], ms[:600], "cpu",
                                    cap=1024)
        if path == "extend":
            table = td.rows
            td = tzscan.extend_scan_data(td, x[600:], y[600:], ms[600:])
            assert td.rows is table and td.n == 1000
    elif path == "rebuild":
        # 600 rows build a 1024-row capacity; 500 more overrun it
        ds = InMemoryDataStore(device="cpu")
        ds.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        ds.write_dict("pts", [f"a{i}" for i in range(600)],
                      {"dtg": ms[:600], "geom": (x[:600], y[:600])})
        ds.query("BBOX(geom, 0, 0, 1, 1)", "pts")
        xs, ys = np.concatenate([x, x[:100]]), np.concatenate([y, y[:100]])
        mss = np.concatenate([ms, ms[:100]])
        ds.write_dict("pts", [f"b{i}" for i in range(500)],
                      {"dtg": mss[600:], "geom": (xs[600:], ys[600:])})
        ds.query("BBOX(geom, 0, 0, 1, 1)", "pts")
        td = ds._types["pts"].scan_data
        assert (td.n, td.cap) == (1100, 2048)
    else:
        td = data[4]
    assert td.rows.dtype == torch.int32 and td.rows.is_contiguous()
    assert np.array_equal(td.rows.numpy(), _interleaved(td))
    assert td.nbytes == td.cap * 56


@pytest.mark.parametrize("boxes,intervals", QUERIES[:2])
def test_capacity_padded(boxes, intervals):
    """cap > n: the padding tail never matches, even a whole-world box."""
    rng = np.random.default_rng(11)
    n, cap = 50_003, 65_536
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(0, 100 * MS_DAY, n)
    jd = jzscan.build_scan_data(x, y, ms, cap=cap)
    td = _carry(jd)
    assert td.cap == cap and td.n == n
    for b in (boxes, [(-180.0, -90.0, 180.0, 90.0)]):
        got = tzscan.scan_mask(td, tzscan.make_query(b, intervals)).numpy()
        jq = jzscan.make_query(b, intervals)
        assert got.shape == (cap,) and not got[n:].any()
        assert np.array_equal(got, np.asarray(jzscan.scan_mask(jd, jq)))
        assert tzscan.scan_count(td, tzscan.make_query(b, intervals)) == \
            int(got.sum())


def test_build_and_extend_match_reference():
    """The port's own write path gives the reference's columns; appends
    land in place within the capacity."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-180, 180, 1000)
    y = rng.uniform(-90, 90, 1000)
    ms = rng.integers(0, 100 * MS_DAY, 1000)
    td = tzscan.build_scan_data(x[:600], y[:600], ms[:600], "cpu", cap=1024)
    col0 = td.xhi
    td = tzscan.extend_scan_data(td, x[600:], y[600:], ms[600:])
    assert td.xhi is col0 and td.n == 1000
    assert tzscan.extend_scan_data(td, x[:100], y[:100], ms[:100]) is None
    jd = jzscan.build_scan_data(x, y, ms)
    for mine, ref in zip(td.cols, (jd.xhi, jd.xlo, jd.yhi, jd.ylo,
                                   jd.tday, jd.tms)):
        assert np.array_equal(mine.numpy()[:1000], np.asarray(ref))


def _words_predicate(cols, boxes, intervals):
    """The predicate in numpy on the stored words (IEEE compares,
    subnormals kept)."""
    xh, xl, yh, yl, td, tm = (c.numpy() for c in cols)
    q = tzscan.make_query(boxes, intervals)
    s = np.zeros(len(xh), dtype=bool)
    for b in q.boxes_np:
        s |= (((xh > b[0]) | ((xh == b[0]) & (xl >= b[1])))
              & ((xh < b[2]) | ((xh == b[2]) & (xl <= b[3])))
              & ((yh > b[4]) | ((yh == b[4]) & (yl >= b[5])))
              & ((yh < b[6]) | ((yh == b[6]) & (yl <= b[7]))))
    if q.time_any:
        return s
    t = np.zeros(len(xh), dtype=bool)
    for b in q.times_np:
        t |= (((td > b[0]) | ((td == b[0]) & (tm >= b[1])))
              & ((td < b[2]) | ((td == b[2]) & (tm <= b[3]))))
    return s & t


@pytest.mark.parametrize("time_any", [True, False])
def test_subnormal_coordinates(time_any):
    """Coordinates near 1e-40 split into subnormal f32 words. The port
    compares them as IEEE numbers (so must the CUDA kernel: it is built
    without flush-to-zero), matching the numpy predicate on the same
    words and, after the boundary patch, the exact f64 answer. XLA's CPU
    backend flushes subnormals to zero, so the reference is not the
    oracle for this input."""
    rng = np.random.default_rng(13)
    n = 4096
    x = rng.uniform(-5e-40, 5e-40, n)
    y = rng.uniform(-5e-40, 5e-40, n)
    ms = rng.integers(0, 10 * MS_DAY, n)
    xhi, xlo = tzscan.split_two_float(x)
    assert (np.abs(xhi[xhi != 0]) < np.finfo(np.float32).tiny).all()
    td = tzscan.build_scan_data(x, y, ms, "cpu")
    boxes = [(-1e-40, -1.5e-40, 2e-40, 3e-40), (3.1e-40, 1e-41, 4e-40, 2e-40)]
    intervals = [] if time_any else [(MS_DAY, 5 * MS_DAY)]
    q = tzscan.make_query(boxes, intervals)
    got = tzscan.scan_mask(td, q).numpy()
    assert np.array_equal(got, _words_predicate(td.cols, boxes, intervals))
    assert 0 < got.sum() < n
    yhi, _ = tzscan.split_two_float(y)
    cand = tzscan.boundary_candidates(xhi, yhi, q)
    exact = tzscan.exact_patch(got, cand, x, y, ms, q)
    want = np.zeros(n, dtype=bool)
    for x0, y0, x1, y1 in boxes:
        want |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if intervals:
        want &= (ms >= intervals[0][0]) & (ms <= intervals[0][1])
    assert np.array_equal(exact, want)
    rows = np.arange(0, n, 3)
    assert np.array_equal(tzscan.scan_mask_at(td, q, rows), got[rows])
    assert tzscan.scan_count(td, q) == int(got.sum())


def test_patch_matches_reference(data):
    """Boundary candidates and both patch forms agree with the
    reference's on the same columns."""
    x, y, ms, jd, td, _ = data
    xhi, yhi = np.asarray(jd.xhi), np.asarray(jd.yhi)
    # bounds placed on data points: their hi cells hold candidates
    boxes = [(x[0], y[1], x[0] + 20, y[1] + 10), (x[2] - 5, y[3] - 5,
                                                   x[2], y[3])]
    intervals = [(10 * MS_DAY, 60 * MS_DAY)]
    tq, jq = (tzscan.make_query(boxes, intervals),
              jzscan.make_query(boxes, intervals))
    cand = tzscan.boundary_candidates(xhi, yhi, tq)
    assert len(cand) >= 4
    assert np.array_equal(cand, jzscan.boundary_candidates(xhi, yhi, jq))
    mask = tzscan.scan_mask(td, tq).numpy()
    got = tzscan.exact_patch(mask, cand, x, y, ms, tq)
    assert np.array_equal(got, jzscan.exact_patch(mask, cand, x, y, ms, jq))
    rows = tzscan.patch_hit_rows(np.flatnonzero(mask), tq, x, y, ms, cand)
    assert np.array_equal(rows, np.flatnonzero(got))
    assert np.array_equal(rows, jzscan.patch_hit_rows(
        np.flatnonzero(mask), jq, x, y, ms, cand))


def test_query_tables_fold_unused_slots():
    """Unused box/interval slots carry the Pallas tables' impossible
    bounds, so one table serves both reference forms."""
    q = tzscan.make_query([(0.0, 0.0, 1.0, 1.0)] * 3, [(0, 5)] * 3)
    jb, jt = jpallas.pallas_query_tables(jzscan.make_query(
        [(0.0, 0.0, 1.0, 1.0)] * 3, [(0, 5)] * 3))
    assert q.boxes_np.shape == (4, 8) and q.times_np.shape == (4, 4)
    assert np.array_equal(q.boxes_np, np.asarray(jb))
    assert np.array_equal(q.times_np, np.asarray(jt))


def test_wrapper_checks():
    cols = tuple(torch.zeros(8, dtype=dt) for dt in
                 (torch.float32,) * 4 + (torch.int32,) * 2)
    rows = tzscan.pack_rows(cols)
    boxes = torch.zeros(1, 8)
    times = torch.zeros(1, 4, dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.scan_mask(cols, 9, boxes, times, True)
    with pytest.raises(ValueError):
        kernels.scan_mask(cols, 8, torch.zeros(2048, 8), times, True)
    with pytest.raises(ValueError):
        kernels.scan_mask(cols[:5] + (torch.zeros(8),), 8, boxes, times, True)
    # the gathered kernel takes the (cap, 8) table and int32 ids only
    with pytest.raises(ValueError, match="int32"):
        kernels.scan_mask_gather(rows, ids.long(), boxes, times, True)
    with pytest.raises(ValueError, match="rows"):
        kernels.scan_mask_gather(cols[0], ids, boxes, times, True)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scan_mask_gather(rows, torch.zeros(6, dtype=torch.int32)[::2],
                                 boxes, times, False)
    assert kernels.scan_mask_gather(rows, ids, boxes, times, True).shape == (3,)
    q = tzscan.make_query([(0.0, 0.0, 1.0, 1.0)], [])
    data = tzscan.ScanData(*cols, rows, 8)
    for bad in ([8], [-1], [0, 3, 8]):
        with pytest.raises(IndexError):
            tzscan.scan_mask_at(data, q, np.array(bad))
    with pytest.raises(ValueError, match="gather table"):
        tzscan.ScanData(*cols, rows[:4], 8)
    # row ids are int32: a capacity of 2^31 rows is refused (stride-0
    # views, so nothing is allocated)
    big = [c[:1].expand(2**31) for c in cols]
    with pytest.raises(ValueError, match="int32"):
        tzscan.ScanData(*big, rows[:1].expand(2**31, 8), 0)
    with pytest.raises(ValueError, match="above"):
        tzscan.build_scan_data(np.zeros(1), np.zeros(1), np.zeros(1), "cpu",
                               cap=2**31)
