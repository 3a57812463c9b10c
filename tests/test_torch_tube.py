"""Tube select in the port: the tube kernel's plain version against the
JAX package's tube_select_mask; the kernel's decomposition (pairs sorted
by their intervals, a time-bucket index that rejects rows and bounds the
search, the walk) against the plain version, on random and adversarial
tables; tube_select_process against the JAX process on the same store,
on the CPU; the kernel against its plain version on the card (``gpu``).

The JAX package is imported inside the tests that compare with it, so
the ``gpu`` tests run where it is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_tube.py``.

Tolerance: exact (equal masks, equal ids in the same order)."""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.analytics import processes, tube
from geomesa_tpu_torch.scan import kernels, zscan

MS_DAY = 86_400_000
HOUR = 3_600_000


def _tables(rng, k):
    """K (box, interval) pairs over (-10, 10)^2 and days -5..20, in no
    order: overlapping intervals, some inverted (empty), some before
    1970."""
    lo = np.sort(rng.uniform(-10, 10, (k, 2)), axis=1)
    lat = np.sort(rng.uniform(-10, 10, (k, 2)), axis=1)
    boxes = np.stack([lo[:, 0], lat[:, 0], lo[:, 1], lat[:, 1]], axis=1)
    t0 = rng.integers(-5 * MS_DAY, 20 * MS_DAY, k)
    t1 = t0 + rng.integers(-HOUR, 3 * MS_DAY, k)
    t1[:1] = np.maximum(t0[:1], t1[:1])   # pair 0 holds its edge rows
    return boxes, np.stack([t0, t1], axis=1)


def _rows(rng, n, boxes, intervals):
    """n points, the first ones exactly on pair 0's edges and times, and
    one ulp inside or outside them (they differ in their lo word)."""
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(-10, 10, n)
    ms = rng.integers(-6 * MS_DAY, 21 * MS_DAY, n)
    if len(boxes) and n >= 12:
        x0, y0, x1, y1 = boxes[0]
        t0, t1 = intervals[0]
        up, down = np.inf, -np.inf
        x[:12] = [x0, x1, x0, x1, np.nextafter(x0, down),
                  np.nextafter(x1, up), np.nextafter(x0, up),
                  np.nextafter(x1, down), x0, x1, (x0 + x1) / 2,
                  (x0 + x1) / 2]
        y[:12] = [y0, y1, y1, y0, y0, y1, y0, y1, np.nextafter(y0, down),
                  np.nextafter(y1, up), y0, y1]
        ms[:12] = [t0, t1, t0, t1, t0, t1, t0 + 1, t1 - 1, t0, t1, t0 - 1,
                   t1 + 1]
    return x, y, ms


CASES = [  # (n, cap, k)
    (2_000, 2_048, 0), (2_000, 4_096, 1), (3_000, 4_096, 3),
    (5_000, 8_192, 37), (20_000, 32_768, 720), (4_000, 4_096, 1_000),
    (1, 1, 5), (0, 16, 4),
]


@pytest.mark.parametrize("n,cap,k", CASES)
def test_plain_matches_reference(n, cap, k):
    """tube_mask_plain (through tube_select_mask on CPU columns) against
    the JAX package's tube_select_mask: edge-equal points, negative
    millis, K = 0, 1 and not a power of two, capacity rows past n."""
    from geomesa_tpu.analytics.tube import tube_select_mask as jax_mask
    from geomesa_tpu.scan.zscan import build_scan_data as jax_build
    rng = np.random.default_rng(n + k)
    boxes, iv = _tables(rng, k)
    x, y, ms = _rows(rng, n, boxes, iv)
    got = tube.tube_select_mask(zscan.build_scan_data(x, y, ms, "cpu",
                                                      cap=cap), boxes, iv)
    want = jax_mask(jax_build(x, y, ms, cap=cap), boxes, iv)
    assert got.dtype == bool and got.shape == (n,)
    assert np.array_equal(got, want)
    if k and n >= 12:
        # the rows on pair 0's edges and times, and one ulp inside them
        # (another pair may hold the ones just outside)
        assert want[[0, 1, 2, 3, 6, 7]].all()


# the index's parameters: (bucket bits, pairs staged); None is the
# kernel's own bucket count for K
INDEX = [(None, kernels.TUBE_STAGE), (0, kernels.TUBE_STAGE), (16, 7),
         (None, 1)]


@pytest.mark.parametrize("n,cap,k", CASES)
@pytest.mark.parametrize("bits,stage", INDEX)
def test_search_matches_plain(n, cap, k, bits, stage):
    """The kernel's decomposition (pairs sorted by their interval's lo,
    a running max of hi, a time-bucket index that rejects rows and
    bounds the search, a binary search then a backward walk; one bucket,
    2^16 buckets, one or 7 pairs staged) gives the plain version's
    mask."""
    rng = np.random.default_rng(100 + n + k)
    boxes, iv = _tables(rng, k)
    x, y, ms = _rows(rng, n, boxes, iv)
    d = zscan.build_scan_data(x, y, ms, "cpu", cap=cap)
    bx, tm = (torch.from_numpy(a) for a in tube.tube_tables(boxes, iv))
    want = kernels.tube_mask_plain(d.cols, d.n, bx, tm)
    if k == 0:
        assert not want.any()
        return
    lo, pm, hi, sb = kernels.tube_pairs(bx, tm)
    assert torch.all(lo[1:] >= lo[:-1]) and torch.all(pm >= hi)
    got = kernels.tube_mask_index_plain(d.cols, d.n, lo, pm, hi, sb,
                                        bits=bits, stage=stage)
    assert torch.equal(got, want)


def _cols(x, y, day, ms):
    """Scan columns on the CPU from f64 coordinates and int32 (day, ms)
    words as given (any day an int32 holds)."""
    xh, xl = zscan.split_two_float(x)
    yh, yl = zscan.split_two_float(y)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        xh, xl, yh, yl, np.asarray(day, np.int32), np.asarray(ms, np.int32)))


def _boxes(rng, k, lo=-10.0, hi=10.0):
    a = np.sort(rng.uniform(lo, hi, (k, 2)), axis=1)
    b = np.sort(rng.uniform(lo, hi, (k, 2)), axis=1)
    return tube.tube_tables(np.stack([a[:, 0], b[:, 0], a[:, 1], b[:, 1]], 1),
                            np.zeros((k, 2), np.int64))[0]


def adversarial(name, rng, n):
    """(cols, boxes, times) of a tube the index must get right.
    "extreme": days at +-(2^31 - 1) and -2^31 in both rows and pairs, so
    the keys' span passes 2^63. "saturated": pair 0's interval spans
    every row's time, so pm saturates and every walk reaches pair 0.
    "rejected": the rows' times all fall before, after or between the
    intervals. "candidates": hourly intervals over every row's time.
    "sparse": hourly intervals over 10 of the rows' 300 days (under one
    candidate in 8 rows), boxes 2-6 degrees wide, some rows on a box's
    edges and some with NaN coordinates. "lo_words": rows whose two-float
    x or y equals a box edge's hi word and lies one f32 step inside or
    outside its lo word, in the box's interval."""
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    big = 2**31 - 1
    if name == "extreme":
        k = 40
        days = np.array([-big - 1, -big, -big + 1, -1, 0, 1, big - 1, big])
        t0d = rng.choice(days, k)
        t1d = np.minimum(t0d.astype(np.int64) + rng.integers(0, 2, k), big)
        t0m = rng.integers(0, MS_DAY, k)
        t1m = rng.integers(0, MS_DAY, k)
        times = np.stack([t0d, t0m, t1d, t1m], 1)
        rday = rng.choice(days, n)
        rms = rng.integers(0, MS_DAY, n)
        rms[:4] = [0, MS_DAY - 1, -2**31, 2**31 - 1]   # any int32 words
    elif name == "saturated":
        k = 300
        t0 = rng.integers(0, 30 * MS_DAY, k)
        t1 = t0 + rng.integers(0, 2 * HOUR, k)
        t0[0], t1[0] = -MS_DAY, 31 * MS_DAY
        ms = rng.integers(0, 30 * MS_DAY, n)
        times = np.stack([t0 // MS_DAY, t0 % MS_DAY, t1 // MS_DAY,
                          t1 % MS_DAY], 1)
        rday, rms = ms // MS_DAY, ms % MS_DAY
        bx = _boxes(rng, k)
        bx[0] = tube.tube_tables([(9.0, 9.0, 9.5, 9.5)], [(0, 1)])[0]
        return (_cols(x, y, rday, rms), torch.from_numpy(bx),
                torch.from_numpy(times.astype(np.int32)))
    elif name == "rejected":
        k = 50
        t0 = 10 * MS_DAY + np.arange(k) * 2 * HOUR
        t1 = t0 + HOUR - 1
        # before, after, and in the gaps between the hourly intervals
        ms = np.concatenate([rng.integers(0, 10 * MS_DAY, n // 3),
                             rng.integers(t1[-1] + 1, 40 * MS_DAY, n // 3),
                             rng.choice(t0[:-1] + HOUR, n - 2 * (n // 3))
                             + rng.integers(0, HOUR, n - 2 * (n // 3))])
        times = np.stack([t0 // MS_DAY, t0 % MS_DAY, t1 // MS_DAY,
                          t1 % MS_DAY], 1)
        rday, rms = ms // MS_DAY, ms % MS_DAY
    elif name == "lo_words":
        k = 64
        t0 = np.arange(k) * HOUR
        t1 = t0 + HOUR - 1
        w = rng.uniform(0.5, 2, (k, 2))
        cx, cy = rng.uniform(-50, 50, k), rng.uniform(-50, 50, k)
        edges = np.stack([cx - w[:, 0] / 2, cy - w[:, 1] / 2,
                          cx + w[:, 0] / 2, cy + w[:, 1] / 2], 1)
        bx = tube.tube_tables(edges, np.zeros((k, 2), np.int64))[0]
        pick = rng.integers(0, k, n)
        side = rng.integers(0, 8, n)          # which edge, and which way
        b = bx[pick]
        edge = np.array([0, 2, 4, 6])[side % 4]
        hi, lo = b[np.arange(n), edge], b[np.arange(n), edge + 1]
        way = np.where(side < 4, -np.inf, np.inf).astype(np.float32)
        near = hi.astype(np.float64) + np.nextafter(lo, way).astype(np.float64)
        x = np.where(side % 4 < 2, near, cx[pick])
        y = np.where(side % 4 >= 2, near, cy[pick])
        ms = t0[pick] + rng.integers(0, HOUR, n)
        times = np.stack([t0 // MS_DAY, t0 % MS_DAY, t1 // MS_DAY,
                          t1 % MS_DAY], 1)
        cols = _cols(x, y, ms // MS_DAY, ms % MS_DAY)
        # the rows keep the edge's hi word and differ in the lo word
        words = torch.stack(cols[:4], 1)[torch.arange(n),
                                         torch.from_numpy(side % 4 // 2 * 2)]
        assert torch.equal(words, torch.from_numpy(hi))
        return (cols, torch.from_numpy(bx),
                torch.from_numpy(times.astype(np.int32)))
    elif name == "sparse":
        k = 24 * 10
        t0 = 100 * MS_DAY + np.arange(k) * HOUR
        t1 = t0 + HOUR - 1
        ms = rng.integers(0, 300 * MS_DAY, n)
        w = rng.uniform(2, 6, (k, 2))
        cx, cy = rng.uniform(-5, 5, k), rng.uniform(-5, 5, k)
        edges = np.stack([cx - w[:, 0] / 2, cy - w[:, 1] / 2,
                          cx + w[:, 0] / 2, cy + w[:, 1] / 2], 1)
        # rows inside the tube's days, a tenth of them on a box's edges
        inside = rng.choice(n, n // 30, replace=False)
        pick = rng.integers(0, k, len(inside))
        ms[inside] = t0[pick] + rng.integers(0, HOUR, len(inside))
        edge = inside[: len(inside) // 10]
        x[edge] = edges[pick[: len(edge)], 0]
        y[edge] = edges[pick[: len(edge)], 3]
        x[inside[-5:]] = np.nan
        times = np.stack([t0 // MS_DAY, t0 % MS_DAY, t1 // MS_DAY,
                          t1 % MS_DAY], 1)
        bx = tube.tube_tables(edges, np.zeros((k, 2), np.int64))[0]
        return (_cols(x, y, ms // MS_DAY, ms % MS_DAY), torch.from_numpy(bx),
                torch.from_numpy(times.astype(np.int32)))
    else:
        k = 24 * 20
        t0 = np.arange(k) * HOUR
        t1 = t0 + HOUR - 1
        ms = rng.integers(0, k * HOUR, n)
        times = np.stack([t0 // MS_DAY, t0 % MS_DAY, t1 // MS_DAY,
                          t1 % MS_DAY], 1)
        rday, rms = ms // MS_DAY, ms % MS_DAY
    return (_cols(x, y, rday, rms), torch.from_numpy(_boxes(rng, k)),
            torch.from_numpy(times.astype(np.int32)))


ADVERSARIAL = ["extreme", "saturated", "rejected", "candidates", "sparse",
               "lo_words"]


def _candidates(cols, n, lo, pm, hi, bits):
    """Rows the index does not reject: in [lo_min, pm_max] and in a
    bucket some interval reaches."""
    lo_min, top, base, shift, index = kernels.tube_index_plain(lo, pm, hi,
                                                               bits)
    t = kernels._time_keys(cols[4][:n], cols[5][:n])
    inside = (t >= lo_min) & (t <= top)
    j = (kernels._spread(torch.where(inside, t, lo_min)) - base) >> shift
    return inside & ((index[j] & (1 << 31)) != 0)


@pytest.mark.parametrize("name", ADVERSARIAL)
@pytest.mark.parametrize("bits,stage", INDEX)
def test_search_adversarial(name, bits, stage):
    rng = np.random.default_rng(ADVERSARIAL.index(name))
    n = 3_000
    cols, bx, tm = adversarial(name, rng, n)
    want = kernels.tube_mask_plain(cols, n, bx, tm)
    lo, pm, hi, sb = kernels.tube_pairs(bx, tm)
    got = kernels.tube_mask_index_plain(cols, n, lo, pm, hi, sb, bits=bits,
                                        stage=stage)
    assert torch.equal(got, want)
    b = kernels.tube_bucket_bits(lo.shape[0]) if bits is None else bits
    cand = _candidates(cols, n, lo, pm, hi, b)
    if name == "extreme":
        assert int(pm[-1]) - int(lo[0]) > 2**63 and want.any()
    elif name == "saturated":
        assert bool((pm[1:] == pm[-1]).all()) and want.any()
    elif name == "sparse":
        assert 0 < int(cand.sum()) * 8 < n and want.any()
    elif name == "lo_words":
        assert 0 < int(want.sum()) < n
    elif name == "rejected":
        # the range test rejects the rows before and after; at 2^16
        # buckets (about 270 s wide here) the buckets reject most of those
        # in the hour-long gaps, all but the ones in an interval's bucket
        assert not want.any() and not cand[:2 * (n // 3)].any()
        if b >= 16:
            assert int(cand.sum()) < (n - 2 * (n // 3)) // 4
    else:
        assert cand.all() and want.any()


@pytest.mark.parametrize("k,bits", [(1, 1), (7, 3), (200, 9), (200, 2)])
def test_index_matches_brute(k, bits):
    """tube_index_plain's entries against their definitions, bucket by
    bucket: the pairs whose lo lies in an earlier bucket, and whether
    some interval with lo <= hi shares a key with the bucket; the spread
    of the keys is monotone and close to their epoch millis."""
    rng = np.random.default_rng(k + bits)
    boxes, iv = _tables(rng, k)
    bx, tm = (torch.from_numpy(a) for a in tube.tube_tables(boxes, iv))
    lo, pm, hi, _ = kernels.tube_pairs(bx, tm)
    lo_min, top, base, shift, index = kernels.tube_index_plain(lo, pm, hi,
                                                               bits)
    nb = 1 << bits
    assert lo_min == int(lo.min()) and top == int(hi.max())
    span = int(kernels._spread(pm[-1:])) - base
    assert span >> shift < nb and (shift == 0 or span >> (shift - 1) >= nb)
    # a valid (day, ms) spreads to its millis
    assert np.array_equal(kernels._spread(lo).numpy(), np.sort(iv[:, 0]))
    slo, shi = kernels._spread(lo), kernels._spread(hi)
    for j in range(nb + 1):
        start = base + (j << shift)
        end = start + (1 << shift) - 1
        first = int((slo < start).sum())
        reached = bool(((lo <= hi) & (slo <= end) & (shi >= start)).any())
        assert int(index[j]) == first | (
            (1 << 31) if j < nb and reached else 0)


def test_spread_is_monotone():
    """The spread of keys in (day, ms) order never decreases, for any
    int32 words, and never overflows."""
    big = 2**31
    day = np.array([-big, -big, -big, -1, -1, 0, 0, 0, 0, 1, big - 1,
                    big - 1])
    ms = np.array([-big, 0, big - 1, MS_DAY - 1, MS_DAY, -5, 0, MS_DAY - 1,
                   big - 1, -big, 0, big - 1])
    keys = kernels._time_keys(torch.from_numpy(day.astype(np.int32)),
                              torch.from_numpy(ms.astype(np.int32)))
    assert torch.all(keys[1:] > keys[:-1])
    s = kernels._spread(keys)
    assert torch.all(s[1:] >= s[:-1])
    assert int(s[0]) == -big * MS_DAY and int(s[-1]) == (big - 1) * MS_DAY \
        + MS_DAY - 1


def test_tables_split_with_floor():
    bx, tm = tube.tube_tables([(-1.0, -2.0, 3.0, 4.0)], [(-1, 2 * MS_DAY)])
    assert tm.tolist() == [[-1, MS_DAY - 1, 2, 0]]
    assert bx.dtype == np.float32 and bx.shape == (1, 8)
    assert bx[0, ::2].tolist() == [-1.0, 3.0, -2.0, 4.0]
    with pytest.raises(ValueError):
        tube.tube_tables([(0.0, 0.0, 1.0, 1.0)], [])
    # the time keys order (day, ms) lexicographically for any int32 words
    day = torch.tensor([-2**31, -1, -1, 0, 0, 0, 2**31 - 1],
                       dtype=torch.int32)
    ms = torch.tensor([2**31 - 1, -2**31, 5, -7, 0, 2**31 - 1, 2**31 - 1],
                      dtype=torch.int32)
    keys = kernels._time_keys(day, ms)
    assert torch.all(keys[1:] > keys[:-1])


def _track(rng, n, t0, step, gap_at=None, gap=0):
    """A vessel's track: n fixes, one every ``step`` ms, about 12 knots
    (0.2 degrees an hour), from (-5, -5); a ``gap`` after fix ``gap_at``."""
    ms = t0 + np.arange(n, dtype=np.int64) * step
    if gap_at is not None:
        ms[gap_at:] += gap
    heading = np.cumsum(rng.normal(0, 0.05, n))
    x = -5 + np.cumsum(0.2 * step / HOUR * np.cos(heading))
    y = -5 + np.cumsum(0.2 * step / HOUR * np.sin(heading))
    return x, y, ms


@pytest.fixture(scope="module")
def stores():
    from geomesa_tpu.store import InMemoryDataStore as JaxStore
    rng = np.random.default_rng(21)
    n = 60_000
    x = rng.uniform(-12, 12, n)
    y = rng.uniform(-12, 12, n)
    ms = rng.integers(-2 * MS_DAY, 12 * MS_DAY, n)
    ids = [f"r{i}" for i in range(n)]
    out = []
    for s in (InMemoryDataStore(device="cpu"), JaxStore()):
        s.create_schema("ais", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("ais", ids, {"dtg": ms, "geom": (x, y)})
        out.append(s)
    return out


@pytest.mark.parametrize("gap", [False, True])
@pytest.mark.parametrize("buffer", [0.1, 0.5])
def test_process_matches_reference(stores, gap, buffer):
    """tube_select_process on a CPU store against the JAX process on
    the same rows: a track from before 1970 on, a fix every 30 minutes,
    hourly bins; with a 48-hour gap, which the gap fill interpolates."""
    from geomesa_tpu.analytics import processes as jp
    port, ref = stores
    rng = np.random.default_rng(3)
    tx, ty, tms = _track(rng, 300, -MS_DAY, HOUR // 2,
                            gap_at=150 if gap else None, gap=2 * MS_DAY)
    got = processes.tube_select_process(port, "ais", tx, ty, tms, buffer,
                                        bin_millis=HOUR)
    want = jp.tube_select_process(ref, "ais", tx, ty, tms, buffer,
                                  bin_millis=HOUR)
    assert len(want) > 0
    assert list(got) == list(want)


def test_process_empty_and_extent_types():
    s = InMemoryDataStore(device="cpu")
    s.create_schema("ais", "dtg:Date,*geom:Point:srid=4326")
    assert len(processes.tube_select_process(s, "ais", [0.0], [0.0], [0],
                                             0.1)) == 0
    s.create_schema("poly", "dtg:Date,*geom:Polygon:srid=4326")
    s.write_dict("poly", ["a"], {"dtg": [0], "geom": [
        "POLYGON((0 0, 1 0, 1 1, 0 0))"]})
    with pytest.raises(TypeError):
        processes.tube_select_process(s, "poly", [0.0], [0.0], [0], 0.1)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _on_card(d, boxes, iv, cuda):
    bx, tm = (torch.from_numpy(a).to(cuda)
              for a in tube.tube_tables(boxes, iv))
    kernels.reset_launches()
    got = kernels.tube_mask(d.cols, d.n, bx, tm)
    want = kernels.tube_mask_plain(d.cols, d.n, bx, tm)
    torch.cuda.synchronize()
    assert got.shape == (d.n,) and torch.equal(got, want)
    # two launches a call: the pairs' records, then the mask
    assert kernels.launches["tube_mask"] == (2 if d.n and len(iv) else 0)


# past the CPU cases: K past the pairs staged in shared memory, and n
# not a multiple of the kernel's tile
GPU_CASES = CASES + [(1_000_003, 1 << 20, 720), (300_000, 1 << 19, 2_000),
                     (200_000, 1 << 18, 5_000),
                     (kernels.TUBE_TILE * 37 + 5, 1 << 17, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,cap,k", GPU_CASES)
def test_kernel_matches_plain(cuda, n, cap, k):
    rng = np.random.default_rng(7 + n + k)
    boxes, iv = _tables(rng, k)
    x, y, ms = _rows(rng, n, boxes, iv)
    _on_card(zscan.build_scan_data(x, y, ms, cuda, cap=cap), boxes, iv, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [37, 720, 5_000])
def test_kernel_rows_sorted_by_time(cuda, k):
    """Rows in time order, so whole tiles fall outside every interval and
    the tiles inside are all candidates."""
    rng = np.random.default_rng(k)
    boxes, iv = _tables(rng, k)
    x, y, ms = _rows(rng, 500_001, boxes, iv)
    o = np.argsort(ms, kind="stable")
    _on_card(zscan.build_scan_data(x[o], y[o], ms[o], cuda,
                                   cap=1 << 19), boxes, iv, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_kernel_adversarial(cuda, name):
    n = 300_007
    cols, bx, tm = adversarial(name, np.random.default_rng(11), n)
    cols = tuple(c.to(cuda) for c in cols)
    bx, tm = bx.to(cuda), tm.to(cuda)
    kernels.reset_launches()
    got = kernels.tube_mask(cols, n, bx, tm)
    want = kernels.tube_mask_plain(cols, n, bx, tm)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.launches["tube_mask"] == 2
    assert (not want.any()) if name == "rejected" else want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 37, 2_000, 5_000])
def test_kernel_tied_and_extreme_days(cuda, k):
    """Pairs with tied lo keys (the sort's stable order), days at
    -2^31, -1, 0, 7 and 2^31 - 1 (a key span past 2^63), some inverted;
    rows on the same days and edge ms, so they take every branch of the
    range test, the buckets and the walk."""
    rng = np.random.default_rng(k)
    days = rng.choice([-2**31, -1, 0, 7, 2**31 - 1], (k, 2))
    ms = rng.choice([0, 5, MS_DAY - 1], (k, 2))
    times = np.stack([days[:, 0], ms[:, 0], days[:, 1], ms[:, 1]], 1)
    bx = torch.from_numpy(_boxes(rng, k)).to(cuda)
    tm = torch.from_numpy(times.astype(np.int32)).to(cuda)
    n = 100_003
    xy = rng.uniform(-10, 10, (2, n)).astype(np.float32)
    cols = [torch.from_numpy(v).to(cuda) for v in
            (xy[0], np.zeros(n, np.float32), xy[1], np.zeros(n, np.float32),
             rng.choice([-2**31, -1, 0, 7, 2**31 - 1], n).astype(np.int32),
             rng.choice([-1, 0, 3, 5, 6, MS_DAY - 1, MS_DAY],
                        n).astype(np.int32))]
    kernels.reset_launches()
    got = kernels.tube_mask(cols, n, bx, tm)
    want = kernels.tube_mask_plain(cols, n, bx, tm)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.launches["tube_mask"] == 2
    assert want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_kernel_misaligned_views(cuda, shift):
    """Column views and tables that are not 16-byte aligned: the time
    words are read word by word, the tables copied; the same mask."""
    rng = np.random.default_rng(shift)
    boxes, iv = _tables(rng, 300)
    x, y, ms = _rows(rng, 70_001, boxes, iv)
    d = zscan.build_scan_data(x, y, ms, cuda, cap=1 << 17)
    cols = tuple(c[shift:] for c in d.cols)
    bx, tm = (torch.from_numpy(a).to(cuda)
              for a in tube.tube_tables(boxes, iv))
    k = bx.shape[0]
    bx2 = torch.empty(k * 8 + shift, dtype=torch.float32, device=cuda)
    tm2 = torch.empty(k * 4 + shift, dtype=torch.int32, device=cuda)
    bx2 = bx2[shift:].view(k, 8).copy_(bx)
    tm2 = tm2[shift:].view(k, 4).copy_(tm)
    assert all(t.data_ptr() % 16 for t in (cols[4], cols[5], bx2, tm2))
    n = d.n - shift
    kernels.reset_launches()
    got = kernels.tube_mask(cols, n, bx2, tm2)
    want = kernels.tube_mask_plain(cols, n, bx, tm)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and kernels.launches["tube_mask"] == 2
    assert want.any()


@pytest.mark.gpu
def test_wrapper_raises_on_cuda(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(kernels, "tube_mask_plain", refuse)
    rng = np.random.default_rng(1)
    boxes, iv = _tables(rng, 9)
    x, y, ms = _rows(rng, 5000, boxes, iv)
    d = zscan.build_scan_data(x, y, ms, cuda, cap=8192)
    bx, tm = (torch.from_numpy(a) for a in tube.tube_tables(boxes, iv))
    kernels.reset_launches()
    kernels.tube_mask(d.cols, d.n, bx.to(cuda), tm.to(cuda))
    assert kernels.launches["tube_mask"] == 2
    with pytest.raises(ValueError, match="several devices"):
        kernels.tube_mask(d.cols, d.n, bx, tm)
    with pytest.raises(ValueError, match="same K"):
        kernels.tube_mask(d.cols, d.n, bx.to(cuda), tm[:3].to(cuda))
