"""Tube select in the port: the tube kernel's plain version and its
search over sorted pairs against the JAX package's tube_select_mask, and
tube_select_process against the JAX process on the same store, on the
CPU; the kernel against its plain version on the card (``gpu``).

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


@pytest.mark.parametrize("n,cap,k", CASES)
@pytest.mark.parametrize("chunk", [kernels.TUBE_CHUNK, 7, 1])
def test_search_matches_plain(n, cap, k, chunk):
    """The kernel's decomposition (pairs sorted by their interval's lo,
    a running max of hi, a search then a backward walk, chunk by chunk)
    gives the plain version's mask."""
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
    got = kernels.tube_mask_search_plain(d.cols, d.n, lo, pm, hi, sb,
                                         chunk=chunk)
    assert torch.equal(got, want)


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


@pytest.mark.gpu
@pytest.mark.parametrize("n,cap,k", CASES + [(1_000_003, 1 << 20, 720),
                                             (300_000, 1 << 19, 2_000)])
def test_kernel_matches_plain(cuda, n, cap, k):
    rng = np.random.default_rng(7 + n + k)
    boxes, iv = _tables(rng, k)
    x, y, ms = _rows(rng, n, boxes, iv)
    d = zscan.build_scan_data(x, y, ms, cuda, cap=cap)
    bx, tm = (torch.from_numpy(a).to(cuda)
              for a in tube.tube_tables(boxes, iv))
    kernels.reset_launches()
    got = kernels.tube_mask(d.cols, d.n, bx, tm)
    want = kernels.tube_mask_plain(d.cols, d.n, bx, tm)
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.equal(got, want)
    assert kernels.launches["tube_mask"] == (1 if n and k else 0)


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
    assert kernels.launches["tube_mask"] == 1
    with pytest.raises(ValueError, match="several devices"):
        kernels.tube_mask(d.cols, d.n, bx, tm)
    with pytest.raises(ValueError, match="same K"):
        kernels.tube_mask(d.cols, d.n, bx.to(cuda), tm[:3].to(cuda))
