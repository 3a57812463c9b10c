"""The port's density, BIN and sampling against the JAX package.

- The store cases of ``tests/test_aggregations.py`` that touch density,
  BIN and sampling, on the port's store (CPU), each beside the JAX
  store's answer.
- ``kernels.density_grid_plain`` (the density kernel's plain version)
  against ``geomesa_tpu.scan.aggregations.density_grid`` on edge inputs:
  points outside the bbox on every side, coordinates at +-1e30 (+-inf
  after the f32 cast), NaN coordinates, a degenerate bbox, points on
  xmax/ymax. Tolerance: unit and integer weights exact (every cell an
  integer total below 2^24); fractional weights within
  2 * n_cell * 2^-24 * sum |w| per cell (the f32 sums' order).
- ``encode_bin_*``, ``_id_hashes`` and ``sample_mask`` byte for byte.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.index.api import QueryHints as JQueryHints
from geomesa_tpu.scan import aggregations as jagg
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore, Query
from geomesa_tpu_torch.index.api import QueryHints
from geomesa_tpu_torch.scan import aggregations, kernels

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731


def _ships(ds):
    ds.create_schema("ships", "vessel:String,dtg:Date,*geom:Point")
    rng = np.random.default_rng(3)
    n = 20_000
    ds.write_dict("ships", [f"s{i}" for i in range(n)], {
        "vessel": [f"v{i % 40}" for i in range(n)],
        "dtg": rng.integers(MS("2017-01-01"), MS("2017-02-01"), n),
        "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)),
    })
    return ds


@pytest.fixture(scope="module")
def ships():
    return _ships(InMemoryDataStore(device="cpu")), _ships(JaxStore())


# -- the store cases of tests/test_aggregations.py ------------------------------

@pytest.mark.parametrize("ecql,bbox,w,h", [
    ("BBOX(geom, -10, -10, 10, 10)", (-10, -10, 10, 10), 32, 32),
    ("BBOX(geom, 0, 0, 10, 10)", (-10, -10, 10, 10), 16, 16),
    ("INCLUDE", (-5, -5, 5, 5), 7, 3),
    ("dtg DURING 2017-01-05T00:00:00Z/2017-01-09T00:00:00Z",
     (-10, -10, 10, 10), 1, 1),
    ("EXCLUDE", (-10, -10, 10, 10), 4, 4)])
def test_density_matches_reference(ships, ecql, bbox, w, h):
    port, ref = ships
    got = port.density("ships", ecql, bbox, w, h)
    want = ref.density("ships", ecql, bbox, w, h)
    assert got.dtype == np.float32 and got.shape == (h, w)
    assert np.array_equal(got, want)


def test_density_mass_equals_hits(ships):
    grid = ships[0].density("ships", "BBOX(geom, -10, -10, 10, 10)",
                            (-10, -10, 10, 10), 32, 32)
    assert grid.shape == (32, 32) and int(grid.sum()) == 20_000


def test_density_subset(ships):
    grid = ships[0].density("ships", "BBOX(geom, 0, 0, 10, 10)",
                            (-10, -10, 10, 10), 16, 16)
    assert grid[:8, :].sum() == 0 and grid[:, :8].sum() == 0
    assert grid[8:, 8:].sum() > 0


def _pair(spec, ids, data):
    out = []
    for ds in (InMemoryDataStore(device="cpu"), JaxStore()):
        ds.create_schema("w", spec)
        ds.write_dict("w", ids, data)
        out.append(ds)
    return out


@pytest.mark.parametrize("wt,want_sum", [
    ([2.5, 4.0], 6.5), ([2.0, None], 2.0), ([np.nan, 3.0], 3.0)])
def test_density_weighted(wt, want_sum):
    port, ref = _pair("wt:Double,*geom:Point", ["a", "b"],
                      {"wt": wt, "geom": ([1.0, 5.0], [1.0, 5.0])})
    got = port.density("w", "INCLUDE", (-10, -10, 10, 10), 4, 4,
                       weight_attr="wt")
    assert np.isfinite(got).all() and got.sum() == pytest.approx(want_sum)
    assert np.array_equal(got, ref.density("w", "INCLUDE", (-10, -10, 10, 10),
                                           4, 4, weight_attr="wt"))


def test_density_invalid_rows_and_weights():
    """Null points and null or NaN weights are masked, as in the JAX
    store; integer weights sum exactly."""
    rng = np.random.default_rng(8)
    n = 5_000
    x, y = rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)
    x[::17] = np.nan
    wi = [None if i % 11 == 0 else int(v)
          for i, v in enumerate(rng.integers(-20, 1000, n))]
    wd = rng.uniform(-3, 3, n)
    wd[::13] = np.nan
    port, ref = _pair("wi:Integer,wd:Double,*geom:Point",
                      [f"p{i}" for i in range(n)],
                      {"wi": wi, "wd": wd, "geom": (x, y)})
    for attr in (None, "wi"):
        got = port.density("w", "INCLUDE", (-20, -25, 25, 20), 9, 7, attr)
        assert np.array_equal(got, ref.density("w", "INCLUDE",
                                               (-20, -25, 25, 20), 9, 7, attr))
    bbox = (-20, -25, 25, 20)
    got = port.density("w", "INCLUDE", bbox, 9, 7, "wd")
    want = ref.density("w", "INCLUDE", bbox, 9, 7, "wd")
    assert np.isfinite(got).all()
    ok = np.isfinite(x) & np.isfinite(wd)
    bound = _cell_bound(np.where(ok, x, 0), y, ok, wd, bbox, 9, 7)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_density_empty_store_and_result():
    ds = InMemoryDataStore(device="cpu")
    ds.create_schema("e", "*geom:Point")
    assert np.array_equal(ds.density("e", "INCLUDE", (0, 0, 1, 1), 3, 2),
                          np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("kwargs", [
    {}, {"sort": True}, {"label": "vessel"}, {"track": "vessel"},
    {"track": "vessel", "label": "dtg", "sort": True}])
@pytest.mark.parametrize("ecql", ["BBOX(geom, -1, -1, 1, 1)",
                                  "BBOX(geom, -5, -5, 5, 5)"])
def test_bin_matches_reference(ships, ecql, kwargs):
    port, ref = ships
    got = port.bin_query("ships", ecql, **kwargs)
    assert got == ref.bin_query("ships", ecql, **kwargs)
    rec = aggregations.decode_bin_records(got, "label" in kwargs)
    assert len(rec) == port.query_count(ecql, "ships") > 0
    if kwargs.get("sort"):
        assert np.all(np.diff(rec["secs"].astype(np.int64)) >= 0)


def test_bin_roundtrip_and_track(ships):
    port = ships[0]
    rec = aggregations.decode_bin_records(
        port.bin_query("ships", "BBOX(geom, -1, -1, 1, 1)"))
    assert np.all(np.abs(rec["lat"]) <= 1.0001)
    assert np.all(np.abs(rec["lon"]) <= 1.0001)
    lab = aggregations.decode_bin_records(port.bin_query(
        "ships", "BBOX(geom, -1, -1, 1, 1)", label="vessel"), labeled=True)
    assert lab.itemsize == 24 and lab["label"][0].startswith(b"v")
    r1 = aggregations.decode_bin_records(port.bin_query(
        "ships", "BBOX(geom, -1, -1, 1, 1)", track="vessel"))
    assert len(r1) == len(rec)
    assert not np.array_equal(r1["track"], rec["track"])


@pytest.mark.parametrize("hints", [
    {QueryHints.SAMPLING: 0.1},
    {QueryHints.SAMPLING: 0.05, QueryHints.SAMPLE_BY: "vessel"},
    {QueryHints.SAMPLING: 0.5, QueryHints.SAMPLE_BY: "dtg"}])
def test_sampling_matches_reference(ships, hints):
    port, ref = ships
    q = Query("ships", "BBOX(geom, -10, -10, 10, 10)", hints=hints)
    got = port.query(q)
    want = ref.query(JQuery("ships", "BBOX(geom, -10, -10, 10, 10)",
                            hints={getattr(JQueryHints, k): v
                                   for k, v in hints.items()}))
    assert list(got.ids) == list(want.ids)
    if QueryHints.SAMPLE_BY not in hints:
        assert got.n == 2000
    elif hints[QueryHints.SAMPLE_BY] == "vessel":
        assert len({f["vessel"] for f in got.features()}) == 40


def test_sampling_with_null_groups():
    data = {"name": ["x", None, "y", None],
            "geom": ([0.0, 1.0, 2.0, 3.0], [0.0] * 4)}
    port, ref = [], []
    for ds, out in ((InMemoryDataStore(device="cpu"), port),
                    (JaxStore(), ref)):
        ds.create_schema("t", "name:String,*geom:Point")
        ds.write_dict("t", ["a", "b", "c", "d"], data)
        out.append(ds)
    hints = {"SAMPLING": 0.5, "SAMPLE_BY": "name"}
    got = port[0].query(Query("t", "INCLUDE", hints=dict(hints)))
    want = ref[0].query(JQuery("t", "INCLUDE", hints=dict(hints)))
    assert got.n >= 2 and list(got.ids) == list(want.ids)


# -- the density kernel's plain version against the reference -------------------

def _edge_points(rng, n, bbox):
    """Points inside, outside every side, on xmax/ymax and xmin/ymin,
    at +-1e30 and NaN."""
    xmin, ymin, xmax, ymax = bbox
    wx, wy = xmax - xmin, ymax - ymin
    x = rng.uniform(xmin - wx, xmax + wx, n)
    y = rng.uniform(ymin - wy, ymax + wy, n)
    k = n // 10
    x[:k], y[:k] = xmax, rng.uniform(ymin, ymax, k)
    x[k:2 * k], y[k:2 * k] = rng.uniform(xmin, xmax, k), ymax
    x[2 * k:2 * k + 5] = [1e30, -1e30, np.inf, -np.inf, np.nan]
    y[2 * k + 5:2 * k + 10] = [1e30, -1e30, np.inf, -np.inf, np.nan]
    x[2 * k + 10], y[2 * k + 10] = xmin, ymin
    x[2 * k + 11], y[2 * k + 11] = xmax, ymax
    return x, y


def _plain(x, y, mask, bbox, width, height, w=None):
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (x, y)]
    wt = None if w is None else torch.from_numpy(np.asarray(w, np.float32))
    return kernels.density_grid_plain(
        t[0], t[1], wt, torch.from_numpy(np.asarray(mask, bool)), xmin, ymin,
        sx, sy, width, height).numpy()


def _cell_bound(x, y, mask, w, bbox, width, height):
    """Per cell 2 * n_cell * 2^-24 * sum |w| over the cell's rows: the
    reach of f32 sums of those weights taken in another order."""
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    cells = kernels.density_cells_plain(
        torch.from_numpy(np.asarray(x, np.float32)),
        torch.from_numpy(np.asarray(y, np.float32)), xmin, ymin, sx, sy,
        width, height).numpy()[mask]
    n_cell = np.bincount(cells, minlength=width * height)
    abs_w = np.bincount(cells, np.abs(np.asarray(w, np.float64)[mask]),
                        minlength=width * height)
    return (2 * n_cell * 2.0**-24 * abs_w).reshape(height, width)


BBOXES = [(-10.0, -5.0, 30.0, 25.0), (0.1, 0.2, 0.7, 0.9),
          (-180.0, -90.0, 180.0, 90.0), (5.0, 5.0, 5.0, 9.0),
          (3.0, -1.0, 3.0, -1.0), (-1e-3, 7.0, 2e-3, 7.000001)]


@pytest.mark.parametrize("bbox", BBOXES)
@pytest.mark.parametrize("width,height", [(1, 1), (13, 7), (256, 256)])
@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_density_plain_exact(bbox, width, height, weights):
    rng = np.random.default_rng(width * height + len(weights))
    n = 20_000
    x, y = _edge_points(rng, n, bbox)
    mask = rng.random(n) < 0.9
    w = None if weights == "unit" else rng.integers(-50, 200, n).astype(
        np.float32)
    got = _plain(x, y, mask, bbox, width, height, w)
    want = jagg.density_grid(x, y, mask, bbox, width, height, w)
    assert np.array_equal(got, want)
    # the port's entry point on CPU tensors takes the same plain path
    assert np.array_equal(aggregations.density_grid(
        x, y, mask, bbox, width, height, w, device="cpu"), want)


@pytest.mark.parametrize("bbox", BBOXES[:3])
def test_density_plain_fractional_within_bound(bbox):
    rng = np.random.default_rng(5)
    n, width, height = 50_000, 31, 17
    x, y = _edge_points(rng, n, bbox)
    mask = rng.random(n) < 0.8
    w = rng.uniform(-2.0, 7.0, n).astype(np.float32)
    got = _plain(x, y, mask, bbox, width, height, w)
    want = jagg.density_grid(x, y, mask, bbox, width, height, w)
    bound = _cell_bound(x, y, mask, w, bbox, width, height)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_density_conversion_saturates_like_xla():
    """The f32 -> int32 step: NaN reads 0, +-inf and values past the
    int32 range saturate, as XLA's CPU conversion does (here through
    the whole reference function, one point per case)."""
    cases = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e30, -1e30, 2**31]
    for v in cases:
        x = np.array([v, 0.5], np.float64)
        y = np.array([0.5, v], np.float64)
        for bbox in ((0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0)):
            got = _plain(x, y, np.ones(2, bool), bbox, 5, 4)
            assert np.array_equal(
                got, jagg.density_grid(x, y, np.ones(2, bool), bbox, 5, 4))


def test_density_every_row_in_one_cell():
    n = 70_000
    x = np.full(n, 2.5)
    y = np.full(n, -1.25)
    mask = np.ones(n, bool)
    got = _plain(x, y, mask, (0, -2, 4, 0), 8, 8)
    assert np.array_equal(got, jagg.density_grid(x, y, mask, (0, -2, 4, 0),
                                                 8, 8))
    assert got.max() == n


def test_density_no_rows():
    e = np.zeros(0)
    got = _plain(e, e, np.zeros(0, bool), (0, 0, 1, 1), 3, 2)
    assert np.array_equal(got, jagg.density_grid(e, e, np.zeros(0, bool),
                                                 (0, 0, 1, 1), 3, 2))


def test_density_wrapper_checks():
    x = torch.zeros(4)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="grid"):
        kernels.density_grid(x, x, None, m, 0, 0, 1, 1, 0, 3)
    with pytest.raises(ValueError, match="grid"):
        kernels.density_grid(x, x, None, m, 0, 0, 1, 1, 2**16, 2**15)
    with pytest.raises(ValueError, match="float32"):
        kernels.density_grid(x.double(), x, None, m, 0, 0, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="length"):
        kernels.density_grid(x, x[:3], None, m, 0, 0, 1, 1, 2, 2)
    kernels.reset_launches()
    kernels.density_grid(x, x, None, m, 0, 0, 1, 1, 2, 2)
    assert kernels.launches["density_grid"] == 0   # the plain version ran


# -- BIN encoders and sampling, byte for byte ------------------------------------

@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("labeled", [False, True])
@pytest.mark.parametrize("track", [False, True])
def test_encode_bin_records_bytes(sort, labeled, track):
    rng = np.random.default_rng(11)
    n = 500
    ids = np.array([f"id-{i}-é" for i in range(n)], dtype=object)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = rng.integers(-10**12, 2 * 10**12, n)
    labels = (np.array([f"label{i % 17}xyzw" if i % 5 else None
                        for i in range(n)], dtype=object) if labeled else None)
    tv = (np.array([f"t{i % 9}" for i in range(n)], dtype=object)
          if track else None)
    got = aggregations.encode_bin_records(ids, x, y, ms, labels, tv, sort)
    assert got == jagg.encode_bin_records(ids, x, y, ms, labels, tv, sort)
    chunks = [got[:160 if not labeled else 240], got[160 if not labeled
                                                     else 240:]]
    assert (aggregations.merge_sorted_bin_chunks(chunks, labeled)
            == jagg.merge_sorted_bin_chunks(chunks, labeled))
    assert np.array_equal(aggregations.decode_bin_records(got, labeled),
                          jagg.decode_bin_records(got, labeled))


def test_id_hashes_match_java():
    ids = np.array(["test", "", "a" * 40, "ünïcode", "f123456", "中"],
                   dtype=object)
    got = aggregations._id_hashes(ids)
    assert got.tobytes() == jagg._id_hashes(ids).tobytes()
    assert int(got[0]) == 3556498


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.25, 0.1, 0.013, 1e-12])
@pytest.mark.parametrize("grouped", [False, True])
def test_sample_mask_bytes(rate, grouped):
    rng = np.random.default_rng(2)
    n = 1_001
    by = (np.array([f"g{v}" for v in rng.integers(0, 7, n)])
          if grouped else None)
    got = aggregations.sample_mask(n, rate, by)
    assert got.tobytes() == jagg.sample_mask(n, rate, by).tobytes()
