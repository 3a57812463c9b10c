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
- ``kernels.density_grid_rows_plain`` (the rows loader's plain
  version: a query result's row ids into the store's device columns)
  against the reference's ``density_grid`` on the same seeded rows,
  selected by ids and cast as the JAX store casts them: Integer and Long
  weights past 2^24 and 2^53 (a Long rounds to f64, then to f32), null
  weights and points, NaN and +-inf coordinates, a degenerate bbox, an
  empty id list. Same tolerance.
- The port store's ``density()`` (ids into device columns) against the
  JAX store's on a tile, the world and a 1x1 grid, unweighted and
  weighted by an Integer and a Double column, after an append and after
  a delete, and with attribute-level visibility.
- ``encode_bin_*``, ``_id_hashes`` and ``sample_mask`` byte for byte.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.index.api import QueryHints as JQueryHints
from geomesa_tpu.scan import aggregations as jagg
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.features.batch import (BoolColumn, NumericColumn,
                                              PointColumn)
from geomesa_tpu_torch.index.api import QueryHints
from geomesa_tpu_torch.scan import aggregations, kernels, residual

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


# -- the rows loader's plain version against the reference ----------------------

ROW_SPEC = "wi:Integer,wl:Long,wd:Double,wb:Boolean,*geom:Point"


def _row_batch(n, seed, bbox):
    """A seeded batch of ``n`` rows: edge points around ``bbox`` with a
    twentieth null (NaN), Integer weights up to 2^31 - 1 (past 2^24),
    Long weights past 2^53 on a third of the rows, Double and Boolean
    weights, each about 5 % null."""
    rng = np.random.default_rng(seed)
    x, y = _edge_points(rng, n, bbox)
    null = rng.random(n) < 0.05
    x[null] = np.nan
    wi = rng.integers(-50, 200, n)
    wi[::7] = rng.integers(2**24, 2**31 - 1, len(wi[::7]))
    wl = rng.integers(-1000, 1000, n)
    wl[::3] = rng.integers(-2**62, 2**62, len(wl[::3]))
    valid = lambda: rng.random(n) >= 0.05   # noqa: E731
    batch = FeatureBatch(parse_spec("r", ROW_SPEC),
                         np.arange(n).astype(str).astype(object), {
        "wi": NumericColumn("wi", wi, valid()),
        "wl": NumericColumn("wl", wl, valid()),
        "wd": NumericColumn("wd", rng.uniform(-3.0, 7.0, n), valid()),
        "wb": BoolColumn("wb", rng.random(n) < 0.5, valid()),
        "geom": PointColumn("geom", x, y, ~(np.isnan(x) | np.isnan(y)))})
    return batch


def _reference_rows(batch, rows, attr, bbox, width, height):
    """The reference's grid of ``rows`` as the JAX store computes it:
    the point columns with null points at the bbox corner, masked; the
    weights ``where(valid, values, 0.0).astype(float32)``, masked when
    null. Also the (x, y, mask, w) it binned."""
    col = batch.col("geom")
    x, y, mask = col.x[rows], col.y[rows], col.valid[rows].copy()
    w = None
    if attr is not None:
        wcol = batch.col(attr)
        w = np.where(wcol.valid[rows], wcol.values[rows], 0.0).astype(
            np.float32)
        mask &= wcol.valid[rows]
    x = np.where(col.valid[rows], x, bbox[0])
    y = np.where(col.valid[rows], y, bbox[1])
    return jagg.density_grid(x, y, mask, bbox, width, height, w), (x, y, mask,
                                                                   w)


def _rows_plain(batch, rows, attr, bbox, width, height):
    cols = residual.DeviceColumns(batch, "cpu")
    weight = None if attr is None else (cols.get(attr)["kind"],
                                        cols.get(attr)["slot"])
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    return kernels.density_grid_rows_plain(
        torch.from_numpy(rows.astype(np.int32)), cols.get("geom")["slot"],
        weight, xmin, ymin, sx, sy, width, height).numpy()


@pytest.mark.parametrize("attr", [None, "wi", "wl", "wd", "wb"])
@pytest.mark.parametrize("bbox", [BBOXES[0], BBOXES[3], BBOXES[4]])
@pytest.mark.parametrize("width,height", [(1, 1), (13, 7), (256, 256)])
def test_density_rows_plain_matches_reference(attr, bbox, width, height):
    """Seeded rows selected by ascending ids (a random ninth left out):
    unit, Boolean and small-integer cells exact; cells of Integer weights
    past 2^24, of Long weights and of Doubles within the bound."""
    n = 12_000
    batch = _row_batch(n, width + height + len(str(attr)), bbox)
    rows = np.flatnonzero(np.random.default_rng(3).random(n) < 8 / 9)
    got = _rows_plain(batch, rows, attr, bbox, width, height)
    want, (x, y, mask, w) = _reference_rows(batch, rows, attr, bbox, width,
                                            height)
    assert got.dtype == np.float32 and got.shape == (height, width)
    if attr in (None, "wb"):
        assert np.array_equal(got, want)
        return
    bound = _cell_bound(x, y, mask, w, bbox, width, height)
    if attr == "wi":
        # cells whose integer weights sum |w| under 2^24 are exact
        xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
        cells = kernels.density_cells_plain(
            torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.float32)), xmin, ymin, sx, sy, width,
            height).numpy()[mask]
        abs_w = np.bincount(cells, np.abs(w[mask].astype(np.float64)),
                            minlength=width * height).reshape(height, width)
        bound = np.where(abs_w < 2**24, 0.0, bound)
        assert (abs_w >= 2**24).any()
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_density_rows_long_weights_round_through_f64():
    """Long weights each alone in a cell, past 2^53: the grid holds each
    weight rounded to f64 and then to f32, exactly as the reference's
    cast (2^60 + 2^36 + 1 becomes 2^60, where one rounding would give
    2^60 + 2^37)."""
    v = np.array([2**60 + 2**36 + 1, -(2**60 + 2**36 + 1), 2**53 + 1,
                  2**63 - 1, -2**63, 3 * 2**55 + 2**31 + 7, 5, 0])
    n = len(v)
    batch = FeatureBatch(parse_spec("r", "wl:Long,*geom:Point"),
                         np.arange(n).astype(str).astype(object), {
        "wl": NumericColumn("wl", v, np.ones(n, bool)),
        "geom": PointColumn("geom", np.arange(n) + 0.5, np.full(n, 0.5),
                            np.ones(n, bool))})
    bbox = (0.0, 0.0, float(n), 1.0)
    rows = np.arange(n)
    got = _rows_plain(batch, rows, "wl", bbox, n, 1)
    want, _ = _reference_rows(batch, rows, "wl", bbox, n, 1)
    assert np.array_equal(got, want)
    assert got[0, 0] == np.float32(2.0**60)
    assert np.float32(v[0]) != got[0, 0]          # one rounding differs


def test_density_rows_empty_ids():
    batch = _row_batch(100, 1, BBOXES[0])
    for attr in (None, "wi"):
        got = _rows_plain(batch, np.zeros(0, np.int64), attr, BBOXES[0], 5, 3)
        want, _ = _reference_rows(batch, np.zeros(0, np.int64), attr,
                                  BBOXES[0], 5, 3)
        assert np.array_equal(got, want) and not got.any()


# -- the port store's density() against the JAX store's ---------------------------

DENSITY_SPEC = "wi:Integer,wd:Double,dtg:Date,*geom:Point"
T0 = MS("2020-01-01")


def _density_rows(rng, lo, hi):
    n = hi - lo
    x, y = rng.uniform(-179, 179, n), rng.uniform(-89, 89, n)
    x[::31] = np.nan
    return [f"d{i}" for i in range(lo, hi)], {
        "wi": [None if i % 17 == 0 else int(v)
               for i, v in enumerate(rng.integers(-20, 500, n))],
        "wd": np.where(rng.random(n) < 0.05, np.nan, rng.uniform(-5, 5, n)),
        "dtg": T0 + rng.integers(0, 60 * 86_400_000, n),
        "geom": (x, y)}


DENSITY_CASES = [
    ("tile", "BBOX(geom, -30, -20, 10, 25) AND dtg DURING "
     "2020-01-05T00:00:00Z/2020-02-10T00:00:00Z", (-30, -20, 10, 25), 64, 48),
    ("world", "dtg DURING 2020-01-03T00:00:00Z/2020-02-20T00:00:00Z",
     (-180, -90, 180, 90), 360, 180),
    ("world_1x1", "INCLUDE", (-180, -90, 180, 90), 1, 1)]


@pytest.fixture(scope="module")
def density_stores():
    """A port store on the CPU and a JAX store, written alike, with the
    rows written so far kept for the bound."""
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    rng = np.random.default_rng(23)
    ids, data = _density_rows(rng, 0, 15_000)
    for ds in (port, ref):
        ds.create_schema("d", DENSITY_SPEC)
        ds.write_dict("d", ids, data)
    return port, ref, rng


def _check_store_density(port, ref, stage):
    for name, ecql, bbox, w, h in DENSITY_CASES:
        for attr in (None, "wi", "wd"):
            got = port.density("d", ecql, bbox, w, h, attr)
            want = ref.density("d", ecql, bbox, w, h, attr)
            assert got.dtype == np.float32 and got.shape == (h, w)
            if attr != "wd":
                assert np.array_equal(got, want), (stage, name, attr)
                continue
            res = ref.query(JQuery("d", ecql))
            col, wcol = res.batch.col("geom"), res.batch.col("wd")
            mask = col.valid & wcol.valid
            bound = _cell_bound(np.where(mask, col.x, 0.0),
                                np.where(mask, col.y, 0.0), mask,
                                np.where(mask, wcol.values, 0.0), bbox, w, h)
            assert np.all(np.abs(got.astype(np.float64) - want) <= bound), (
                stage, name)


def test_store_density_matches_reference_through_writes(density_stores):
    """density() on the tile, the world and a 1x1 grid, unweighted and
    weighted by Integer (exact) and Double (within the bound), after the
    first write, after an append (the device columns dropped and
    uploaded again) and after a delete."""
    port, ref, rng = density_stores
    _check_store_density(port, ref, "written")
    ids, data = _density_rows(rng, 15_000, 20_000)
    for ds in (port, ref):
        ds.write_dict("d", ids, data)
    _check_store_density(port, ref, "appended")
    gone = [f"d{i}" for i in rng.choice(20_000, 1_000, replace=False)]
    for ds in (port, ref):
        ds.delete("d", gone)
    _check_store_density(port, ref, "deleted")
    assert port.count("d") == 19_000


def test_store_density_attribute_visibility():
    """Attribute-level visibility: a row whose point or weight is hidden
    from the (empty) auths drops out of the grid, as in the JAX store."""
    spec = ("wi:Integer,*geom:Point;geomesa.visibility.level='attribute'")
    rng = np.random.default_rng(4)
    n = 3_000
    labels = np.array([",", "a,", ",a", "a,a"], dtype=object)[
        rng.integers(0, 4, n)]
    data = {"wi": rng.integers(0, 100, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    ids = [f"v{i}" for i in range(n)]
    stores = []
    for ds in (InMemoryDataStore(device="cpu"), JaxStore()):
        ds.create_schema("v", spec)
        ds.write_dict("v", ids, data, visibilities=labels)
        stores.append(ds)
    for attr in (None, "wi"):
        got = stores[0].density("v", "INCLUDE", (-10, -10, 10, 10), 8, 8, attr)
        want = stores[1].density("v", "INCLUDE", (-10, -10, 10, 10), 8, 8,
                                 attr)
        assert np.array_equal(got, want)
        assert 0 < got.sum() < (n if attr is None else data["wi"].sum())


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
