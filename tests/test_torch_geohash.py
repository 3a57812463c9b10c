"""The port's geohash module (geohash/) against the JAX package's: the
known vectors and invariants of test_geohash.py, every function against
the JAX one on the same seeded inputs, the spiral cell for cell, and
knn_spiral_process against the JAX process.

Tolerance: exact. Hashes, bounding boxes, neighbour lists, coverings,
spiral cell sequences and KNN ids and distances are equal.

The CPU tests import the JAX package inside their bodies, so the GPU
case runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_geohash.py``."""

import math

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.analytics import processes as tp
from geomesa_tpu_torch.geohash import (BoundedNearestNeighbors, GeoHash,
                                       GeoHashSpiral, _dist2_to_bbox,
                                       covering, decode, decode_bbox, encode,
                                       neighbors, precision_for_radius)


def _jgh():
    import geomesa_tpu.geohash as jgh
    return jgh


# -- the vectors and invariants of test_geohash.py ---------------------------

def test_known_values():
    assert encode(-5.6, 42.6, 5) == "ezs42"
    assert encode(-0.1262, 51.5001, 9)[:6] == "gcpuvp"
    assert encode(13.361389, 38.115556, 9)[:5] == "sqc8b"
    assert encode(0.0, 0.0, 1) == "s"
    cx, cy = decode("ezs42")
    assert cx == pytest.approx(-5.6, abs=0.03)
    assert cy == pytest.approx(42.6, abs=0.03)


def test_prefix_nesting_and_cell():
    gh = encode(-75.3, 38.2, 8)
    for p in range(1, 8):
        assert gh[:p] == encode(-75.3, 38.2, p)
        o, i = decode_bbox(gh[:p]), decode_bbox(gh[:p + 1])
        assert o[0] <= i[0] and o[1] <= i[1] and o[2] >= i[2] \
            and o[3] >= i[3]
    cell = GeoHash(gh)
    assert cell.precision == 8 and cell.bbox == decode_bbox(gh)
    assert cell.center == decode(gh)


def test_neighbours_wrap_and_clip():
    assert len(neighbors("ezs42")) == 8
    assert any(decode_bbox(h)[0] < -179
               for h in neighbors(encode(179.9, 0.0, 4)))
    assert len(neighbors(encode(0.0, 89.9, 4))) == 5


def test_spiral_distance_order_and_bounded_nn():
    spiral = GeoHashSpiral(10.0, 20.0, 4)
    spiral.update_max_distance(2.0)
    cells = list(spiral)
    d = [_dist2_to_bbox(10.0, 20.0, decode_bbox(c)) for c in cells]
    assert len(cells) > 1 and d == sorted(d)
    assert cells[0] == encode(10.0, 20.0, 4)
    nn = BoundedNearestNeighbors(3)
    for dist, i in [(5.0, "a"), (1.0, "b"), (3.0, "c"), (0.5, "d"),
                    (9.0, "e")]:
        nn.offer(dist, i)
    assert [i for _, i in nn.result()] == ["d", "b", "c"]
    assert nn.max_distance == 3.0 and nn.full


def test_precision_for_radius_cell_width():
    for r in (10.0, 1.0, 0.1, 0.01):
        p = precision_for_radius(r)
        assert 360.0 / (1 << math.ceil(5 * p / 2)) >= r


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("precision", [1, 2, 5, 7, 9, 12])
def test_encode_matches_reference(precision):
    jgh = _jgh()
    rng = np.random.default_rng(precision)
    lon = rng.uniform(-180, 180, 2_000)
    lat = rng.uniform(-90, 90, 2_000)
    # the edges: poles, antimeridian, zero, just inside the world
    lon[:8] = [-180.0, 180.0, 0.0, -0.0, 179.99999999, -179.9999999,
               1e-300, 360.0]
    lat[:8] = [-90.0, 90.0, 0.0, -0.0, 89.9999999, -89.9999999, -1e-300,
               -100.0]
    got, want = encode(lon, lat, precision), jgh.encode(lon, lat, precision)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for i in range(0, 2_000, 331):
        assert encode(float(lon[i]), float(lat[i]), precision) == \
            jgh.encode(float(lon[i]), float(lat[i]), precision) == got[i]


def test_decode_matches_reference():
    jgh = _jgh()
    rng = np.random.default_rng(3)
    hashes = encode(rng.uniform(-180, 180, 300), rng.uniform(-90, 90, 300),
                    10)
    for h in hashes:
        for p in (1, 4, 10):
            assert decode_bbox(h[:p]) == jgh.decode_bbox(h[:p])
            assert decode(h[:p]) == jgh.decode(h[:p])
        for bits in (None, 0, 1, 7, 13, 24, 49, 50, 51):
            assert decode_bbox(h, bits) == jgh.decode_bbox(h, bits)
    assert decode_bbox("EZS42") == jgh.decode_bbox("EZS42")
    with pytest.raises(KeyError):
        decode_bbox("ezs4a")


def test_neighbours_match_reference():
    jgh = _jgh()
    rng = np.random.default_rng(4)
    xs = np.concatenate([rng.uniform(-180, 180, 150), [179.9, -179.9, 0.0,
                                                       0.0, 179.9]])
    ys = np.concatenate([rng.uniform(-90, 90, 150), [0.0, 0.0, 89.9,
                                                     -89.9, 89.9]])
    for p in (1, 2, 3, 6):
        for x, y in zip(xs, ys):
            h = encode(float(x), float(y), p)
            assert neighbors(h) == jgh.neighbors(h)


@pytest.mark.parametrize("box,precision", [
    ((-80, 30, -79, 31), 4), ((-180, -90, 180, 90), 2),
    ((170.5, -3.2, 179.99, 2.7), 3), ((0, 0, 0, 0), 6),
    ((-1e-9, -1e-9, 1e-9, 1e-9), 7), ((-30, -20, 40, 35), 3)])
def test_covering_matches_reference(box, precision):
    jgh = _jgh()
    got = covering(*box, precision)
    assert got == jgh.covering(*box, precision)
    rng = np.random.default_rng(5)
    for _ in range(50):
        x = float(rng.uniform(box[0], box[2]))
        y = float(rng.uniform(box[1], box[3]))
        assert encode(x, y, precision) in got


def test_covering_limit_matches_reference():
    jgh = _jgh()
    with pytest.raises(ValueError) as jexc:
        jgh.covering(-180, -90, 180, 90, 6)
    with pytest.raises(ValueError) as exc:
        covering(-180, -90, 180, 90, 6)
    assert str(exc.value) == str(jexc.value)


def test_precision_for_radius_matches_reference():
    jgh = _jgh()
    for r in np.concatenate([np.geomspace(1e-6, 400.0, 200), [0.0, -1.0]]):
        assert precision_for_radius(float(r)) == \
            jgh.precision_for_radius(float(r))


@pytest.mark.parametrize("x,y,precision,cut_every", [
    (10.0, 20.0, 4, 3), (179.95, 0.5, 3, 5), (-0.01, 89.99, 4, 2),
    (-122.4, 37.7, 6, 7), (0.0, 0.0, 2, 1)])
def test_spiral_matches_reference_cell_for_cell(x, y, precision, cut_every):
    """Both spirals walk the same cells in the same order, with the cut
    tightened every ``cut_every`` cells as a KNN would."""
    jgh = _jgh()
    a, b = GeoHashSpiral(x, y, precision), jgh.GeoHashSpiral(x, y,
                                                             precision)
    radius = 40.0
    seq_a, seq_b = [], []
    for i in range(400):
        ca, cb = next(a, None), next(b, None)
        seq_a.append(ca)
        seq_b.append(cb)
        if ca is None or cb is None:
            break
        if i % cut_every == cut_every - 1:
            radius *= 0.8
            a.update_max_distance(radius)
            b.update_max_distance(radius)
    assert seq_a == seq_b and len(seq_a) > 3
    assert seq_a[-1] is None   # the cut ended both walks


def test_bounded_nn_matches_reference():
    jgh = _jgh()
    rng = np.random.default_rng(6)
    for k in (1, 4, 30):
        a, b = BoundedNearestNeighbors(k), jgh.BoundedNearestNeighbors(k)
        for i, d in enumerate(rng.integers(0, 50, 200).astype(float)):
            a.offer(float(d), f"i{i}")
            b.offer(float(d), f"i{i}")
            assert a.max_distance == b.max_distance and a.full == b.full
        assert a.result() == b.result()


@pytest.fixture(scope="module")
def pts():
    from geomesa_tpu.store import InMemoryDataStore as JaxStore
    rng = np.random.default_rng(3)
    n = 3_000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    x[100:140], y[100:140] = x[:40], y[:40]      # distance ties
    out = []
    for ds in (InMemoryDataStore(device="cpu"), JaxStore()):
        ds.create_schema("pts", "name:String,*geom:Point:srid=4326")
        ds.write_dict("pts", [f"p{i}" for i in range(n)],
                      {"name": ["x"] * n, "geom": (x, y)})
        out.append(ds)
    return out


@pytest.mark.parametrize("qx,qy,k,est", [
    (1.0, 2.0, 10, 0.5), (0.0, 0.0, 1, 1.0), (9.9, -9.9, 25, 0.2),
    (30.0, 30.0, 5, 3.0), (-3.3, 4.4, 60, 0.05), (5.0, 5.0, 3, 8.0)])
def test_knn_spiral_process_matches_reference(pts, qx, qy, k, est):
    from geomesa_tpu.analytics import processes as jp
    port, ref = pts
    ids, d = tp.knn_spiral_process(port, "pts", qx, qy, k,
                                   estimated_distance=est)
    jids, jd = jp.knn_spiral_process(ref, "pts", qx, qy, k,
                                     estimated_distance=est)
    assert list(ids.astype(str)) == list(jids.astype(str))
    assert np.array_equal(d, jd) and len(d) == k
    # the kernel KNN's distances are sqrt(dx*dx + dy*dy), the spiral's
    # np.hypot: the two may differ in the last bit
    _, kd = tp.knn_process(port, "pts", qx, qy, k)
    assert np.allclose(np.sort(kd), d, rtol=1e-15, atol=0)


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_spiral_and_sql_join_on_cuda():
    """knn_spiral_process runs its BBOX queries through the scan kernels
    on a CUDA store, and a SQL COUNT(*) DWithin join reaches the join
    kernel with the store's resident columns; both against f64 brute
    force."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.sql import SqlEngine
    rng = np.random.default_rng(12)
    n = 100_000
    x, y = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    qx, qy = rng.uniform(-20, 20, 300), rng.uniform(-20, 20, 300)
    ds = InMemoryDataStore()
    ds.create_schema("pts", "*geom:Point:srid=4326")
    ds.write_dict("pts", [f"p{i}" for i in range(n)], {"geom": (x, y)})
    ds.create_schema("q", "*geom:Point:srid=4326")
    ds.write_dict("q", [f"q{i}" for i in range(300)], {"geom": (qx, qy)})
    from geomesa_tpu_torch.utils.properties import SystemProperty
    host_rows = SystemProperty("geomesa.scan.host.rows")
    kernels.reset_launches()
    host_rows.set("0")        # every cell's BBOX through a scan kernel
    try:
        ids, d = tp.knn_spiral_process(ds, "pts", 1.5, -2.5, 40,
                                       estimated_distance=0.3)
    finally:
        host_rows.set(None)
    assert kernels.launches["scan_mask"] \
        + kernels.launches["scan_mask_gather"] > 0
    dist = np.hypot(x - 1.5, y + 2.5)
    want = np.sort(dist)[:40]
    assert np.array_equal(d, want)
    assert set(ids.astype(str)) == {f"p{i}" for i in np.argsort(dist)[:40]}
    kernels.reset_launches()
    res = SqlEngine(ds).query("SELECT count(*) AS n FROM pts a JOIN q b "
                              "ON ST_DWithin(a.geom, b.geom, 0.25)")
    assert kernels.launches["dwithin_counts"] == 1
    d2 = (x[:, None] - qx[None, :]) ** 2 + (y[:, None] - qy[None, :]) ** 2
    assert int(res.column("n")[0]) == int((d2 <= 0.0625).sum())
