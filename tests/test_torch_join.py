"""The port's spatial joins and KNN (analytics/join.py, utils/fp.py,
zscan.stack_points, and the plain versions of the four join kernels)
against the JAX package's analytics/join.py on the CPU, on the same
seeded numpy inputs: 20k-point clouds with duplicated coordinates,
points on thresholds and polygon edges, holes, multipolygons, a band
that overflows its cap, capacity-padded device columns.

Tolerance: exact everywhere. Counts, pairs, ids and f64 distances are
equal arrays in the same order; so are the kernels' f32 intermediates
(definite and band counts, candidate pairs, polygon counts and band
rows, the knn window's d2 bits and rows) against the JAX package's
jitted programs."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.analytics import join as jj
from geomesa_tpu.geometry import parse_wkt as jwkt
from geomesa_tpu.scan import zscan as jzscan
from geomesa_tpu.utils import fp as jfp
from geomesa_tpu_torch.analytics import join as tj
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan import kernels, zscan
from geomesa_tpu_torch.scan.gscan import EDGE_EPS, EDGE_EPS2
from geomesa_tpu_torch.utils import fp

CPU = "cpu"


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(7)
    n = 20_000
    px = rng.uniform(-180, 180, n)
    py = rng.uniform(-90, 90, n)
    # duplicate coordinates: distance ties across distinct ids
    px[1000:1200] = px[:200]
    py[1000:1200] = py[:200]
    return px, py


def _padded(px, py, pad, fill):
    """(torch, jax) f32 device columns of (px, py) with ``pad`` padding
    rows at ``fill``."""
    x = np.concatenate([px, np.full(pad, fill[0])]).astype(np.float32)
    y = np.concatenate([py, np.full(pad, fill[1])]).astype(np.float32)
    return ((torch.from_numpy(x), torch.from_numpy(y)),
            (jnp.asarray(x), jnp.asarray(y)))


def _rect(cx, cy, w, h):
    return (f"POLYGON(({cx - w} {cy - h}, {cx + w} {cy - h}, {cx + w} "
            f"{cy + h}, {cx - w} {cy + h}, {cx - w} {cy - h}))")


def _star(cx, cy, r1, r2, k, hole=None):
    a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
    r = np.where(np.arange(2 * k) % 2 == 0, r1, r2)
    pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a)]
    rings = [np.vstack([pts, pts[:1]])]
    if hole:
        h = np.array([[cx - hole, cy - hole], [cx + hole, cy - hole],
                      [cx + hole, cy + hole], [cx - hole, cy + hole],
                      [cx - hole, cy - hole]])
        rings.append(h)
    return "POLYGON(" + ", ".join(
        "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in r) + ")"
        for r in rings) + ")"


POLYGONS = [
    _rect(0.0, 0.0, 20.0, 20.0),
    "POLYGON((-60 -40, 60 -40, 60 40, -60 40, -60 -40), "
    "(-20 -20, 20 -20, 20 20, -20 20, -20 -20))",
    "MULTIPOLYGON(((-170 -80, -120 -80, -120 -30, -170 -30, -170 -80)), "
    "((120 30, 170 30, 170 80, 120 80, 120 30), "
    "(130 40, 160 40, 160 70, 130 70, 130 40)))",
    _star(50.0, -20.0, 30.0, 12.0, 7, hole=4.0),
    _rect(100.0, 50.0, 10.0, 10.0),
    _rect(179.0, 89.0, 0.5, 0.5),
    "POLYGON((200 200, 201 200, 201 201, 200 201, 200 200))",
]


def _polys(wkts):
    return [jwkt(w) for w in wkts], [parse_wkt(w) for w in wkts]


# -- fp and stack_points ---------------------------------------------------

@pytest.mark.parametrize("r", [0.0, 1e-9, 1e-4, 0.25, 3.0, 90.0])
@pytest.mark.parametrize("span", [1.0, 360.0])
def test_f32_band_matches_reference(r, span):
    assert fp.f32_band(r, span) == jfp.f32_band(r, span)


@pytest.mark.parametrize("nq,min_batch", [(1, 1), (3, 1), (8, 1), (9, 1),
                                          (2, 16)])
def test_stack_points_matches_reference(nq, min_batch):
    rng = np.random.default_rng(nq)
    qx, qy = rng.uniform(-180, 180, nq), rng.uniform(-90, 90, nq)
    got = zscan.stack_points(qx, qy, min_batch)
    want = jzscan.stack_points(qx, qy, min_batch)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype == np.float32


def test_stack_points_refuses_what_the_reference_refuses():
    for args in ((np.zeros(2), np.zeros(3)), (np.zeros(0), np.zeros(0))):
        with pytest.raises(ValueError):
            jzscan.stack_points(*args)
        with pytest.raises(ValueError):
            zscan.stack_points(*args)


# -- dwithin ----------------------------------------------------------------

@pytest.mark.parametrize("counts_only", [True, False])
@pytest.mark.parametrize("radius", [0.5, 3.0, 40.0])
def test_dwithin_join_matches_reference(cloud, counts_only, radius):
    px, py = cloud
    rng = np.random.default_rng(int(radius * 10))
    qx, qy = rng.uniform(-170, 170, 64), rng.uniform(-80, 80, 64)
    got = tj.dwithin_join(px, py, qx, qy, radius, counts_only=counts_only,
                          device=CPU)
    want = jj.dwithin_join(px, py, qx, qy, radius, counts_only=counts_only)
    assert np.array_equal(got[0], want[0])
    if counts_only:
        assert got[1] is None and want[1] is None
    else:
        assert np.array_equal(got[1], want[1])
        d2 = (px[:, None] - qx) ** 2 + (py[:, None] - qy) ** 2
        assert np.array_equal(got[0], (d2 <= radius * radius).sum(axis=0))


@pytest.mark.parametrize("counts_only", [True, False])
def test_dwithin_threshold_boundary(counts_only):
    """A point exactly at the radius is in (closed), its neighbour 1e-6
    beyond is out (test_analytics.py:90)."""
    px, py = np.array([3.0, 3.000001]), np.array([4.0, 4.0])
    got = tj.dwithin_join(px, py, np.array([0.0]), np.array([0.0]), 5.0,
                          counts_only=counts_only, device=CPU)
    want = jj.dwithin_join(px, py, np.array([0.0]), np.array([0.0]), 5.0,
                           counts_only=counts_only)
    assert got[0][0] == want[0][0] == 1
    if not counts_only:
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("counts_only", [True, False])
def test_dwithin_device_xy_padded(counts_only):
    """Capacity-padded resident columns (test_analytics.py:120): padded
    rows sit inside the query area and never match."""
    rng = np.random.default_rng(23)
    px, py = rng.uniform(-10, 10, 5_000), rng.uniform(-10, 10, 5_000)
    qx, qy = rng.uniform(-10, 10, 64), rng.uniform(-10, 10, 64)
    tdev, jdev = _padded(px, py, 1000, (0.0, 0.0))
    got = tj.dwithin_join(px, py, qx, qy, 0.5, counts_only=counts_only,
                          device_xy=tdev)
    want = jj.dwithin_join(px, py, qx, qy, 0.5, counts_only=counts_only,
                           device_xy=jdev)
    d2 = (px[:, None] - qx) ** 2 + (py[:, None] - qy) ** 2
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], (d2 <= 0.25).sum(axis=0))
    if not counts_only:
        assert np.array_equal(got[1], want[1])


def test_dwithin_empty_sides():
    one = np.array([1.0])
    for px, qx in ((np.empty(0), one), (one, np.empty(0))):
        for co in (True, False):
            got = tj.dwithin_join(px, px, qx, qx, 1.0, counts_only=co,
                                  device=CPU)
            want = jj.dwithin_join(px, px, qx, qx, 1.0, counts_only=co)
            assert np.array_equal(got[0], want[0])
            if not co:
                assert got[1].shape == want[1].shape == (0, 2)


@pytest.mark.parametrize("nrows", [20_000, 13_001, 0])
def test_dwithin_counts_plain_matches_reference(cloud, nrows):
    """J1's plain version against _dwithin_counts_all on the same f32
    columns (past nrows: capacity padding), definite and band counts."""
    px, py = cloud
    rng = np.random.default_rng(3)
    k = 256
    qx = rng.uniform(-170, 170, k).astype(np.float32)
    qy = rng.uniform(-80, 80, k).astype(np.float32)
    qx[:8], qy[:8] = px[:8] + 2.0, py[:8]   # rows on each band's edge
    r2_hi, r2_lo = fp.f32_band(2.0, 360.0)
    x32, y32 = px.astype(np.float32), py.astype(np.float32)
    got = kernels.dwithin_counts_plain(
        torch.from_numpy(x32), torch.from_numpy(y32), torch.from_numpy(qx),
        torch.from_numpy(qy), float(np.float32(r2_hi)),
        float(np.float32(r2_lo)), nrows)
    want = jj._dwithin_counts_all(
        jnp.asarray(x32), jnp.asarray(y32), jnp.asarray(qx[None]),
        jnp.asarray(qy[None]), jnp.ones((1, k), bool), np.float32(r2_hi),
        np.float32(r2_lo), np.int32(nrows))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0])[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1])[0])
    assert nrows == 0 or int(got[1].sum()) > 0


# -- the tile walk of the dwithin kernel -------------------------------------

def _adversarial_points(n, cap, seed):
    """f32 (x, y) of n seeded rows in a capacity of ``cap`` (padding rows
    at the origin, inside every query area): rows exactly on each
    query's slab edges are added by the caller; here rows near and at
    |x| = 180, at |x| = 1e6, NaN and +-inf coordinates, duplicates."""
    rng = np.random.default_rng(seed)
    x = np.zeros(cap, np.float32)
    y = np.zeros(cap, np.float32)
    x[:n] = rng.uniform(-180, 180, n)
    y[:n] = rng.uniform(-90, 90, n)
    x[:40] = np.float32(180.0) - rng.uniform(0, 1e-4, 40).astype(np.float32)
    x[40:60] = -180.0
    x[60:70], x[70:80] = 1e6, -1e6
    x[80:85], y[85:90] = np.nan, np.nan
    x[90:93], x[93:96] = np.inf, -np.inf
    y[96:99], y[99:102] = np.inf, -np.inf
    x[102:140], y[102:140] = x[140:178], y[140:178]
    return x, y


def _adversarial_queries(x, y, radius, k, seed):
    """k query points: seeded ones, ones exactly r away from rows in x
    (the band's edge) and in both, ones near 180 and at 1e6, NaN and
    +-inf coordinates, one far outside the table (an empty slab)."""
    rng = np.random.default_rng(seed)
    qx = rng.uniform(-170, 170, k).astype(np.float32)
    qy = rng.uniform(-80, 80, k).astype(np.float32)
    r = np.float32(radius)
    qx[0:4], qy[0:4] = x[200:204] + r, y[200:204]
    qx[4:8], qy[4:8] = x[204:208] - r, y[204:208]
    qx[8:10], qy[8:10] = x[208:210], y[208:210] + r
    qx[10:12], qy[10:12] = np.float32(179.99), x[20:22]
    qx[12], qy[12] = x[60], y[60]
    qx[13], qy[13] = np.float32(1e6) + np.float32(64), 0.0
    qx[14], qx[15], qx[16] = np.nan, np.inf, -np.inf
    qy[17], qy[18] = np.nan, np.inf
    qx[19] = 5e3
    qx[20], qy[20] = -180.0 - r, y[41]
    return qx, qy


DW_RADII = [0.0, 1e-6, 0.25, 90.0, 400.0]


@pytest.mark.parametrize("tile", [kernels.JOIN_TILE, 1, 5])
@pytest.mark.parametrize("radius", DW_RADII)
@pytest.mark.parametrize("n,cap", [(6_000, 6_000), (5_000, 6_144)])
def test_dwithin_tile_walk_matches_all_pairs(radius, tile, n, cap):
    """The dwithin kernel's decomposition (its own slabs, the tile lists,
    every column of a listed tile against each of its queries) on the
    x-sorted table equals the all-pairs plain version on the original
    columns and the reference's _dwithin_counts_all, bit for bit, on
    adversarial rows and queries, capacity padding past n and tiles of
    one column."""
    x, y = _adversarial_points(n, cap, seed=int(radius * 7) + tile)
    qx, qy = _adversarial_queries(x, y, radius, 48, seed=tile)
    r2_hi, r2_lo = (float(np.float32(v)) for v in fp.f32_band(radius, 360.0))
    t = [torch.from_numpy(a) for a in (x, y, qx, qy)]
    xs, ys, _ = tj._sorted_by_x(t[0], t[1], n)
    got = kernels.dwithin_counts_tiles_plain(xs, ys, t[2], t[3], r2_hi,
                                             r2_lo, tile)
    want = kernels.dwithin_counts_plain(*t, r2_hi, r2_lo, n)
    ref = jj._dwithin_counts_all(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(qx[None]),
        jnp.asarray(qy[None]), jnp.ones((1, len(qx)), bool),
        np.float32(r2_hi), np.float32(r2_lo), np.int32(n))
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(r)[0])
    assert int(want[0].sum() + want[1].sum()) > 0


def _passing_pairs(x, y, qx, qy, r2, n):
    """(row, query) index pairs whose stepwise f32 d2 <= r2."""
    with np.errstate(invalid="ignore", over="ignore"):
        dx = x[:n, None] - qx[None, :]
        dy = y[:n, None] - qy[None, :]
        d2 = dx * dx + dy * dy
    return np.nonzero(d2 <= np.float32(r2))


@pytest.mark.parametrize("r2_hi,r2_lo", [(0.0, 0.0), (1e-30, 0.0),
                                         (0.0625, 0.0624), (8100.0, 8099.0),
                                         (np.inf, 1.0), (np.nan, 4.0),
                                         (-1.0, -1.0)])
def test_dwithin_slabs_hold_every_passing_row(r2_hi, r2_lo):
    """Every row whose f32 d2 passes either threshold lies in its query's
    J1 slab, on rows a subnormal away from a query (dx*dx underflows to
    0), rows at 1e6 (ulp 0.0625) and +-180, NaN and +-inf rows and
    queries; an infinite threshold makes every slab the whole table."""
    n, cap = 4_000, 4_096
    x, y = _adversarial_points(n, cap, seed=3)
    x[300:304], y[300:304] = np.float32(1e-40), np.float32(2.0)
    x[304:308], y[304:308] = np.float32(1e6) + np.float32(0.0625), 0.0
    qx, qy = _adversarial_queries(x, y, 0.25, 40, seed=9)
    qx[30], qy[30] = 0.0, 2.0
    qx[31], qy[31] = np.float32(1e6), 0.0
    t = [torch.from_numpy(a) for a in (x, y, qx)]
    xs, ys, order = tj._sorted_by_x(t[0], t[1], n)
    los, widths = kernels.dwithin_slabs(xs, t[2], r2_hi, r2_lo)
    pos = np.empty(cap, np.int64)
    pos[order.numpy()] = np.arange(cap)
    lo, w = los.numpy().astype(np.int64), widths.numpy().astype(np.int64)
    assert ((lo >= 0) & (w >= 0) & (lo + w <= cap)).all()
    for r2 in (r2_hi, r2_lo):
        rows, q = _passing_pairs(x, y, qx, qy, r2, n)
        assert ((pos[rows] >= lo[q]) & (pos[rows] < lo[q] + w[q])).all()
    if np.isinf(r2_hi):
        assert (lo == 0).all() and (w == cap).all()
    elif r2_hi == 0.0:
        assert len(_passing_pairs(x, y, qx, qy, 0.0, n)[0]) >= 4
        assert w[14:17].sum() == 0   # non-finite qx: empty slabs


@pytest.mark.parametrize("tile", [1, 3, 2048])
def test_tile_lists_match_a_brute_force(tile):
    """Each tile lists, in ascending order, exactly the objects whose
    slab meets it; perm maps the tile-major entries to the object-major
    ones (each object's tiles in order), start to each object's first."""
    rng = np.random.default_rng(tile)
    ncols, k = 20_000, 300
    lo = rng.integers(0, ncols, k)
    w = np.minimum(rng.integers(0, 3_000, k), ncols - lo)
    w[:20] = 0
    w[20], lo[20] = ncols, 0          # the whole table
    w[21], lo[21] = 1, ncols - 1      # the last column
    lists = kernels.tile_lists(torch.from_numpy(lo.astype(np.int32)),
                               torch.from_numpy(w.astype(np.int32)), ncols,
                               tile)
    ntiles = -(-ncols // tile)
    want, om = [[] for _ in range(ntiles)], []
    for o in range(k):
        if w[o] > 0:
            for t in range(lo[o] // tile, (lo[o] + w[o] - 1) // tile + 1):
                want[t].append(o)
                om.append((o, t))
    off = lists.offsets.numpy()
    assert lists.ntiles == ntiles and off[0] == 0 and off[-1] == lists.total
    assert lists.total == len(om)
    assert lists.most == max(len(v) for v in want)
    objs, tiles = lists.objs.numpy(), lists.tiles.numpy()
    for t in range(ntiles):
        assert list(objs[off[t]:off[t + 1]]) == want[t]
        assert (tiles[off[t]:off[t + 1]] == t).all()
    om = np.array(om)
    perm = lists.perm.numpy()
    assert np.array_equal(om[perm, 0], objs) and np.array_equal(om[perm, 1],
                                                                tiles)
    live = np.flatnonzero(w > 0)
    assert np.array_equal(om[lists.start.numpy()[live], 0], live)


def test_tile_lists_of_nothing():
    for los, widths, ncols in (([], [], 100), ([5], [0], 100), ([0], [0], 0)):
        lists = kernels.tile_lists(torch.tensor(los, dtype=torch.int32),
                                   torch.tensor(widths, dtype=torch.int32),
                                   ncols)
        assert lists.total == lists.most == 0 and not len(lists.objs)
        assert lists.offsets.shape == (lists.ntiles + 1,)


def _jax_sorted(x32, y32, nrows):
    xs, order = jj._sorted_by_x(jnp.asarray(x32), np.int32(nrows))
    return np.asarray(xs), np.asarray(order)


@pytest.mark.parametrize("nrows", [20_000, 19_000])
def test_sorted_by_x_matches_reference(cloud, nrows):
    px, py = cloud
    x32, y32 = px.astype(np.float32), py.astype(np.float32)
    x32[5:9] = 0.0
    x32[9:12] = -0.0   # signed zeros tie, as jnp.argsort's order keeps them
    xs, ys, order = tj._sorted_by_x(torch.from_numpy(x32),
                                    torch.from_numpy(y32), nrows)
    jxs, jorder = _jax_sorted(x32, y32, nrows)
    assert np.array_equal(xs.numpy(), jxs)
    assert np.array_equal(order.numpy(), jorder)
    real = jorder < nrows
    assert np.array_equal(ys.numpy()[real], y32[jorder[real]])
    assert np.isnan(ys.numpy()[~real]).all()


def _slab_case(cloud, nrows, box):
    """The port's and the reference's slab candidates over the same
    slabs: (rows, qi) from the plain kernel, and the reference's flat
    grid indices mapped through its order."""
    px, py = cloud
    x32, y32 = px.astype(np.float32), py.astype(np.float32)
    xs, ys, order = tj._sorted_by_x(torch.from_numpy(x32),
                                    torch.from_numpy(y32), nrows)
    rng = np.random.default_rng(5)
    k = 40
    cx, cy = rng.uniform(-170, 170, k), rng.uniform(-80, 80, k)
    if box:
        b64 = np.stack([cx - 2, cy - 3, cx + 2.5, cy + 1], axis=1)
        los_t, w_t, los, widths = tj._contains_slab_setup(xs, b64)
        qa = b64.astype(np.float32)
        eps = float(np.float32(EDGE_EPS))
        r2_hi = 0.0
    else:
        r2_hi, _ = fp.f32_band(2.0, 360.0)
        r2_hi = float(np.float32(r2_hi))
        los_t, w_t, los, widths = tj._slab_bounds(
            xs, cx.astype(np.float32), np.float32(2.1))
        qa = np.stack([cx, cy], axis=1).astype(np.float32)
        eps = 0.0
    rows, qi = kernels.slab_pairs_plain(xs, ys, order, los_t, w_t,
                                        torch.from_numpy(qa), r2_hi, eps,
                                        box)
    jxs, jorder = _jax_sorted(x32, y32, nrows)
    smax = 1 << (int(widths.max()) - 1).bit_length()
    args = (jnp.asarray(jxs), jnp.asarray(jorder), jnp.asarray(los),
            jnp.asarray(widths))
    if box:
        total = int(jj._contains_cand_count(
            *args, jnp.asarray(qa), jnp.asarray(x32), jnp.asarray(y32),
            np.int32(nrows), smax))
        flat = np.asarray(jj._contains_cand_flat(
            *args, jnp.asarray(qa), jnp.asarray(x32), jnp.asarray(y32),
            np.int32(nrows), smax, max(total, 1)))
    else:
        cargs = (jnp.asarray(qa[:, 0]), jnp.asarray(qa[:, 1]),
                 jnp.asarray(x32), jnp.asarray(y32), np.float32(r2_hi))
        total = int(jj._slab_cand_count(*args, *cargs, smax))
        flat = np.asarray(jj._slab_cand_flat(*args, *cargs, smax,
                                             max(total, 1)))
    flat = flat[flat >= 0]
    jqi = flat // smax
    jrows = jorder[np.minimum(los[jqi] + flat - jqi * smax, len(jorder) - 1)]
    keep = jrows < nrows
    return rows.numpy(), qi.numpy(), jrows[keep], jqi[keep], total


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("nrows", [20_000, 17_500])
def test_slab_pairs_plain_matches_reference(cloud, box, nrows):
    """J2's plain version: the reference's flatnonzero of the (query,
    column) grid, query-major and column-ascending, mapped to rows."""
    rows, qi, jrows, jqi, total = _slab_case(cloud, nrows, box)
    assert total > 100
    assert np.array_equal(rows, jrows) and np.array_equal(qi, jqi)


# -- the slab kernels' tile walk -------------------------------------------

def _slab_walk_case(n, cap, k, half, box, seed):
    """f32 rows (NaN and +-inf coordinates among them, capacity rows past
    n), their port and reference x-sorts, and k slabs: seeded centres
    with half-width ``half`` (overlapping where it is wide), the first
    empty and the second the whole table; with each query's f32 point
    or box (finite, so no non-finite row passes)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, cap).astype(np.float32)
    y = rng.uniform(-90, 90, cap).astype(np.float32)
    x[:4], y[4:8] = np.nan, np.nan
    x[8:11], x[11:13], y[13:15] = np.inf, -np.inf, -np.inf
    xs, ys, order = tj._sorted_by_x(torch.from_numpy(x), torch.from_numpy(y),
                                    n)
    cx, cy = rng.uniform(-170, 170, k), rng.uniform(-80, 80, k)
    los_t, w_t, los, widths = tj._slab_bounds(
        xs, cx.astype(np.float32), np.full(k, half, np.float32))
    los, widths = los.copy(), widths.copy()
    widths[0] = 0
    los[1], widths[1] = 0, cap
    if box:
        qa = np.stack([cx - half, cy - half / 2, cx + half, cy + half / 2],
                      axis=1).astype(np.float32)
        r2_hi, eps = 0.0, float(np.float32(EDGE_EPS))
    else:
        qa = np.stack([cx, cy], axis=1).astype(np.float32)
        r2_hi, eps = float(np.float32(half * half)), 0.0
    args = (xs, ys, order, torch.from_numpy(los), torch.from_numpy(widths),
            torch.from_numpy(qa), r2_hi, eps, box)
    return x, y, args


def _slab_reference(x, y, n, args):
    """The reference's flatnonzero of its (query, column) grid over the
    same slabs and its own x-sort, mapped to rows (< n) and queries."""
    _, _, _, los_t, w_t, qa_t, r2_hi, _, box = args
    los, widths, qa = los_t.numpy(), w_t.numpy(), qa_t.numpy()
    jxs, jorder = _jax_sorted(x, y, n)
    smax = 1 << (int(widths.max()) - 1).bit_length()
    common = (jnp.asarray(jxs), jnp.asarray(jorder), jnp.asarray(los),
              jnp.asarray(widths))
    if box:
        tail = (jnp.asarray(qa), jnp.asarray(x), jnp.asarray(y), np.int32(n))
        total = int(jj._contains_cand_count(*common, *tail, smax))
        flat = np.asarray(jj._contains_cand_flat(*common, *tail, smax,
                                                 max(total, 1)))
    else:
        tail = (jnp.asarray(qa[:, 0]), jnp.asarray(qa[:, 1]), jnp.asarray(x),
                jnp.asarray(y), np.float32(r2_hi))
        total = int(jj._slab_cand_count(*common, *tail, smax))
        flat = np.asarray(jj._slab_cand_flat(*common, *tail, smax,
                                             max(total, 1)))
    flat = flat[flat >= 0]
    qi = flat // smax
    rows = jorder[np.minimum(los[qi] + flat - qi * smax, len(jorder) - 1)]
    keep = rows < n
    return rows[keep], qi[keep]


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("k,half,tile", [(40, 6.0, kernels.JOIN_TILE),
                                         (40, 6.0, 7),
                                         (600, 100.0, kernels.JOIN_TILE),
                                         (600, 100.0, 256)])
def test_slab_tile_walk_matches_plain_and_reference(k, half, tile, box):
    """The slab kernels' decomposition (the tile lists of the slabs, each
    entry's matches counted at its object-major index, their prefix,
    then each entry's matches written from its offset) equals the
    per-query plain version and the reference's flat candidates, row for
    row and in order: overlapping slabs (600 wide ones: tiles that list
    more queries than a block of the kernel takes), an empty slab and
    one that is the whole table, NaN and +-inf rows, capacity rows."""
    n, cap = 9_000, 9_500
    x, y, args = _slab_walk_case(n, cap, k, half, box, seed=k + int(box))
    walk = kernels.slab_pairs_tiles_plain(*args, tile=tile)
    plain = kernels.slab_pairs_plain(*args)
    rows, qi = _slab_reference(x, y, n, args)
    assert torch.equal(walk[0], plain[0]) and torch.equal(walk[1], plain[1])
    assert np.array_equal(walk[0].numpy(), rows)
    assert np.array_equal(walk[1].numpy(), qi)
    assert len(rows) > 50 and not (qi == 0).any() and (qi == 1).any()
    lists = kernels.tile_lists(args[3], args[4], cap)
    if k == 600 and tile == kernels.JOIN_TILE:
        assert lists.most > kernels.SLAB_GROUP


# -- contains ---------------------------------------------------------------

@pytest.mark.parametrize("counts_only", [True, False])
def test_contains_join_matches_reference(cloud, counts_only):
    px, py = cloud
    jp, tp = _polys(POLYGONS)
    got = tj.contains_join(tp, px, py, counts_only=counts_only, device=CPU)
    want = jj.contains_join(jp, px, py, counts_only=counts_only)
    assert np.array_equal(got[0], want[0])
    assert got[0][-1] == 0 and got[0][:5].min() > 0
    for j, p in enumerate(tp):
        assert got[0][j] == int(p.contains_points(px, py).sum())
    if not counts_only:
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("counts_only", [True, False])
def test_contains_band_overflow(counts_only):
    """More than band_cap = 256 band rows in one polygon: 600 points on
    its right edge and 30 on its bottom edge (test_batched_knn.py:297),
    resolved through the band-row re-extraction, exact."""
    rng = np.random.default_rng(6)
    n = 20_000
    px, py = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    px[:600], py[:600] = 1.0, np.linspace(-1, 1, 600)
    px[600:630], py[600:630] = np.linspace(-1, 1, 30), -1.0
    jp, tp = _polys([_rect(0.0, 0.0, 1.0, 1.0), _rect(0.5, 0.5, 0.25, 0.25)])
    got = tj.contains_join(tp, px, py, counts_only=counts_only, device=CPU)
    want = jj.contains_join(jp, px, py, counts_only=counts_only)
    assert np.array_equal(got[0], want[0])
    assert got[0][0] == int(tp[0].contains_points(px, py).sum())
    if not counts_only:
        assert np.array_equal(got[1], want[1])


def _contains_tables(px, py, nrows, wkts):
    """Both packages' batched polygon tables over the same f32 columns."""
    x32, y32 = px.astype(np.float32), py.astype(np.float32)
    jp, tp = _polys(wkts)
    xs, ys, order = tj._sorted_by_x(torch.from_numpy(x32),
                                    torch.from_numpy(y32), nrows)
    b64 = np.array([p.envelope.as_tuple() for p in tp])
    _, _, los, widths = tj._contains_slab_setup(xs, b64)
    kp = tj._poly_pad(len(tp))
    edges, evalid, boxes32 = tj.pack_polygon_batch(tp, pad_to=kp)
    jedges, jevalid, jboxes32 = jj.pack_polygon_batch(jp, pad_to=kp)
    assert np.array_equal(edges, jedges) and np.array_equal(evalid, jevalid)
    assert np.array_equal(boxes32, jboxes32)
    lp, wp = np.zeros(kp, np.int32), np.zeros(kp, np.int32)
    lp[:len(tp)], wp[:len(tp)] = los, widths
    tables = (xs, ys, order, torch.from_numpy(lp), torch.from_numpy(wp),
              torch.from_numpy(boxes32), torch.from_numpy(edges),
              torch.from_numpy(evalid.sum(axis=1).astype(np.int32)))
    jxs, jorder = _jax_sorted(x32, y32, nrows)
    smax = 1 << (int(widths.max()) - 1).bit_length()
    jargs = (jnp.asarray(jxs), jnp.asarray(jorder), jnp.asarray(lp),
             jnp.asarray(wp), jnp.asarray(boxes32), jnp.asarray(edges),
             jnp.asarray(evalid), jnp.asarray(x32), jnp.asarray(y32),
             np.int32(nrows), smax)
    return tables, jargs


@pytest.mark.parametrize("band_cap", [256, 3])
def test_contains_counts_plain_matches_reference(band_cap):
    """J3's plain version against _contains_counts_all: definite and
    band counts and the first band_cap band rows, on points placed on
    edges and vertices (the band) and capacity padding past nrows."""
    rng = np.random.default_rng(11)
    n = 30_000
    px, py = rng.uniform(-100, 100, n), rng.uniform(-60, 60, n)
    px[:40], py[:40] = 20.0, np.linspace(-20, 20, 40)
    px[40:70], py[40:70] = np.linspace(-60, 60, 30), -40.0
    tables, jargs = _contains_tables(px, py, n - 500, POLYGONS[:5])
    dc, bc, brows = kernels.contains_counts_plain(
        *tables, float(np.float32(EDGE_EPS)), EDGE_EPS2, band_cap)
    jdc, jbc, jbrows = jj._contains_counts_all(*jargs, band_cap)
    assert np.array_equal(dc.numpy(), np.asarray(jdc))
    assert np.array_equal(bc.numpy(), np.asarray(jbc))
    assert np.array_equal(brows.numpy(), np.asarray(jbrows))
    assert int(bc.max()) > 3   # a band past the smaller cap


def test_contains_band_rows_plain_matches_reference():
    rng = np.random.default_rng(6)
    n = 20_000
    px, py = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    px[:600], py[:600] = 1.0, np.linspace(-1, 1, 600)
    tables, jargs = _contains_tables(px, py, n, [_rect(0.0, 0.0, 1.0, 1.0)])
    got = kernels.contains_band_rows_plain(
        *tables, float(np.float32(EDGE_EPS)), EDGE_EPS2, [0], 1024)
    xs, order, los, widths, boxes, edges, evalid, x, y, nrows, smax = jargs
    want = jj._contains_band_rows(xs, order, np.int32(los[0]),
                                  np.int32(widths[0]), boxes[0], edges[0],
                                  evalid[0], x, y, nrows, smax, 1024)
    assert np.array_equal(got.numpy()[0], np.asarray(want))
    assert (got >= 0).sum() >= 600


# -- the tile walk of the contains kernels -----------------------------------

WHOLE = _rect(0.0, 0.0, 200.0, 100.0)   # every finite row in its slab


def _contains_points(n, seed):
    """n seeded f64 rows: rows on a rectangle's and a hole's edges and
    vertices (the band), NaN and +-inf coordinates."""
    rng = np.random.default_rng(seed)
    px, py = rng.uniform(-100, 100, n), rng.uniform(-60, 60, n)
    px[:40], py[:40] = 20.0, np.linspace(-20, 20, 40)
    px[40:70], py[40:70] = np.linspace(-60, 60, 30), -40.0
    px[70:80], py[70:80] = -20.0, np.linspace(-20, 20, 10)
    px[80:84], py[84:88] = np.nan, np.nan
    px[88:90], px[90:92], py[92:94] = np.inf, -np.inf, np.inf
    return px, py


@pytest.mark.parametrize("band_cap", [256, 3])
@pytest.mark.parametrize("tile,n", [(kernels.JOIN_TILE, 30_000),
                                    (64, 30_000), (1, 3_000)])
def test_contains_tile_walk_matches_plain_and_reference(tile, n, band_cap):
    """The contains kernels' decomposition (the tile lists of the
    polygons' slabs, each entry's columns through the box and the edges,
    then the rows pass from each entry's prefix offset) equals the
    per-polygon plain version and _contains_counts_all: counts and the
    first band_cap band rows, with a polygon whose slab is the whole
    table, one with an empty slab, capacity padding past nrows, NaN and
    infinite rows, and tiles of one column."""
    px, py = _contains_points(n, seed=tile)
    wkts = POLYGONS[:5] + [WHOLE, POLYGONS[6]]
    tables, jargs = _contains_tables(px, py, n - 500, wkts)
    eps = float(np.float32(EDGE_EPS))
    got = kernels.contains_counts_tiles_plain(*tables, eps, EDGE_EPS2,
                                              band_cap, tile)
    want = kernels.contains_counts_plain(*tables, eps, EDGE_EPS2, band_cap)
    ref = jj._contains_counts_all(*jargs, band_cap)
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert int(want[1].max()) > 3 and int(want[0][5]) > 0
    assert int(tables[4][6]) == 0   # the empty slab


@pytest.mark.parametrize("tile", [kernels.JOIN_TILE, 7])
def test_contains_band_rows_tile_walk(tile):
    """contains_band_rows' decomposition (the listed polygons' slabs
    alone, a counts pass, the rows pass) against the plain version and
    _contains_band_rows, more band rows than the counts path keeps."""
    rng = np.random.default_rng(6)
    n = 20_000
    px, py = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    px[:600], py[:600] = 1.0, np.linspace(-1, 1, 600)
    wkts = [_rect(0.0, 0.0, 1.0, 1.0), _rect(0.5, 0.5, 0.25, 0.25)]
    tables, jargs = _contains_tables(px, py, n, wkts)
    eps = float(np.float32(EDGE_EPS))
    listed = torch.zeros_like(tables[4])
    listed[0] = tables[4][0]
    walked = kernels.contains_counts_tiles_plain(
        *tables[:4], listed, *tables[5:], eps, EDGE_EPS2, 1024, tile)[2][:1]
    want = kernels.contains_band_rows_plain(*tables, eps, EDGE_EPS2, [0],
                                            1024)
    xs, order, los, widths, boxes, edges, evalid, x, y, nrows, smax = jargs
    ref = jj._contains_band_rows(xs, order, np.int32(los[0]),
                                 np.int32(widths[0]), boxes[0], edges[0],
                                 evalid[0], x, y, nrows, smax, 1024)
    assert torch.equal(walked, want)
    assert np.array_equal(walked.numpy()[0], np.asarray(ref))
    assert (walked >= 0).sum() >= 600


def test_contains_rows_items_offsets():
    """Each rows-pass item starts at the band rows of its polygon's
    earlier tiles, and items past the cap are left out."""
    lists = kernels.tile_lists(torch.tensor([0, 5], dtype=torch.int32),
                               torch.tensor([10, 3], dtype=torch.int32), 16,
                               4)
    # tile-major entries: (0, 0), (1, 0), (1, 1), (2, 0)
    assert lists.objs.tolist() == [0, 0, 1, 0]
    cband = torch.tensor([2, 0, 5, 3], dtype=torch.int32)
    items = kernels.contains_rows_items(lists, cband, [1, 0], 2, 4)
    assert items.tolist() == [[0, 0, 1, 0], [1, 1, 0, 0], [2, 0, 1, 2]]
    items = kernels.contains_rows_items(lists, cband, [0], 2, 2)
    assert items.tolist() == [[0, 0, 0, 0]]


def test_contains_device_xy_padded(cloud):
    px, py = cloud
    jp, tp = _polys(POLYGONS)
    tdev, jdev = _padded(px, py, 3000, (0.0, 0.0))
    for co in (True, False):
        got = tj.contains_join(tp, px, py, counts_only=co, device_xy=tdev)
        want = jj.contains_join(jp, px, py, counts_only=co, device_xy=jdev)
        assert np.array_equal(got[0], want[0])
        if not co:
            assert np.array_equal(got[1], want[1])


def test_contains_empty_inputs():
    jp, tp = _polys([_rect(0, 0, 1, 1)])
    one = np.array([1.0])
    got = tj.contains_join([], one, one, device=CPU)
    assert len(got[0]) == 0 and got[1].shape == (0, 2)
    got = tj.contains_join(tp, np.empty(0), np.empty(0), counts_only=True,
                           device=CPU)
    want = jj.contains_join(jp, np.empty(0), np.empty(0), counts_only=True)
    assert np.array_equal(got[0], want[0]) and got[1] is None


# -- knn --------------------------------------------------------------------

def _knn_oracle(px, py, qx, qy, k):
    d2 = (px - qx) ** 2 + (py - qy) ** 2
    return np.lexsort((np.arange(len(px)), d2))[:k]


@pytest.mark.parametrize("k", [1, 100])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_knn_batched_matches_reference(cloud, k, nq):
    px, py = cloud
    rng = np.random.default_rng(nq * 100 + k)
    qx, qy = rng.uniform(-180, 180, nq), rng.uniform(-90, 90, nq)
    d, ids = tj.knn_batched(px, py, qx, qy, k, device=CPU)
    jd, jids = jj.knn_batched(px, py, qx, qy, k)
    assert np.array_equal(ids, jids) and np.array_equal(d, jd)
    for i in range(nq):
        assert np.array_equal(ids[i], _knn_oracle(px, py, qx[i], qy[i], k))


def test_knn_out_of_envelope_and_single_path(cloud):
    px, py = cloud
    qx = np.array([-250.0, 250.0, 0.0, -250.0])
    qy = np.array([-120.0, 120.0, 119.0, 0.0])
    got = tj.knn_batched(px, py, qx, qy, 50, device=CPU)
    want = jj.knn_batched(px, py, qx, qy, 50)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    d1, i1 = tj.knn(px, py, 12.5, -33.0, 25, device=CPU)
    db, ib = tj.knn_batched(px, py, np.array([12.5]), np.array([-33.0]), 25,
                            device=CPU)
    assert np.array_equal(i1, ib[0]) and np.array_equal(d1, db[0])
    jd1, ji1 = jj.knn(px, py, 12.5, -33.0, 25)
    assert np.array_equal(i1, ji1) and np.array_equal(d1, jd1)


def test_knn_k_boundary_tie_is_id_stable():
    px, py = np.zeros(500), np.zeros(500)
    px[400:] = 50.0
    d, ids = tj.knn_batched(px, py, np.array([0.0]), np.array([0.0]), 10,
                            device=CPU)
    jd, jids = jj.knn_batched(px, py, np.array([0.0]), np.array([0.0]), 10)
    assert np.array_equal(ids[0], np.arange(10)) and np.all(d[0] == 0.0)
    assert np.array_equal(ids, jids) and np.array_equal(d, jd)


def test_knn_k_clamped_and_empty():
    for px, qx, k in ((np.array([1.0, 2.0]), np.array([0.0]), 10),
                      (np.empty(0), np.array([0.0]), 5),
                      (np.array([1.0]), np.empty(0), 3),
                      (np.array([1.0]), np.array([0.0]), 0)):
        d, ids = tj.knn_batched(px, np.zeros_like(px), qx, np.zeros_like(qx),
                                k, device=CPU)
        jd, jids = jj.knn_batched(px, np.zeros_like(px), qx,
                                  np.zeros_like(qx), k)
        assert ids.shape == jids.shape and np.array_equal(ids, jids)
        assert np.array_equal(d, jd)


def test_knn_two_stage_size():
    """n > 4 * 16384: the reference's blocked two-stage top-k."""
    rng = np.random.default_rng(11)
    n = 70_000
    px, py = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    px[100:150], py[100:150] = px[:50], py[:50]
    qx, qy = np.array([0.0, 9.0, px[0]]), np.array([0.0, -9.0, py[0]])
    got = tj.knn_batched(px, py, qx, qy, 100, device=CPU)
    want = jj.knn_batched(px, py, qx, qy, 100)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])


def _select(d2, nrows, kpad):
    """(d2, rows) of the kpad smallest keys per query, in (d2, row) order
    with +inf past nrows: a stable argsort, the windows' common order."""
    d2 = d2.copy()
    d2[:, nrows:] = np.inf
    rows = np.argsort(d2, axis=1, kind="stable")[:, :kpad]
    return np.take_along_axis(d2, rows, axis=1), rows


@pytest.mark.parametrize("n,cap,kpad", [(20_000, 20_000, 128),
                                        (70_000, 70_000, 256),
                                        (3_000, 4_096, 4_096),
                                        (100, 128, 128)])
def test_knn_plain_matches_reference(n, cap, kpad):
    """J4's plain version against _knn_kernel: capacity-padded rows at
    +inf, duplicated points for ties, the two-stage form past 65,536
    rows, kpad above nrows. Both windows are the same stable selection;
    they differ only in d2's last rounding. XLA's CPU backend contracts
    _knn_kernel's dx*dx + dy*dy into fma(dx, dx, fl(dy*dy)) (one
    rounding); the port rounds each step, as the kernel's intrinsics do.
    So the reference's window is the selection over the fused d2 and the
    port's over the stepwise d2, each bit for bit, and knn_batched's ids
    and f64 distances stay equal (the tests above)."""
    rng = np.random.default_rng(n)
    x = rng.uniform(-10, 10, cap).astype(np.float32)
    y = rng.uniform(-10, 10, cap).astype(np.float32)
    x[10:40], y[10:40] = x[0], y[0]
    qx, qy, _ = zscan.stack_points([x[0], 3.0, -7.5], [y[0], 1.0, 2.0])
    got = kernels.knn_topk_plain(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(qx), torch.from_numpy(qy),
                                 kpad, n)
    want = jj._knn_kernel(jnp.asarray(x), jnp.asarray(y), jnp.asarray(qx),
                          jnp.asarray(qy), kpad, np.int32(n))
    dx, dy = x[None, :] - qx[:, None], y[None, :] - qy[:, None]
    stepwise = dx * dx + dy * dy
    fused = (dx.astype(np.float64) * dx + dy * dy).astype(np.float32)
    for (d2, rows), model in ((got, stepwise), (want, fused)):
        sd2, srows = _select(model, n, kpad)
        assert np.array_equal(np.asarray(d2).view(np.int32),
                              sd2.view(np.int32))
        assert np.array_equal(np.asarray(rows), srows)
    assert (stepwise[:, :n] != fused[:, :n]).any()


def test_knn_device_xy_padded():
    """Padded rows sit exactly at the query point: masked, they never
    win (test_analytics.py knn_device_xy_padded)."""
    rng = np.random.default_rng(29)
    px, py = rng.uniform(-10, 10, 3_000), rng.uniform(-10, 10, 3_000)
    tdev, jdev = _padded(px, py, 500, (1.0, 2.0))
    d, idx = tj.knn(px, py, 1.0, 2.0, 10, device_xy=tdev)
    jd, jidx = jj.knn(px, py, 1.0, 2.0, 10, device_xy=jdev)
    assert np.array_equal(idx, jidx) and np.array_equal(d, jd)
    assert (idx < 3_000).all()


# -- the knn kernel's walk -------------------------------------------------

def _knn_grid_case(n, cap, nq, layout, seed):
    """f32 rows and queries on a quarter-unit grid, so every d2 is exact
    in f32 and the reference's fused rounding equals the port's stepwise
    one: ``x`` sorts the rows by x (a block's rows lie in one band, far
    from most queries), ``far`` by distance from query 0, farthest first
    (the first blocks' bounds are loose and every later row passes),
    ``equal`` puts every row on one point (ties across blocks), ``nan``
    has NaN rows and a NaN query; capacity rows past n sit at the
    origin."""
    rng = np.random.default_rng(seed)
    x = np.zeros(cap, np.float32)
    y = np.zeros(cap, np.float32)
    x[:n] = rng.integers(-400, 400, n) / 2
    y[:n] = rng.integers(-200, 200, n) / 2
    qx = (rng.integers(-760, 760, nq) / 4).astype(np.float32)
    qy = (rng.integers(-360, 360, nq) / 4).astype(np.float32)
    if layout == "x":
        o = np.argsort(x[:n], kind="stable")
        x[:n], y[:n] = x[:n][o], y[:n][o]
    elif layout == "far":
        d2 = (x[:n] - qx[0]) ** 2 + (y[:n] - qy[0]) ** 2
        o = np.argsort(-d2, kind="stable")
        x[:n], y[:n] = x[:n][o], y[:n][o]
    elif layout == "equal":
        x[:n], y[:n] = 3.5, -1.25
    elif layout == "nan":
        x[5:40], y[100:130] = np.nan, np.nan
        qx[0] = np.nan
        qy[min(1, nq - 1)] = np.nan
    return x, y, qx, qy


@pytest.mark.parametrize("layout,n,cap,nq,kpad,chunk,group", [
    ("x", 40_000, 40_960, 8, 256, 1_024, 8),      # a middle pass
    ("far", 40_000, 40_000, 1, 128, 1_024, 1),
    ("equal", 30_000, 30_720, 9, 64, 2_048, 8),   # two groups
    ("nan", 20_000, 20_480, 32, 100, 2_048, 8),
    ("uniform", 100, 128, 1, 128, 4_096, 1),      # kpad > nrows
    ("uniform", 5_000, 5_000, 64, 1, 1_024, 8),   # kpad 1, eight groups
    ("uniform", 10_000, 10_000, 2, 8_192, 4_096, 2),
    ("uniform", 20_000, 20_000, 32, 256, 2_048, 8)])
def test_knn_block_walk_matches_plain_and_reference(layout, n, cap, nq,
                                                    kpad, chunk, group):
    """The knn kernel's decomposition (chunks of rows for groups of
    queries, each block's kpad best at or below a bound the blocks
    share and lower, the survivors cut again by blocks of 16 blocks'
    survivors where there are more, a last sort) equals the plain
    version and _knn_kernel, d2 bits and rows, on rows sorted by x and
    by distance from the query, equal rows, NaN rows and queries, kpad
    above nrows, kpad 1 and 8,192, and 1 to 64 queries."""
    x, y, qx, qy = _knn_grid_case(n, cap, nq, layout, seed=n + nq)
    t = [torch.from_numpy(a) for a in (x, y, qx, qy)]
    walk = kernels.knn_topk_blocks_plain(*t, kpad, n, chunk, group)
    plain = kernels.knn_topk_plain(*t, kpad, n)
    ref = jj._knn_kernel(jnp.asarray(x), jnp.asarray(y), jnp.asarray(qx),
                         jnp.asarray(qy), kpad, np.int32(n))
    for (d2, rows) in (plain, ref):
        d2 = torch.from_numpy(np.array(d2))
        nan = d2.isnan()
        assert torch.equal(walk[0].isnan(), nan)
        assert torch.equal(walk[0].masked_fill(nan, 0).view(torch.int32),
                           d2.masked_fill(nan, 0).view(torch.int32))
        assert np.array_equal(walk[1].numpy(), np.asarray(rows))
    if layout == "nan":   # a NaN query ranks the +inf capacity rows first
        for q in (0, 1):
            assert torch.equal(walk[1][q], torch.arange(n, n + kpad))
            assert torch.isinf(walk[0][q]).all()


# -- the x-sort cache ---------------------------------------------------------

def test_xsort_cache_follows_in_place_appends():
    """The port's resident columns grow in place (zscan.extend_scan_data):
    a join after an append sorts the new rows too, where a cache keyed
    on the tensors alone would serve the old sort."""
    rng = np.random.default_rng(4)
    cap, n0, n1 = 4096, 2000, 3000
    x, y = rng.uniform(-10, 10, n1), rng.uniform(-10, 10, n1)
    xt = torch.zeros(cap, dtype=torch.float32)
    yt = torch.zeros(cap, dtype=torch.float32)
    xt[:n0], yt[:n0] = torch.from_numpy(x[:n0]), torch.from_numpy(y[:n0])
    q = (np.array([0.0, 5.0]), np.array([0.0, -5.0]))
    tj.clear_xsort_cache()
    first = tj.dwithin_join(x[:n0], y[:n0], *q, 2.0, device_xy=(xt, yt))
    assert len(tj._XSORT_CACHE) == 1
    xt[n0:n1] = torch.from_numpy(x[n0:].astype(np.float32))
    yt[n0:n1] = torch.from_numpy(y[n0:].astype(np.float32))
    second = tj.dwithin_join(x, y, *q, 2.0, device_xy=(xt, yt))
    want = jj.dwithin_join(x, y, *q, 2.0)
    assert np.array_equal(second[1], want[1])
    assert len(second[1]) > len(first[1])
    # the same rows count, new data written in place: a new sort too
    xt[:n1] = xt[:n1].flip(0)
    yt[:n1] = yt[:n1].flip(0)
    third = tj.dwithin_join(x[::-1].copy(), y[::-1].copy(), *q, 2.0,
                            device_xy=(xt, yt))
    want = jj.dwithin_join(x[::-1].copy(), y[::-1].copy(), *q, 2.0)
    assert np.array_equal(third[1], want[1])
    tj.clear_xsort_cache()


def test_xsort_cache_after_store_append():
    """A join through a store between writes gets the reference's answer
    every time: the second write appends in place (3,000 + 1,000 rows in
    a capacity of 4,096), the third rebuilds the columns."""
    from geomesa_tpu.analytics.processes import proximity_process as jprox
    from geomesa_tpu.store import InMemoryDataStore as JaxStore
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.analytics.processes import proximity_process
    rng = np.random.default_rng(8)
    port, ref = InMemoryDataStore(device=CPU), JaxStore()
    for s in (port, ref):
        s.create_schema("pts", "*geom:Point:srid=4326")
    xhi = []
    for chunk, n in enumerate((3000, 1000, 2000)):
        x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
        ids = [f"c{chunk}_{i}" for i in range(n)]
        for s in (port, ref):
            s.write_dict("pts", ids, {"geom": (x, y)})
        for co in (True, False):
            got = proximity_process(port, "pts", [0.0, 3.0], [0.0, 3.0], 1.5,
                                    counts_only=co)
            want = jprox(ref, "pts", [0.0, 3.0], [0.0, 3.0], 1.5,
                         counts_only=co)
            assert np.array_equal(got[0], want[0])
            if not co:
                assert list(got[1]) == list(want[1])
        xhi.append(port._state("pts").scan_data.xhi)
    assert xhi[0] is xhi[1] and xhi[1] is not xhi[2]
    tj.clear_xsort_cache()


def test_prewarm_runs_on_the_cpu(cloud):
    """The prewarm caches the resident columns' x-sort (plain versions
    only on the CPU); the first join then reuses it and gets the
    reference's answer."""
    px, py = cloud
    n = len(px)
    xt = torch.from_numpy(px.astype(np.float32))
    yt = torch.from_numpy(py.astype(np.float32))
    tj.clear_xsort_cache()
    kernels.reset_launches()
    tj.prewarm_join_kernels(device_xy=(xt, yt), nrows=n)
    assert sum(kernels.launches.values()) == 0   # plain versions only
    assert len(tj._XSORT_CACHE) == 1
    tables = next(iter(tj._XSORT_CACHE.values()))[3]
    assert tj._sorted_by_x_cached(xt, yt, n, True) is tables
    q = (np.array([0.0, 3.0]), np.array([0.0, -3.0]))
    got = tj.dwithin_join(px, py, *q, 0.5, device_xy=(xt, yt))
    want = jj.dwithin_join(px, py, *q, 0.5)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert len(tj._XSORT_CACHE) == 1
    tj.prewarm_join_kernels(device_xy=(xt[:0], yt[:0]), nrows=0)
    assert len(tj._XSORT_CACHE) == 1
    tj.clear_xsort_cache()


def test_xsort_cache_replaces_an_entry_on_a_miss():
    """A miss on the version counters or the row count of the same
    columns replaces their entry: the cache holds one sort a table."""
    rng = np.random.default_rng(6)
    cap, n0 = 4096, 2000
    x, y = rng.uniform(-10, 10, cap), rng.uniform(-10, 10, cap)
    xt = torch.zeros(cap, dtype=torch.float32)
    yt = torch.zeros(cap, dtype=torch.float32)
    xt[:n0], yt[:n0] = torch.from_numpy(x[:n0]), torch.from_numpy(y[:n0])
    tj.clear_xsort_cache()
    q = (np.array([1.0]), np.array([1.0]))
    for n in (n0, 3000, cap):
        xt[:n] = torch.from_numpy(x[:n].astype(np.float32))
        yt[:n] = torch.from_numpy(y[:n].astype(np.float32))
        got = tj.dwithin_join(x[:n], y[:n], *q, 3.0, device_xy=(xt, yt))
        want = jj.dwithin_join(x[:n], y[:n], *q, 3.0)
        assert np.array_equal(got[1], want[1])
        assert len(tj._XSORT_CACHE) == 1
        assert next(iter(tj._XSORT_CACHE.values()))[2][2] == n
    tj.clear_xsort_cache()


def test_xsort_cache_drops_dead_columns():
    """An entry leaves with its columns, so no sort of a dropped table
    stays alive; the bound keeps the live tables to a few."""
    rng = np.random.default_rng(7)
    q = (np.array([0.0]), np.array([0.0]))
    tj.clear_xsort_cache()
    cols = []
    for _ in range(tj._XSORT_ENTRIES + 2):
        x, y = rng.uniform(-5, 5, 500), rng.uniform(-5, 5, 500)
        xt = torch.from_numpy(x.astype(np.float32))
        yt = torch.from_numpy(y.astype(np.float32))
        tj.dwithin_join(x, y, *q, 1.0, device_xy=(xt, yt))
        cols.append((xt, yt))
    assert len(tj._XSORT_CACHE) == tj._XSORT_ENTRIES
    del xt, yt
    cols.pop()
    gc.collect()
    assert len(tj._XSORT_CACHE) == tj._XSORT_ENTRIES - 1
    cols.clear()
    gc.collect()
    assert not tj._XSORT_CACHE


@pytest.mark.parametrize("drop", ["remove_schema", "delete"])
def test_xsort_cache_leaves_with_the_store_columns(drop):
    """The store's remove_schema and delete drop its resident columns,
    and their x-sort with them; a join after a delete gets the
    reference's answer."""
    from geomesa_tpu.analytics.processes import proximity_process as jprox
    from geomesa_tpu.store import InMemoryDataStore as JaxStore
    from geomesa_tpu_torch import InMemoryDataStore
    from geomesa_tpu_torch.analytics.processes import proximity_process
    rng = np.random.default_rng(9)
    n = 3000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    ids = [str(i) for i in range(n)]
    port, ref = InMemoryDataStore(device=CPU), JaxStore()
    for s in (port, ref):
        s.create_schema("pts", "*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"geom": (x, y)})
    tj.clear_xsort_cache()
    args = ("pts", [0.0, 3.0], [0.0, 3.0], 1.5)
    proximity_process(port, *args)
    assert len(tj._XSORT_CACHE) == 1
    if drop == "remove_schema":
        port.remove_schema("pts")
    else:
        for s in (port, ref):
            s.delete("pts", ids[::3])
    gc.collect()
    assert not tj._XSORT_CACHE
    if drop == "delete":
        got, want = proximity_process(port, *args), jprox(ref, *args)
        assert np.array_equal(got[0], want[0])
        assert list(got[1]) == list(want[1])
    tj.clear_xsort_cache()
