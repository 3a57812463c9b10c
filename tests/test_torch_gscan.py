"""The port's point-in-polygon (scan/gscan.py and the pip_mask kernel's
plain version) against the JAX package's gscan on the CPU, at 100k
seeded points per polygon: a concave star, a polygon with holes, a
multipolygon with a hole, a polygon with horizontal edges (dy == 0),
and points placed on vertices and on edges.

Tolerance: the edge tables equal the JAX package's valid edges and the
f32 points handed to the kernel equal its px32/py32 (exact); ``inside``
is equal on every row that neither side puts in its band; the band sets
differ only on rows whose least squared distance lies within 4 ulp of
EDGE_EPS^2 (float32 arithmetic in another order); after the float64
recheck of the band, ``points_in_polygon`` is exact (equal to the
reference's and to the float64 contains_points)."""

import numpy as np
import pytest
import torch

from geomesa_tpu.geometry import parse_wkt as jax_parse_wkt
from geomesa_tpu.scan import gscan as jax_gscan
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan import gscan, kernels

N = 100_000


def _star(cx, cy, r1, r2, k):
    a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
    r = np.where(np.arange(2 * k) % 2 == 0, r1, r2)
    pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a)]
    pts = np.vstack([pts, pts[:1]])
    return "POLYGON((" + ", ".join(f"{float(x)!r} {float(y)!r}"
                                   for x, y in pts) + "))"


POLYGONS = {
    "star": _star(0.5, -0.25, 10, 4, 7),
    "holes": ("POLYGON((-10 -10, 10 -10, 10 10, -10 10, -10 -10), "
              "(-5 -5, 5 -5, 5 5, -5 5, -5 -5), (6 6, 8 6, 8 8, 6 8, 6 6))"),
    "multi": ("MULTIPOLYGON(((-10 -10, -1 -10, -1 -1, -10 -1, -10 -10)), "
              "((1 1, 10 1, 10 10, 1 10, 1 1), (3 3, 4 3, 4 4, 3 4, 3 3)))"),
    "horizontal": "POLYGON((0 0, 6 0, 6 2, 2 2, 2 6, 0 6, 0 0))",
}


def _points(poly, seed):
    """N seeded points over the polygon's envelope (and a margin), the
    first ones on its vertices and on its edges' midpoints."""
    rng = np.random.default_rng(seed)
    env = poly.envelope
    px = rng.uniform(env.xmin - 2, env.xmax + 2, N)
    py = rng.uniform(env.ymin - 2, env.ymax + 2, N)
    verts = np.vstack(poly.coords_list())
    mids = np.vstack([(r[:-1] + r[1:]) / 2 for r in poly.coords_list()])
    on = np.vstack([verts, mids])
    px[:len(on)], py[:len(on)] = on[:, 0], on[:, 1]
    return px, py


def _min_d2(px32, py32, edges):
    """Least squared distance to an edge in float32, per point."""
    x0, y0, x1, y1 = (edges[:, k][None, :] for k in range(4))
    ex, ey = x1 - x0, y1 - y0
    len2 = ex * ex + ey * ey
    len2 = np.where(len2 == 0, np.float32(1), len2)
    t = np.clip(((px32[:, None] - x0) * ex + (py32[:, None] - y0) * ey)
                / len2, np.float32(0), np.float32(1))
    dx = px32[:, None] - (x0 + t * ex)
    dy = py32[:, None] - (y0 + t * ey)
    return (dx * dx + dy * dy).min(axis=1)


@pytest.mark.parametrize("name", list(POLYGONS))
def test_edges_equal_reference(name):
    wkt = POLYGONS[name]
    ref = jax_gscan.pack_polygon(jax_parse_wkt(wkt))
    valid = np.asarray(ref.edge_valid)
    got = gscan.pack_polygon(parse_wkt(wkt), "cpu").edges.numpy()
    assert np.array_equal(got, np.asarray(ref.edges)[valid])
    fetched = gscan.packed_polygon_from_numpy(
        np.asarray(ref.edges), valid, parse_wkt(wkt), "cpu")
    assert np.array_equal(fetched.edges.numpy(), got)


@pytest.mark.parametrize("name", list(POLYGONS))
def test_kernel_points_are_reference_points(name, monkeypatch):
    """The port rounds the f64 points to nearest, as the JAX path
    uploads them (not the scan columns' round-down hi words)."""
    wkt = POLYGONS[name]
    px, py = _points(parse_wkt(wkt), seed=1)
    seen = {}

    def port_kernel(x, y, edges, eps2):
        seen["port"] = (x.numpy().copy(), y.numpy().copy())
        return kernels.pip_mask_plain(x, y, edges, eps2)

    real = jax_gscan._pip_kernel

    def jax_kernel(x, y, edges, valid):
        seen["jax"] = (np.asarray(x)[:N], np.asarray(y)[:N])
        return real(x, y, edges, valid)
    monkeypatch.setattr(kernels, "pip_mask", port_kernel)
    monkeypatch.setattr(jax_gscan, "_pip_kernel", jax_kernel)
    gscan.points_in_polygon_device(px, py,
                                   gscan.pack_polygon(parse_wkt(wkt), "cpu"))
    jax_gscan.points_in_polygon_device(
        px, py, jax_gscan.pack_polygon(jax_parse_wkt(wkt)))
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(POLYGONS))
def test_device_verdicts_match_reference(name):
    wkt = POLYGONS[name]
    poly, ref_poly = parse_wkt(wkt), jax_parse_wkt(wkt)
    px, py = _points(poly, seed=2)
    packed = gscan.pack_polygon(poly, "cpu")
    inside, band = gscan.points_in_polygon_device(px, py, packed)
    ref_inside, ref_band = jax_gscan.points_in_polygon_device(
        px, py, jax_gscan.pack_polygon(ref_poly))
    flagged = np.zeros(N, dtype=bool)
    flagged[band] = True
    flagged[ref_band] = True
    assert np.array_equal(inside[~flagged], ref_inside[~flagged])
    differ = np.setxor1d(band, ref_band)
    if len(differ):
        px32, py32 = gscan.pip_points(px[differ], py[differ])
        d2 = _min_d2(px32, py32, packed.edges.numpy())
        eps2 = np.float32(gscan.EDGE_EPS2)
        ulp = np.spacing(eps2)
        assert np.all(np.abs(d2 - eps2) <= 4 * ulp)
    # the vertices and edge midpoints are all in the band
    n_on = sum(2 * len(r) - 1 for r in poly.coords_list())
    assert set(range(n_on)) <= set(band.tolist())


@pytest.mark.parametrize("name", list(POLYGONS))
def test_exact_after_recheck(name):
    wkt = POLYGONS[name]
    poly = parse_wkt(wkt)
    px, py = _points(poly, seed=3)
    got = gscan.points_in_polygon(px, py, poly, "cpu")
    assert np.array_equal(got, jax_gscan.points_in_polygon(
        px, py, jax_parse_wkt(wkt)))
    assert np.array_equal(got, poly.contains_points(px, py))


def test_empty_polygon_and_no_points():
    """No edges: nothing inside, no band; no points: empty outputs."""
    px = torch.tensor([0.0, 1.0], dtype=torch.float32)
    inside, band = kernels.pip_mask(px, px, torch.zeros((0, 4)),
                                    gscan.EDGE_EPS2)
    assert not inside.any() and not band.any()
    e = gscan.pack_polygon(parse_wkt(POLYGONS["star"]), "cpu").edges
    inside, band = kernels.pip_mask(px[:0], px[:0], e, gscan.EDGE_EPS2)
    assert inside.shape == band.shape == (0,)


# -- the kernel's edge-box skip (csrc/geom.cu's note) ------------------------

def _odd_edges():
    """Edges the polygons above lack: horizontal and zero-length ones,
    one spanning 360 degrees of longitude, tiny ones, and a star scaled
    to |coordinates| near 1e6."""
    odd = np.array([[-180.0, 10.0, 180.0, 10.5], [180.0, -3.0, -180.0, -3.0],
                    [5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 0.0, 0.0],
                    [1e-3, 2e-3, 1.0001e-3, 2e-3],
                    [-7.25, 1e-30, -7.25, -1e-30]], dtype=np.float32)
    big = gscan.pack_polygon(parse_wkt(_star(-4.0e5, 6.0e5, 3.5e5, 1.2e5, 9)),
                             "cpu").edges.numpy()
    return np.vstack([odd, big])


def _skip_points(edges, seed):
    """Points on the edges' vertices and midpoints, on each side of each
    expanded box at the margin and one ulp either way (beside the edge's
    ends and middle across), seeded points around every edge, and NaN
    and infinite points."""
    lox, hix, loy, hiy = (t.numpy() for t in
                          kernels.pip_edge_terms_plain(torch.from_numpy(edges),
                                                       gscan.EDGE_EPS2))
    x0, y0, x1, y1 = edges.T
    xs, ys = [x0, x1, (x0 + x1) / 2], [y0, y1, (y0 + y1) / 2]
    px, py = list(xs), list(ys)
    for bound, inward in ((lox, np.inf), (hix, -np.inf)):
        for at in (np.nextafter(bound, -inward), bound,
                   np.nextafter(bound, inward)):
            for y in ys:
                px.append(at)
                py.append(y)
    for bound, inward in ((loy, np.inf), (hiy, -np.inf)):
        for at in (np.nextafter(bound, -inward), bound,
                   np.nextafter(bound, inward)):
            for x in xs:
                px.append(x)
                py.append(at)
    rng = np.random.default_rng(seed)
    span = np.maximum(np.abs(edges).max(axis=1), 1.0) * 1e-3
    for _ in range(4):
        px.append(x0 + rng.uniform(-3, 3, len(x0)) * span)
        py.append(y0 + rng.uniform(-3, 3, len(y0)) * span)
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, 3e38, 2.0**61])
    sx, sy = np.meshgrid(special, special)
    return (torch.from_numpy(np.concatenate(px + [sx.ravel()])
                             .astype(np.float32)),
            torch.from_numpy(np.concatenate(py + [sy.ravel()])
                             .astype(np.float32)))


@pytest.mark.parametrize("name", ["star", "holes", "multi", "odd"])
def test_skipped_pairs_cannot_change_a_bit(name):
    """On every (point, edge) pair the kernel skips, the plain d2 is at
    least eps2 (and not NaN) and the division-free crossing equals
    ``cond & (px < xint)``; so the kernel's walk (the skip's verdicts,
    the full path elsewhere) gives pip_mask_plain's bits."""
    if name == "odd":
        edges = _odd_edges()
    else:
        edges = gscan.pack_polygon(parse_wkt(POLYGONS[name]),
                                   "cpu").edges.numpy()
    px, py = _skip_points(edges, seed=len(name))
    e = torch.from_numpy(edges)
    cross, d2 = kernels.pip_pairs_plain(px, py, e)
    skip, cross_skip = kernels.pip_skip_plain(px, py, e, gscan.EDGE_EPS2)
    eps2 = torch.tensor(gscan.EDGE_EPS2, dtype=torch.float32)
    assert bool((d2[skip] >= eps2).all())
    assert torch.equal(cross_skip[skip], cross[skip])
    # the pairs at the margin: one ulp outside skips, the margin itself
    # and one ulp inside do not; non-finite points never skip
    assert skip.any() and (~skip).any()
    finite = torch.isfinite(px) & torch.isfinite(py)
    assert not skip[~finite].any()
    inside = (torch.where(skip, cross_skip, cross).sum(dim=1) % 2) == 1
    least = torch.where(skip, torch.tensor(float("inf")), d2).min(dim=1).values
    want = kernels.pip_mask_plain(px, py, e, gscan.EDGE_EPS2)
    assert torch.equal(inside, want[0])
    assert torch.equal(least < eps2, want[1])
    assert want[1].any()


def test_margin_points_skip_one_ulp_outside():
    """A point one ulp beyond an edge's expanded box (beside the edge)
    is skipped; a point on the box or one ulp inside is not."""
    edges = torch.tensor([[0.0, 0.0, 10.0, 4.0], [-3e5, 2e5, -2e5, 3e5]])
    lox, hix, loy, hiy = kernels.pip_edge_terms_plain(edges, gscan.EDGE_EPS2)
    for k in range(2):
        ymid = float((edges[k, 1] + edges[k, 3]) / 2)
        xs = torch.stack([torch.nextafter(lox[k], torch.tensor(-np.inf)),
                          lox[k], torch.nextafter(lox[k], torch.tensor(np.inf)),
                          torch.nextafter(hix[k], torch.tensor(np.inf)),
                          hix[k]])
        skip, _ = kernels.pip_skip_plain(xs, torch.full_like(xs, ymid),
                                         edges[k:k + 1], gscan.EDGE_EPS2)
        assert skip[:, 0].tolist() == [True, False, False, True, False]
        # the margin exceeds EDGE_EPS by ulps of the edge's magnitude
        m = float(edges[k, 0] if edges[k, 0] < edges[k, 2] else edges[k, 2]) \
            - float(lox[k])
        assert gscan.EDGE_EPS < m < gscan.EDGE_EPS * 1.01 + 2e-6 * 3e5
