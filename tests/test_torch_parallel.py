"""The port's sharded scans and ring collectives (``geomesa_tpu_torch.
parallel``) against the JAX package's 8-device mesh on the CPU.

The port runs ``data_mesh(8, device="cpu")``: eight shards on the CPU,
the kernels' plain versions in each shard's loop, against the JAX
package's ``data_mesh()`` over the eight virtual CPU devices that
``tests/conftest.py`` forces. Both get the same seeded numpy inputs, so
both place rows alike (``per = ceil(n / 8)``). The ten cases of
``tests/test_parallel.py`` run here with their own oracles, and each is
also held to the JAX result. Tolerances: exact for masks, hit rows,
counts, (sure, band) arrays, KNN ids in order, contains counts,
tristate states, histograms and min/max; the density grid bit for bit
(it bins the raw two-float verdict, so it is held to the JAX mesh's
grid, not to the single store's)."""

import numpy as np
import pytest
import torch

from geomesa_tpu import parallel as jpar
from geomesa_tpu.scan import gscan as jgscan
from geomesa_tpu.scan import zscan as jzscan
from geomesa_tpu_torch import parallel as tpar
from geomesa_tpu_torch.parallel import mesh as tmesh
from geomesa_tpu_torch.scan import gscan as tgscan
from geomesa_tpu_torch.scan import zscan as tzscan

MS_DAY = 86_400_000
K = 8


def _rect(P, cx, cy, w, h):
    return P.Polygon([(cx - w, cy - h), (cx + w, cy - h), (cx + w, cy + h),
                      (cx - w, cy + h)])


class _Geo:
    def __init__(self, pkg):
        import importlib
        base = importlib.import_module(f"{pkg}.geometry.base")
        self.Polygon = base.Polygon


JG, TG = _Geo("geomesa_tpu"), _Geo("geomesa_tpu_torch")


def _contains_oracle(polys, px, py):
    want = np.zeros(len(polys), np.int64)
    for j, p in enumerate(polys):
        env = p.envelope
        m = ((px >= env.xmin) & (px <= env.xmax)
             & (py >= env.ymin) & (py <= env.ymax))
        ridx = np.flatnonzero(m)
        want[j] = int(p.contains_points(px[ridx], py[ridx]).sum())
    return want


@pytest.fixture(scope="module")
def meshes():
    import jax
    assert len(jax.devices()) == K, "conftest must force 8 cpu devices"
    return jpar.data_mesh(), tpar.data_mesh(K, device="cpu")


@pytest.fixture(scope="module")
def setup(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(7)
    n = 100_003  # deliberately not divisible by 8
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    ms = rng.integers(0, 1000 * MS_DAY, n)
    return (jm, tm, jpar.shard_scan_data(x, y, ms, jm),
            tpar.shard_scan_data(x, y, ms, tm), x, y, ms)


def _both_queries(boxes, intervals):
    return jzscan.make_query(boxes, intervals), tzscan.make_query(boxes,
                                                                   intervals)


class TestDistributedScan:
    def test_sharded_mask_matches_brute_force(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        jq, tq = _both_queries([(-80.0, 30.0, -60.0, 45.0)],
                               [(100 * MS_DAY, 200 * MS_DAY)])
        mask = tpar.distributed_scan_mask(td, tq).cpu().numpy()
        assert len(mask) == td.n_padded == len(
            np.asarray(jpar.distributed_scan_mask(jd, jq)))
        expect = ((x >= -80) & (x <= -60) & (y >= 30) & (y <= 45)
                  & (ms >= 100 * MS_DAY) & (ms <= 200 * MS_DAY))
        assert np.array_equal(mask[:len(x)], expect)
        assert np.array_equal(mask, np.asarray(
            jpar.distributed_scan_mask(jd, jq)))

    def test_padding_rows_never_match(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        jq, tq = _both_queries([(-180.0, -90.0, 180.0, 90.0)], [])
        mask = tpar.distributed_scan_mask(td, tq).cpu().numpy()
        assert mask[:len(x)].all()
        assert not mask[len(x):].any()
        assert td.per == -(-len(x) // K) and len(td.cols) == K

    def test_distributed_count_psum(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        jq, tq = _both_queries([(0.0, 0.0, 90.0, 45.0)], [(0, 500 * MS_DAY)])
        n = tpar.distributed_count(td, tq)
        expect = int(((x >= 0) & (x <= 90) & (y >= 0) & (y <= 45)
                      & (ms <= 500 * MS_DAY)).sum())
        assert n == expect == jpar.distributed_count(jd, jq)

    def test_distributed_density(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        bbox = (-180.0, -90.0, 180.0, 90.0)
        jq, tq = _both_queries([bbox], [])
        grid = tpar.distributed_density(td, tq, bbox, 36, 18)
        assert grid.shape == (18, 36) and grid.dtype == np.float32
        assert int(grid.sum()) == len(x)
        assert grid.std() < grid.mean()
        want = jpar.distributed_density(jd, jq, bbox, 36, 18)
        assert grid.tobytes() == np.asarray(want, np.float32).tobytes()

    @pytest.mark.parametrize("bbox,box,iv", [
        ((-80.0, 30.0, -60.0, 45.0), (-81.0, 29.0, -59.0, 46.0),
         [(20 * MS_DAY, 500 * MS_DAY)]),
        ((-10.0, -10.0, 10.0, 10.0), (-10.0, -10.0, 10.0, 10.0), []),
        ((-1.0, -1.0, 1.0, 1.0), (-180.0, -90.0, 180.0, 90.0), []),
        ((3.1, 2.7, 3.3, 2.9), (-179.0, -89.0, 179.0, 89.0), []),
    ])
    def test_density_grid_bit_equal(self, setup, bbox, box, iv):
        """Zoomed grids, rows outside the grid's box clipped into its
        edge cells, and a box narrower than the grid."""
        jm, tm, jd, td, x, y, ms = setup
        jq, tq = _both_queries([box], iv)
        for w, h in ((64, 32), (7, 5), (1, 1)):
            got = tpar.distributed_density(td, tq, bbox, w, h)
            want = np.asarray(jpar.distributed_density(jd, jq, bbox, w, h),
                              np.float32)
            assert got.tobytes() == want.tobytes()

    def test_multi_box_query(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        jq, tq = _both_queries([(-20.0, -20.0, 0.0, 0.0),
                                (50.0, 50.0, 70.0, 60.0)], [])
        n = tpar.distributed_count(td, tq)
        expect = int((((x >= -20) & (x <= 0) & (y >= -20) & (y <= 0))
                      | ((x >= 50) & (x <= 70) & (y >= 50)
                         & (y <= 60))).sum())
        assert n == expect == jpar.distributed_count(jd, jq)

    def test_exact_hit_rows_patch_boundaries(self, setup):
        """Box bounds at data values: the boundary candidates flip, and
        the f64 patch in row-set space gives the brute force's rows."""
        jm, tm, jd, td, x, y, ms = setup
        boxes = [(x[5], y[9], x[5] + 20.0, y[9] + 15.0),
                 (x[17] - 3.0, y[17] - 3.0, x[17], y[17])]
        iv = [(ms[5], ms[5] + 300 * MS_DAY)]
        jq, tq = _both_queries(boxes, iv)
        got = tpar.exact_hit_rows(td, tq)
        hit = np.zeros(len(x), bool)
        for x0, y0, x1, y1 in boxes:
            hit |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        hit &= (ms >= iv[0][0]) & (ms <= iv[0][1])
        assert np.array_equal(got, np.flatnonzero(hit))
        assert np.array_equal(got, jpar.exact_hit_rows(jd, jq))
        assert np.array_equal(tpar.exact_host_mask(td, tq), hit)

    def test_batch_exact_hit_rows(self, setup):
        jm, tm, jd, td, x, y, ms = setup
        from geomesa_tpu.parallel.mesh import batch_exact_hit_rows as jbatch
        rng = np.random.default_rng(3)
        specs = []
        for i in range(6):
            x0, y0 = rng.uniform(-170, 150), rng.uniform(-80, 60)
            boxes = [(x0, y0, x0 + 25.0, y0 + 18.0)]
            if i == 2:
                boxes.append((x[3], y[3], x[3] + 1.0, y[3] + 1.0))
            iv = [] if i % 3 == 1 else [(int(ms[i]), int(ms[i]) + 200 *
                                         MS_DAY)]
            specs.append((boxes, iv))
        jbq = jzscan.stack_queries([jzscan.make_query(*s) for s in specs])
        tbq = tzscan.stack_queries([tzscan.make_query(*s) for s in specs])
        got = tmesh.batch_exact_hit_rows(td, tbq)
        want = jbatch(jd, jbq)
        for (boxes, iv), g, w in zip(specs, got, want):
            hit = np.zeros(len(x), bool)
            for x0, y0, x1, y1 in boxes:
                hit |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
            if iv:
                hit &= (ms >= iv[0][0]) & (ms <= iv[0][1])
            assert np.array_equal(g, np.flatnonzero(hit))
            assert np.array_equal(g, w)


class TestRingCollectives:
    def test_ring_dwithin_counts_vs_brute_force(self, meshes):
        jm, tm = meshes
        rng = np.random.default_rng(21)
        nl, nr = 4_001, 2_003  # not divisible by 8
        lx = rng.uniform(0, 10, nl)
        ly = rng.uniform(0, 10, nl)
        rx = rng.uniform(0, 10, nr)
        ry = rng.uniform(0, 10, nr)
        r = 0.5
        lxj, lyj, lvalid, _ = tpar.shard_points(lx, ly, tm)
        rxj, ryj, rvalid, _ = tpar.shard_points(rx, ry, tm)
        sure, band = tpar.ring_dwithin_counts(lxj, lyj, lvalid, rxj, ryj,
                                              rvalid, tm, r, coord_span=10.0)
        d2 = ((lx[:, None] - rx[None, :]) ** 2
              + (ly[:, None] - ry[None, :]) ** 2)
        want = (d2 <= r * r).sum(axis=1)
        got = sure[:nl].astype(np.int64)
        need = np.flatnonzero(band[:nl])
        for i in need:
            got[i] = int((d2[i] <= r * r).sum())
        assert np.array_equal(got, want)
        assert np.all(sure[:nl] <= want)
        assert len(need) < nl * 0.05
        jl = jpar.shard_points(lx, ly, jm)
        jr = jpar.shard_points(rx, ry, jm)
        jsure, jband = jpar.ring_dwithin_counts(*jl[:3], *jr[:3], jm, r,
                                                coord_span=10.0)
        assert np.array_equal(sure, jsure) and np.array_equal(band, jband)
        assert not sure[nl:].any() and not band[nl:].any()

    def test_distributed_knn_exact(self, meshes):
        jm, tm = meshes
        rng = np.random.default_rng(22)
        n = 50_007
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        xj, yj, valid, _ = tpar.shard_points(x, y, tm)
        qx, qy, k = 12.3, -45.6, 100
        got = tpar.distributed_knn(xj, yj, valid, tm, n, qx, qy, k,
                                   host_x=x, host_y=y)
        d2 = (x - qx) ** 2 + (y - qy) ** 2
        want = np.argsort(d2, kind="stable")[:k]
        assert np.array_equal(np.sort(got), np.sort(want))
        jx = jpar.shard_points(x, y, jm)
        assert np.array_equal(got, jpar.distributed_knn(
            *jx[:3], jm, n, qx, qy, k, host_x=x, host_y=y))
        # no re-rank source: the f32 distances rank as they are
        assert np.array_equal(
            tpar.distributed_knn(xj, yj, valid, tm, n, qx, qy, k),
            jpar.distributed_knn(*jx[:3], jm, n, qx, qy, k))

    def test_distributed_knn_split_no_host_copy(self, meshes):
        jm, tm = meshes
        rng = np.random.default_rng(23)
        n = 40_003
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        # duplicate points: exact ties resolve in candidate order
        x[100:140] = x[:40]
        y[100:140] = y[:40]
        split, valid, _ = tpar.shard_points_split(x, y, tm)
        jsplit, jvalid, _ = jpar.shard_points_split(x, y, jm)
        for qx, qy, k in ((-77.1, 38.9, 64), (x[3], y[3], 5),
                          (x[7] + 1e-9, y[7], 33)):
            got = tpar.distributed_knn(None, None, valid, tm, n, qx, qy, k,
                                       split=split)
            d2 = (x - qx) ** 2 + (y - qy) ** 2
            want = np.argsort(d2, kind="stable")[:k]
            assert np.array_equal(np.sort(got), np.sort(want))
            assert np.array_equal(got, jpar.distributed_knn(
                None, None, jvalid, jm, n, qx, qy, k, split=jsplit))
        assert np.array_equal(
            tpar.distributed_knn(None, None, valid, tm, n, -77.1, 38.9, 64,
                                 split=split),
            np.argsort((x + 77.1) ** 2 + (y - 38.9) ** 2, kind="stable")[:64])

    def test_knn_split_of_scan_columns_equals_shard_points_split(self,
                                                                 meshes):
        # the mesh store's KNN prunes read the scan columns: the same
        # tensors, padded alike, as the reference's second split copy
        jm, tm = meshes
        rng = np.random.default_rng(29)
        n = 40_003
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        ms = rng.integers(0, 1000 * MS_DAY, n)
        sp, valid, n_sp = tpar.shard_scan_data(x, y, ms, tm).knn_split()
        want_sp, want_valid, want_n = tpar.shard_points_split(x, y, tm)
        assert n_sp == want_n == n
        for got_c, want_c in zip(sp, want_sp):
            assert all(g.dtype == w.dtype and torch.equal(g, w)
                       for g, w in zip(got_c, want_c))
        assert all(torch.equal(g, w) for g, w in zip(valid, want_valid))
        jsplit, jvalid, _ = jpar.shard_points_split(x, y, jm)
        for qx, qy, k in ((-77.1, 38.9, 64), (x[5], y[5], 7)):
            assert np.array_equal(
                tpar.distributed_knn(None, None, valid, tm, n, qx, qy, k,
                                     split=sp),
                jpar.distributed_knn(None, None, jvalid, jm, n, qx, qy, k,
                                     split=jsplit))

    def test_distributed_histogram_and_minmax(self, meshes):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        jm, tm = meshes
        rng = np.random.default_rng(23)
        n = 80_000  # divisible by 8
        v = rng.uniform(0, 100, n).astype(np.float32)
        v[:10] = [0.0, 100.0, 50.0, 99.99999, 5.0, 5.000001, -1.0, 101.0,
                  np.nan, 95.0]
        m = rng.random(n) < 0.5
        m[:10] = True
        vt = tmesh.shard_tensor(v, tm)
        mt = tmesh.shard_tensor(m, tm)
        hist = tpar.distributed_histogram(vt, mt, tm, 20, 0.0, 100.0)
        want, _ = np.histogram(v[m & ~np.isnan(v)], bins=20,
                               range=(0.0, 100.0))
        assert np.array_equal(hist, want)
        sh = NamedSharding(jm, P("data"))
        vj = jax.device_put(jnp.asarray(v), sh)
        mj = jax.device_put(jnp.asarray(m), sh)
        assert np.array_equal(hist, jpar.distributed_histogram(
            vj, mj, jm, 20, 0.0, 100.0))
        for nb, lo, hi in ((7, 3.3, 77.7), (1, 0.0, 1e-3)):
            assert np.array_equal(
                tpar.distributed_histogram(vt, mt, tm, nb, lo, hi),
                jpar.distributed_histogram(vj, mj, jm, nb, lo, hi))
        with pytest.raises(ValueError):
            tpar.distributed_histogram(vt, mt, tm, 0, 0.0, 1.0)
        mm = m & ~np.isnan(v)
        mt2 = tmesh.shard_tensor(mm, tm)
        vmin, vmax = tpar.distributed_minmax(vt, mt2, tm)
        assert vmin == pytest.approx(v[mm].min())
        assert vmax == pytest.approx(v[mm].max())
        assert (vmin, vmax) == jpar.distributed_minmax(
            vj, jax.device_put(jnp.asarray(mm), sh), jm)

    def test_distributed_knn_k_exceeds_shard_size(self, meshes):
        jm, tm = meshes
        rng = np.random.default_rng(24)
        n = 100  # shard size 13 on 8 devices, k = 50 > 13
        x = rng.uniform(-10, 10, n)
        y = rng.uniform(-10, 10, n)
        xj, yj, valid, _ = tpar.shard_points(x, y, tm)
        got = tpar.distributed_knn(xj, yj, valid, tm, n, 0.0, 0.0, 50,
                                   host_x=x, host_y=y)
        d2 = x ** 2 + y ** 2
        want = np.argsort(d2, kind="stable")[:50]
        assert np.array_equal(np.sort(got), np.sort(want))
        jx = jpar.shard_points(x, y, jm)
        assert np.array_equal(got, jpar.distributed_knn(
            *jx[:3], jm, n, 0.0, 0.0, 50, host_x=x, host_y=y))


class TestExtentTristate:
    @pytest.mark.parametrize("has_time", [True, False])
    def test_tristate_matches_reference(self, meshes, has_time):
        jm, tm = meshes
        rng = np.random.default_rng(31)
        n = 20_001
        cx = rng.uniform(-170, 170, n)
        cy = rng.uniform(-80, 80, n)
        w = rng.uniform(0.01, 3, n)
        bounds = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
        bounds[::97] = np.nan
        ms = rng.integers(0, 100 * MS_DAY, n) if has_time else None
        jd = jpar.shard_extent_data(bounds, ms, jm)
        td = tpar.shard_extent_data(bounds, ms, tm)
        for boxes, iv in (([(-20.0, -15.0, 31.5, 42.25)], []),
                          ([(-20.0, -15.0, 31.5, 42.25), (100, 0, 120, 10)],
                           [(5 * MS_DAY, 40 * MS_DAY)]),
                          ([(-180.0, -90.0, 180.0, 90.0)],
                           [(0, 3 * MS_DAY), (50 * MS_DAY, 60 * MS_DAY)])):
            got = tpar.distributed_tristate(td, tgscan.extent_query(boxes,
                                                                    iv))
            want = np.asarray(jpar.distributed_tristate(
                jd, jgscan.extent_query(boxes, iv)))
            assert got.dtype == np.int8 and len(got) == n
            assert np.array_equal(got, want)


class TestMeshContains:
    def test_counts_exact_on_seeded_1m(self, meshes):
        jm, tm = meshes
        from geomesa_tpu.parallel.mesh import \
            distributed_contains_counts as jcontains
        rng = np.random.default_rng(1234)  # the bench seed
        n = 1_000_000
        px = rng.uniform(-180, 180, n)
        py = rng.uniform(-90, 90, n)
        ms = np.zeros(n, np.int64)
        spec = [(rng.uniform(-170, 170), rng.uniform(-80, 80),
                 rng.uniform(0.5, 3), rng.uniform(0.5, 3))
                for _ in range(50)]
        tpolys = [_rect(TG, *s) for s in spec]
        jpolys = [_rect(JG, *s) for s in spec]
        data = tpar.shard_scan_data(px, py, ms, tm)
        counts = tmesh.distributed_contains_counts(data, tpolys)
        assert np.array_equal(counts, _contains_oracle(jpolys, px, py))
        assert np.array_equal(counts, jcontains(
            jpar.shard_scan_data(px, py, ms, jm), jpolys))

    def test_band_overflow_falls_back_to_host_recount(self, meshes):
        jm, tm = meshes
        from geomesa_tpu.parallel.mesh import \
            distributed_contains_counts as jcontains
        rng = np.random.default_rng(6)
        n = 20_000
        px = rng.uniform(-2, 2, n)
        py = rng.uniform(-2, 2, n)
        # flood the boundary: far more band rows than band_cap=2
        px[:600] = 1.0
        py[:600] = np.linspace(-1, 1, 600)
        ms = np.zeros(n, np.int64)
        data = tpar.shard_scan_data(px, py, ms, tm)
        for cap in (2, 512):
            counts = tmesh.distributed_contains_counts(
                data, [_rect(TG, 0.0, 0.0, 1.0, 1.0)], band_cap=cap)
            want = _contains_oracle([_rect(JG, 0.0, 0.0, 1.0, 1.0)], px, py)
            assert np.array_equal(counts, want)
            assert np.array_equal(counts, jcontains(
                jpar.shard_scan_data(px, py, ms, jm),
                [_rect(JG, 0.0, 0.0, 1.0, 1.0)], band_cap=cap))


class TestMeshShape:
    def test_data_mesh_places_shards(self):
        m = tpar.data_mesh(8, device="cpu")
        assert m.size == len(m.devices) == 8
        assert all(d.type == "cpu" for d in m.devices)
        assert tpar.data_mesh(device="cpu").size == 1
        with pytest.raises(ValueError):
            tpar.data_mesh(0, device="cpu")

    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 17])
    def test_row_placement_is_the_reference_s(self, meshes, n):
        jm, tm = meshes
        rng = np.random.default_rng(n)
        x = rng.uniform(-10, 10, n)
        y = rng.uniform(-10, 10, n)
        ms = rng.integers(0, MS_DAY, n)
        jd = jpar.shard_scan_data(x, y, ms, jm)
        td = tpar.shard_scan_data(x, y, ms, tm)
        assert td.n_padded == jd.n_padded and td.n == n
        for j, name in enumerate(("xhi", "xlo", "yhi", "ylo", "tday",
                                  "tms")):
            flat = np.concatenate([c[j].numpy() for c in td.cols])
            assert flat.tobytes() == np.asarray(getattr(jd, name)).tobytes()
