"""The port's spatial partitioning (analytics/partitioning.py) against
the JAX package's on the CPU: grid and quadtree envelopes, point
assignment, the index partitioner, and the partitioned DWithin join
(each cell a dwithin_join of the port's).

Tolerance: exact (envelopes, assignments and pairs equal arrays)."""

import numpy as np
import pytest

from geomesa_tpu.analytics import partitioning as jpart
from geomesa_tpu_torch.analytics import partitioning as tpart


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(31)
    na, nb = 6000, 3000
    xa = np.concatenate([rng.normal(10, 3, na // 2),
                         rng.uniform(-40, 40, na - na // 2)])
    ya = np.concatenate([rng.normal(-5, 2, na // 2),
                         rng.uniform(-30, 30, na - na // 2)])
    xb, yb = rng.uniform(-40, 40, nb), rng.uniform(-30, 30, nb)
    xb[:50], yb[:50] = xa[:50], ya[:50]   # pairs at distance 0
    return xa, ya, xb, yb


@pytest.mark.parametrize("nx,ny", [(1, 1), (4, 3), (16, 16)])
def test_grid_partitions(nx, ny):
    env = (-40.0, -30.0, 40.0, 30.0)
    assert np.array_equal(tpart.grid_partitions(env, nx, ny),
                          jpart.grid_partitions(env, nx, ny))


@pytest.mark.parametrize("target,level,sample", [(500, 12, 100_000),
                                                 (100, 3, 100_000),
                                                 (200, 12, 1000)])
def test_quadtree_and_assignment(sides, target, level, sample):
    xa, ya, xb, yb = sides
    got = tpart.quadtree_partitions(xa, ya, target, level, sample)
    want = jpart.quadtree_partitions(xa, ya, target, level, sample)
    assert np.array_equal(got, want)
    for x, y in ((xa, ya), (xb, yb)):
        assert np.array_equal(tpart.assign_partitions(x, y, got),
                              jpart.assign_partitions(x, y, want))


def test_index_partitioner():
    t, j = tpart.IndexPartitioner(5), jpart.IndexPartitioner(5)
    assert [t.partition(i) for i in range(5)] == \
        [j.partition(i) for i in range(5)]
    for p in (t, j):
        with pytest.raises(KeyError):
            p.partition(5)


@pytest.mark.parametrize("grid", [None, (4, 3)])
@pytest.mark.parametrize("radius", [0.3, 2.0])
def test_partitioned_dwithin_join(sides, grid, radius):
    xa, ya, xb, yb = sides
    env = (None if grid is None
           else jpart.grid_partitions((-41.0, -31.0, 41.0, 31.0), *grid))
    got = tpart.partitioned_dwithin_join(xa, ya, xb, yb, radius,
                                         envelopes=env, target_per_cell=700,
                                         device="cpu")
    want = jpart.partitioned_dwithin_join(xa, ya, xb, yb, radius,
                                          envelopes=env, target_per_cell=700)
    assert np.array_equal(got, want)
    d2 = (xa[:, None] - xb) ** 2 + (ya[:, None] - yb) ** 2
    assert len(got) == int((d2 <= radius * radius).sum())
