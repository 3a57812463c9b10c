"""The port's standing filters (geomesa_tpu_torch/filters/compile.py,
scan/standing.py, the standing kernel's plain version and the
continuous-query publisher's device path) against the JAX package's, on
the CPU, at small sizes.

- the compiler: every case of the JAX TestCompiler in both packages, and
  compile_filter's fields equal across packages on a 300-filter seeded
  battery;
- the standing tables (boxes ... alive) equal across packages, slot for
  slot, through growth and churn;
- the standing kernels' plain version (``kernels.standing_pairs``: the
  slot grid, the candidate test, filter-major pairs), and the CPU
  wrappers over several chunks, equal to np.nonzero of the JAX
  ``_standing_mask`` on the same rows and tables (NaN coordinates, null
  dates and numbers, K = 1, 4 and 64, A = 0 and 2, dead slots, box_any,
  catch-all and pre-1970 times, row padding, random tables; the grid's
  edges: whole degrees, NaN, past the world, world-sized boxes,
  overlapping boxes of a slot, box_any slots, dead and never slots,
  churn that reuses tombstoned slots);
- the dispatch: every case of the JAX TestStandingFilterSet and
  TestPublisherDevicePath on the port, the deltas equal to the JAX
  publisher's with ``geomesa.cq.device`` true and false (the port has no
  such switch), final hits equal to ``evaluate`` on subnormal
  coordinates and pre-1970 times.

Tolerance: exact everywhere (bits, ids in order, table words)."""

import numpy as np
import pytest

from geomesa_tpu.features import FeatureBatch as JaxBatch
from geomesa_tpu.features import parse_spec as jax_parse_spec
from geomesa_tpu.filters import evaluate as jax_evaluate
from geomesa_tpu.filters import parse_ecql as jax_parse_ecql
from geomesa_tpu.filters import compile as jax_compile
from geomesa_tpu.scan import standing as jax_standing
from geomesa_tpu.store.continuous import CQ_DEVICE as JAX_CQ_DEVICE
from geomesa_tpu.store.continuous import \
    CQ_PUBLISH_BATCH_ROWS as JAX_PUBLISH_ROWS
from geomesa_tpu.store.continuous import \
    ContinuousQueryPublisher as JaxPublisher
from geomesa_tpu.store.continuous import \
    ContinuousQuerySubscriber as JaxSubscriber
from geomesa_tpu.store.live import LiveDataStore as JaxLive

import torch

from geomesa_tpu_torch.features import FeatureBatch, parse_spec
from geomesa_tpu_torch.filters import evaluate, parse_ecql
from geomesa_tpu_torch.filters import compile as port_compile
from geomesa_tpu_torch.filters.compile import (compile_filter, exact_hits,
                                               exact_match, numeric_attrs)
from geomesa_tpu_torch.scan import kernels
from geomesa_tpu_torch.scan.standing import (CQ_DEVICE_MAX_CELLS,
                                             StandingFilterSet)
from geomesa_tpu_torch.store.continuous import (CQ_PUBLISH_BATCH_ROWS,
                                                ContinuousQueryPublisher,
                                                ContinuousQuerySubscriber)
from geomesa_tpu_torch.store.live import LiveDataStore

SPEC = "name:String,age:Integer,speed:Double,dtg:Date,*geom:Point:srid=4326"
MS_DAY = 86_400_000

# one of each compiler class (the JAX tests' lists): conjunctive
# bbox/time/numeric filters the summary captures exactly, residual
# shapes, and provably-empty conjunctions
EXACT_ECQL = [
    "INCLUDE",
    "BBOX(geom, -50, -20, 10, 30)",
    "BBOX(geom, -10, -10, 10, 10) AND "
    "dtg DURING 2021-03-01T00:00:00Z/2021-06-01T00:00:00Z",
    "dtg AFTER 2021-06-01T00:00:00Z",
    "dtg BEFORE 2021-04-01T00:00:00Z",
    "speed > 100.5",
    "speed >= 100.5",
    "age BETWEEN 10 AND 60",
    "age < 25 AND BBOX(geom, -120, 0, 0, 60)",
    "dtg DURING 2021-02-01T00:00:00Z/2021-02-10T00:00:00Z AND speed < 40",
]
RESIDUAL_ECQL = [
    "name LIKE 'n1%'",
    "name = 'n3'",
    "BBOX(geom, 0, 0, 40, 40) OR BBOX(geom, -40, -40, 0, 0)",
    "NOT (age < 50)",
    "speed BETWEEN 50 AND 60 OR speed BETWEEN 200 AND 220",
    "IN ('d7', 'd11')",
    "BBOX(geom, -190, -90, -170, 90)",
]
NEVER_ECQL = [
    "EXCLUDE",
    "BBOX(geom, 10, 10, 20, 20) AND BBOX(geom, 30, 30, 40, 40)",
    "age > 10 AND age < 5",
]
ALL_ECQL = EXACT_ECQL + RESIDUAL_ECQL + NEVER_ECQL

PACKAGES = ("jax", "torch")
_API = {
    "jax": (jax_parse_spec, jax_parse_ecql, JaxBatch, jax_evaluate,
            jax_compile),
    "torch": (parse_spec, parse_ecql, FeatureBatch, evaluate, port_compile),
}
_TABLES = ("_boxes", "_box_valid", "_box_any", "_times", "_attrs",
           "_attr_any", "_alive")


def messy_data(n, seed=7, id_prefix="d", t0=1609459200000):
    """The JAX tests' messy_batch columns: NaN coordinates, null dates
    and null numeric attributes sprinkled in."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[rng.random(n) < 0.05] = np.nan
    age = np.array([None if i % 29 == 0 else i % 100 for i in range(n)],
                   dtype=object)
    speed = rng.uniform(0, 300, n)
    speed[rng.random(n) < 0.05] = np.nan
    millis = np.int64(t0) + rng.integers(0, 300 * MS_DAY, n).astype(np.int64)
    dtg = np.array([None if i % 31 == 0
                    else np.datetime64(int(millis[i]), "ms")
                    for i in range(n)], dtype=object)
    ids = np.array([f"{id_prefix}{i}" for i in range(n)], dtype=object)
    return ids, {"name": np.array([f"n{i % 17}" for i in range(n)],
                                  dtype=object),
                 "age": age, "speed": speed, "dtg": dtg, "geom": (x, y)}


def messy_batch(pkg, n, seed=7, id_prefix="d", spec=SPEC, t0=1609459200000,
                type_name="pts"):
    ps, _, fb, _, _ = _API[pkg]
    ids, data = messy_data(n, seed, id_prefix, t0)
    sft = ps(type_name, spec)
    data = {a.name: data[a.name] for a in sft.attributes}
    return fb.from_dict(sft, ids, data)


def oracle(pkg, ecql, batch):
    _, pe, _, ev, _ = _API[pkg]
    return np.flatnonzero(ev(pe(ecql), batch))


def battery(seed=0, n=300):
    """A seeded mix: BBOXes (some past the antimeridian), DURING, AFTER,
    BEFORE, BETWEEN, compares, LIKE, IN, OR trees, NOT, EXCLUDE and
    disjoint ANDs, alone and under AND."""
    rng = np.random.default_rng(seed)

    def box():
        cx, cy = rng.uniform(-185, 185), rng.uniform(-88, 88)
        w = rng.uniform(0.2, 30)
        return (f"BBOX(geom, {cx - w:.4f}, {cy - w:.4f}, {cx + w:.4f}, "
                f"{cy + w:.4f})")

    def when():
        d0 = int(rng.integers(-200, 700))
        d1 = d0 + int(rng.integers(1, 90))
        t = lambda d: str(np.datetime64("2020-01-01") + np.timedelta64(d, "D"))
        return rng.choice([f"dtg DURING {t(d0)}T00:00:00Z/{t(d1)}T12:00:00Z",
                           f"dtg AFTER {t(d0)}T06:00:00Z",
                           f"dtg BEFORE {t(d1)}T00:00:00Z",
                           f"dtg TEQUALS {t(d0)}T00:00:00Z"])

    def num():
        lo = float(rng.uniform(0, 200))
        return rng.choice([f"speed BETWEEN {lo:.2f} AND {lo + 40:.2f}",
                           f"age < {int(lo) % 100}", f"age >= {int(lo) % 90}",
                           f"speed > {lo:.3f}", f"speed <= {lo:.1f}",
                           f"age = {int(lo) % 100}", f"age IN ({int(lo) % 50})",
                           f"age <> {int(lo) % 100}"])

    def atom():
        k = int(rng.integers(0, 10))
        if k < 3:
            return box()
        if k < 5:
            return when()
        if k < 7:
            return num()
        if k == 7:
            return rng.choice(["name LIKE 'n1%'", "name = 'n3'",
                               "IN ('d7', 'd11')", "age IS NULL"])
        if k == 8:
            return f"NOT ({num()})"
        return rng.choice(["EXCLUDE", "INCLUDE"])

    out = []
    for i in range(n):
        k = i % 6
        if k == 0:
            out.append(atom())
        elif k == 1:
            out.append(f"{atom()} AND {atom()}")
        elif k == 2:
            out.append(f"{box()} AND {when()} AND {num()}")
        elif k == 3:
            out.append(f"{box()} OR {box()} OR ({atom()} AND {box()})")
        elif k == 4:
            out.append(f"{box()} AND {box()}")     # often disjoint
        else:
            out.append(f"({atom()} OR {atom()}) AND {num()}")
    return out


def _fields(cf):
    return (cf.geom_attr, cf.dtg_attr, cf.boxes, cf.spatial_any, cf.interval,
            {k: (v.lo, v.lo_inc, v.hi, v.hi_inc)
             for k, v in cf.attr_bounds.items()},
            cf.residual, cf.never, cf.n_boxes)


# -- the compiler ------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_numeric_attrs_schema_order(pkg):
    ps, _, _, _, comp = _API[pkg]
    assert comp.numeric_attrs(ps("pts", SPEC)) == ["age", "speed"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_classification(pkg):
    ps, pe, _, _, comp = _API[pkg]
    sft = ps("pts", SPEC)
    for e in EXACT_ECQL:
        cf = comp.compile_filter(pe(e), sft)
        assert not cf.residual and not cf.never, e
    for e in RESIDUAL_ECQL:
        cf = comp.compile_filter(pe(e), sft)
        assert cf.residual and not cf.never, e
    for e in NEVER_ECQL:
        assert comp.compile_filter(pe(e), sft).never, e


@pytest.mark.parametrize("pkg", PACKAGES)
def test_bbox_and_interval_bounds(pkg):
    ps, pe, _, _, comp = _API[pkg]
    cf = comp.compile_filter(pe(
        "BBOX(geom, -10, -5, 10, 5) AND "
        "dtg DURING 2021-03-01T00:00:00Z/2021-06-01T00:00:00Z"),
        ps("pts", SPEC))
    assert cf.boxes == ((-10.0, -5.0, 10.0, 5.0),)
    lo, hi = cf.interval
    assert lo == int(np.datetime64("2021-03-01T00:00:00", "ms")
                     .astype(np.int64)) + 1
    assert hi == int(np.datetime64("2021-06-01T00:00:00", "ms")
                     .astype(np.int64)) - 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_attr_bound_inclusivity(pkg):
    ps, pe, _, _, comp = _API[pkg]
    sft = ps("pts", SPEC)
    gt = comp.compile_filter(pe("speed > 100.5"), sft)
    ge = comp.compile_filter(pe("speed >= 100.5"), sft)
    assert gt.attr_bounds["speed"].lo == 100.5
    assert gt.attr_bounds["speed"].lo_inc is False
    assert ge.attr_bounds["speed"].lo_inc is True
    ab = comp.compile_filter(pe("age BETWEEN 10 AND 60"),
                             sft).attr_bounds["age"]
    assert (ab.lo, ab.hi, ab.lo_inc, ab.hi_inc) == (10.0, 60.0, True, True)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_or_of_bboxes_keeps_both_envelopes(pkg):
    ps, pe, _, _, comp = _API[pkg]
    cf = comp.compile_filter(pe(
        "BBOX(geom, 0, 0, 40, 40) OR BBOX(geom, -40, -40, 0, 0)"),
        ps("pts", SPEC))
    assert cf.residual and cf.n_boxes == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exact_match_equals_oracle_for_compiled_exact(pkg):
    ps, pe, _, _, comp = _API[pkg]
    sft = ps("pts", SPEC)
    batch = messy_batch(pkg, 700)
    rows = np.arange(batch.n)
    for e in EXACT_ECQL:
        cf = comp.compile_filter(pe(e), sft)
        got = rows[comp.exact_match(cf, batch, rows)]
        np.testing.assert_array_equal(got, oracle(pkg, e, batch), err_msg=e)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exact_hits_patches_any_candidate_superset(pkg):
    ps, pe, _, _, comp = _API[pkg]
    sft = ps("pts", SPEC)
    batch = messy_batch(pkg, 500)
    for e in ALL_ECQL:
        f = pe(e)
        cf = comp.compile_filter(f, sft)
        got = comp.exact_hits(cf, f, batch, np.arange(batch.n))
        np.testing.assert_array_equal(got, oracle(pkg, e, batch), err_msg=e)


@pytest.mark.parametrize("part", range(6))
def test_compiled_fields_equal_across_packages(part):
    """compile_filter's fields on 50 filters of the 300-filter battery
    (one parametrised case per sixth), equal in both packages, and the
    port's exact_hits over every row equal to the JAX evaluator."""
    jsft, sft = jax_parse_spec("pts", SPEC), parse_spec("pts", SPEC)
    jb, tb = messy_batch("jax", 400), messy_batch("torch", 400)
    rows = np.arange(tb.n)
    for e in battery()[part::6]:
        jf, tf = jax_parse_ecql(e), parse_ecql(e)
        jcf, tcf = (jax_compile.compile_filter(jf, jsft),
                    compile_filter(tf, sft))
        assert _fields(jcf) == _fields(tcf), e
        np.testing.assert_array_equal(
            exact_hits(tcf, tf, tb, rows),
            np.flatnonzero(jax_evaluate(jf, jb)), err_msg=e)
        if not tcf.residual:
            np.testing.assert_array_equal(
                exact_match(tcf, tb, rows),
                jax_compile.exact_match(jcf, jb, rows), err_msg=e)


# -- the standing tables -----------------------------------------------------

def _sets(spec=SPEC, min_cap=64):
    return (jax_standing.StandingFilterSet(jax_parse_spec("pts", spec),
                                           min_cap=min_cap),
            StandingFilterSet(parse_spec("pts", spec), min_cap=min_cap,
                              device="cpu"))


def _assert_tables_equal(jset, tset):
    assert (jset._cap, jset._k, jset._slots, jset._free, jset._high) == \
           (tset._cap, tset._k, tset._slots, tset._free, tset._high)
    for name in _TABLES:
        a, b = getattr(jset, name), getattr(tset, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


def test_standing_tables_equal_through_growth_and_churn():
    jset, tset = _sets()
    ecqls = battery(seed=3, n=200) + [
        " OR ".join(f"BBOX(geom, {i}, {i}, {i + 1}, {i + 1})"
                    for i in range(-60, 60, 4)),           # K grows to 32
        "dtg DURING 1965-03-01T00:00:00Z/1969-12-31T23:59:59Z",
        "dtg BEFORE 1950-01-01T00:00:01Z"]
    for i, e in enumerate(ecqls):
        jset.register(f"q{i}", jax_parse_ecql(e))
        tset.register(f"q{i}", parse_ecql(e))
        if i in (40, 130, 201):
            _assert_tables_equal(jset, tset)
    rng = np.random.default_rng(4)
    for i in rng.choice(len(ecqls), 60, replace=False):
        assert jset.unregister(f"q{i}") and tset.unregister(f"q{i}")
    for i, e in enumerate(battery(seed=5, n=70)):
        jset.register(f"r{i}", jax_parse_ecql(e))
        tset.register(f"r{i}", parse_ecql(e))
    _assert_tables_equal(jset, tset)
    assert jset.stats() == tset.stats()


# -- the kernels' plain version against _standing_mask ----------------------

def _jax_mask(jset, batch, n_valid, chunk):
    rows = jset._rows_host(batch)
    dev = jax_standing.StandingFilterSet._chunk_device(rows, 0, n_valid,
                                                       chunk)
    import jax.numpy as jnp
    m = jax_standing._standing_mask(*dev, *jset._device(),
                                    jnp.int32(n_valid))
    return np.asarray(m), rows


def _mask_pairs(mask):
    """_flat_nonzero's answer: the row of each set cell, filter-major and
    row-ascending, and each filter's count."""
    return np.nonzero(mask)[1].astype(np.int32), mask.sum(axis=1)


def _torch_rows(rows, chunk, n_valid):
    """Host rows (attributes (n, A)) padded to the chunk as the kernels
    take them: six columns and (A, chunk) attributes."""
    pad = [np.zeros((chunk,) + a.shape[1:], a.dtype) for a in rows]
    for p, a in zip(pad, rows):
        p[:n_valid] = a[:n_valid]
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in pad[:6]]
            + [torch.from_numpy(np.ascontiguousarray(a.T)) for a in pad[6:]])


def _port_pairs(rows, tables, n_valid, chunk, pieces=1):
    """(ids, counts, grid) of the whole plain version on one chunk, after
    checking that the CPU wrappers give the same pairs over the chunk cut
    into ``pieces`` launches."""
    t = _torch_rows(rows, chunk, n_valid)
    tt = [torch.from_numpy(np.ascontiguousarray(a)) for a in tables]
    ids, counts, grid = kernels.standing_pairs_plain([(t, n_valid, 0)], tt)
    step = -(-chunk // pieces)
    chunks = [([c[s:s + step] for c in t[:6]]
               + [c[:, s:s + step] for c in t[6:]],
               max(min(step, n_valid - s), 0), s)
              for s in range(0, chunk, step)]
    got = kernels.standing_pairs(chunks, tt)
    assert torch.equal(got[0], ids) and torch.equal(got[1], counts)
    _assert_grid_lists_once(grid)
    return ids.numpy(), counts.numpy(), grid


def _assert_grid_lists_once(grid):
    """No slot twice in a cell; cell lists only of grid slots; the
    everywhere list exactly the everywhere slots."""
    start = grid.cell_start.numpy().astype(np.int64)
    slots = grid.cell_slots.numpy()
    cell = np.repeat(np.arange(kernels.STANDING_CELLS), np.diff(start))
    key = cell * len(grid.mode) + slots
    assert len(np.unique(key)) == len(key)
    mode = grid.mode.numpy()
    assert (mode[slots] == kernels.STANDING_GRID).all()
    np.testing.assert_array_equal(
        grid.every.numpy(), np.flatnonzero(mode == kernels.STANDING_EVERYWHERE))


def _k_filters(k):
    """A filter whose OR of bboxes has k boxes, then the tables' width."""
    return " OR ".join(f"BBOX(geom, {-170 + 5 * i}, {-80 + 2 * i}, "
                       f"{-150 + 5 * i}, {-40 + 2 * i})" for i in range(k))


@pytest.mark.parametrize("spec,k", [
    (SPEC, 1), (SPEC, 4), (SPEC, 64),
    ("name:String,dtg:Date,*geom:Point:srid=4326", 1),
    ("name:String,dtg:Date,*geom:Point:srid=4326", 4)])
@pytest.mark.parametrize("n,chunk", [(700, 1024), (64, 64), (37, 2048)])
def test_plain_pairs_equal_standing_mask(spec, k, n, chunk):
    """Filters of ALL_ECQL (less what the schema lacks), dead slots, a
    box_any slot, catch-all and pre-1970 intervals, rows before and
    after 1970 with NaN coordinates and null dates and numbers, padded
    to the chunk: the plain version's pairs (grid, candidate test,
    filter-major ids) equal np.nonzero of _standing_mask."""
    jset, tset = _sets(spec)
    has_attrs = "age" in spec
    ecqls = [e for e in ALL_ECQL
             if has_attrs or not any(a in e for a in ("age", "speed"))]
    ecqls += [_k_filters(k),
              "dtg DURING 1969-11-01T00:00:00Z/1970-01-02T00:00:00.001Z",
              "BBOX(geom, -100, -60, 100, 60) AND "
              "dtg BEFORE 1969-12-31T23:00:00Z"]
    for i, e in enumerate(ecqls):
        jset.register(f"q{i}", jax_parse_ecql(e))
        tset.register(f"q{i}", parse_ecql(e))
    for i in (1, 5):
        jset.unregister(f"q{i}")
        tset.unregister(f"q{i}")
    _assert_tables_equal(jset, tset)
    assert jset._k == k or k == 1
    jb = messy_batch("jax", n, spec=spec, t0=-60 * MS_DAY)
    want, _ = _jax_mask(jset, jb, n, chunk)
    tables = [getattr(tset, t) for t in _TABLES]
    rows = tset._rows_host(messy_batch("torch", n, spec=spec,
                                       t0=-60 * MS_DAY))
    ids, counts, grid = _port_pairs(rows, tables, n, chunk, pieces=3)
    want_ids, want_counts = _mask_pairs(want)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    assert want.any() and not want[:, n:].any()
    mode = grid.mode.numpy()
    assert (mode[[1, 5]] == kernels.STANDING_NOWHERE).all()   # dead


def _random_case(rng, f, k, a, chunk):
    """Random tables and rows (NaN coordinates and attributes, rows on a
    box bound's hi word, inverted and catch-all intervals, days both
    sides of 1970, dead and box_any slots, boxes 2-120 degrees wide)."""
    f32 = np.float32
    xhi = rng.uniform(-180, 180, chunk).astype(f32)
    yhi = rng.uniform(-90, 90, chunk).astype(f32)
    xlo, ylo = (rng.uniform(0, 1e-5, chunk).astype(f32) for _ in range(2))
    xhi[rng.random(chunk) < 0.05] = np.nan
    tday = rng.integers(-30, 30, chunk).astype(np.int32)
    tms = rng.integers(0, MS_DAY, chunk).astype(np.int32)
    avhi = rng.uniform(0, 100, (chunk, a)).astype(f32)
    avhi[rng.random((chunk, a)) < 0.05] = np.nan
    avlo = rng.uniform(0, 1e-4, (chunk, a)).astype(f32)
    cx, cy = rng.uniform(-170, 170, (f, k)), rng.uniform(-80, 80, (f, k))
    w = rng.uniform(1, 60, (f, k))
    boxes = np.zeros((f, k, 8), f32)
    boxes[..., 0], boxes[..., 2] = cx - w, cx + w
    boxes[..., 4], boxes[..., 6] = cy - w, cy + w
    boxes[..., 1::2] = rng.uniform(0, 1e-5, (f, k, 4))
    boxes[np.arange(f), 0, 0] = xhi[rng.integers(0, chunk, f)]
    boxes[np.arange(f), 0, 6] = yhi[rng.integers(0, chunk, f)]
    box_valid = rng.random((f, k)) < 0.8
    box_any = rng.random(f) < 0.15
    lo = rng.integers(-30, 20, f)
    times = np.stack([lo, rng.integers(0, MS_DAY, f),
                      lo + rng.integers(-2, 20, f),
                      rng.integers(0, MS_DAY, f)], 1).astype(np.int32)
    times[::4] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
    alo = rng.uniform(0, 70, (f, a))
    attrs = np.stack([alo, rng.uniform(0, 1e-4, (f, a)), alo + 30,
                      np.zeros((f, a))], 2).astype(f32)
    attr_any = rng.random((f, a)) < 0.4
    alive = rng.random(f) < 0.85
    return ([xhi, xlo, yhi, ylo, tday, tms, avhi, avlo],
            [boxes, box_valid, box_any, times, attrs, attr_any, alive])


def _jax_pairs(rows, tables, n_valid):
    import jax.numpy as jnp
    mask = np.asarray(jax_standing._standing_mask(
        *(jnp.asarray(r) for r in rows), *(jnp.asarray(t) for t in tables),
        jnp.int32(n_valid)))
    return _mask_pairs(mask)


def _assert_pairs_equal_jax(rows, tables, n_valid, pieces=1):
    chunk = len(rows[0])
    ids, counts, grid = _port_pairs(rows, tables, n_valid, chunk, pieces)
    want_ids, want_counts = _jax_pairs(rows, tables, n_valid)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    return ids, counts, grid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("f,k,a,chunk,n_valid", [
    (64, 1, 0, 32, 32), (128, 3, 2, 100, 77), (16, 64, 1, 2100, 2099)])
def test_plain_pairs_equal_standing_mask_random_tables(seed, f, k, a, chunk,
                                                       n_valid):
    """Random tables and rows through the JAX program and the plain
    version, pair for pair, in one piece and in several."""
    rows, tables = _random_case(np.random.default_rng(seed), f, k, a, chunk)
    _assert_pairs_equal_jax(rows, tables, n_valid, pieces=1 + seed)


def _edge_case(name):
    """Tables and rows for one adversarial case of the slot grid."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    rows, tables = _random_case(rng, 40, 4, 1, 300)
    xhi, xlo, yhi, ylo, tday, tms, avhi, avlo = rows
    boxes, box_valid, box_any, times, attrs, attr_any, alive = tables
    box_any[:] = False
    alive[:] = True
    # boxes 1-10 degrees wide, so each slot is a grid slot
    cx, cy = rng.uniform(-170, 170, (40, 4)), rng.uniform(-80, 80, (40, 4))
    w = rng.uniform(0.5, 5, (40, 4))
    boxes[..., 0], boxes[..., 2] = cx - w, cx + w
    boxes[..., 4], boxes[..., 6] = cy - w, cy + w
    box_valid[:, 0] = True
    xhi[:150] = np.repeat(cx[:, 0], 4)[:150] + rng.uniform(-5, 5, 150)
    yhi[:150] = np.repeat(cy[:, 0], 4)[:150] + rng.uniform(-5, 5, 150)
    tiny = f32(1e-6)
    if name == "cell_edges":
        # boxes' hi bounds on whole degrees and on the last f32 below
        # one; rows on those words (the lo words deciding on both sides)
        # and on the words next to them, and on the world's edges
        up, down = f32(np.inf), f32(-np.inf)

        def bounds(lo_edge, hi_edge):
            e = rng.integers(lo_edge, hi_edge, (40, 4)).astype(f32)
            w = rng.integers(0, 12, (40, 4)).astype(f32)
            on = rng.random((2, 40, 4)) < 0.5
            return (np.where(on[0], e, np.nextafter(e, up)),
                    np.where(on[1], e + w, np.nextafter(e + w + 1, down)))
        boxes[..., 0], boxes[..., 2] = bounds(-178, 160)
        boxes[..., 4], boxes[..., 6] = bounds(-88, 70)
        boxes[..., 1::2] = rng.choice([-tiny, 0, tiny], (40, 4, 4))
        box_valid[:] = True
        pick = rng.integers(0, 160, 240)
        bx = boxes.reshape(160, 8)[pick]
        side = rng.integers(0, 2, (2, 240))
        xhi[:240] = bx[np.arange(240), 2 * side[0]]
        yhi[:240] = bx[np.arange(240), 4 + 2 * side[1]]
        step = rng.choice([up, down], (2, 120))
        xhi[120:240] = np.nextafter(xhi[120:240], step[0])
        yhi[120:240] = np.nextafter(yhi[120:240], step[1])
        xlo[:] = rng.choice([-tiny, 0, tiny], 300)
        ylo[:] = rng.choice([-tiny, 0, tiny], 300)
        xhi[240:248] = [-180, 180, -180, 180, -0.0, 0.0, 179, -179]
        yhi[240:248] = [-90, 90, 90, -90, 0.0, -0.0, 89, -89]
        xhi[248:] = rng.integers(-180, 181, 52)
        yhi[248:] = rng.integers(-90, 91, 52)
        # XLA's CPU backend flushes subnormals (the f32 next to 0.0)
        for c in (xhi, yhi, boxes):
            c[np.abs(c) < f32(1e-30)] = 0
        times[:] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
        attr_any[:] = True
    elif name == "nan":
        for c in (xhi, yhi, xlo, ylo):
            c[rng.random(300) < 0.2] = np.nan
        avhi[rng.random(avhi.shape) < 0.2] = np.nan
        avlo[rng.random(avlo.shape) < 0.2] = np.nan
        boxes[rng.random((40, 4, 8)) < 0.05] = np.nan   # hi and lo bounds
        box_any[::7] = True
    elif name == "outside_world":
        xhi[:100] = rng.choice([-1e30, -200, -180.5, 180.5, 200, 1e30,
                                np.inf, -np.inf], 100)
        yhi[100:200] = rng.choice([-1e30, -95, -90.5, 90.5, 95, 1e30,
                                   np.inf, -np.inf], 100)
        boxes[:10, 0, 0] = -1e31          # boxes past the world's edges
        boxes[10:20, 0, 2] = np.inf
        boxes[20:30, 0, 4] = -200
        boxes[30:40, 0, 6] = 1e30
        box_valid[:, 0] = True
        times[:] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
    elif name == "world_box":
        boxes[:5, 0] = (-180, 0, 180, 0, -90, 0, 90, 0)
        boxes[5:10, 0] = (-1e38, 0, 1e38, 0, -1e38, 0, 1e38, 0)
        box_valid[:10, 0] = True
        times[:10] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
        attr_any[:10] = True
    elif name == "overlapping_boxes":
        # K = 4 boxes of each slot over one cell (and around it): a pair
        # is listed, tested and written once
        cx = rng.integers(-170, 170, 40)
        cy = rng.integers(-80, 80, 40)
        for j in range(4):
            boxes[:, j, 0] = cx + 0.2 - (j % 2)
            boxes[:, j, 2] = cx + 0.7 + (j // 2)
            boxes[:, j, 4] = cy + 0.1
            boxes[:, j, 6] = cy + 0.9 + (j % 3)
        boxes[..., 1::2] = 0
        box_valid[:] = True
        xhi[:200] = np.repeat(cx, 5) + rng.uniform(0, 1, 200)
        yhi[:200] = np.repeat(cy, 5) + rng.uniform(0, 1, 200)
        times[:] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
        attr_any[:] = True
    elif name == "box_any_time_or_attr":
        box_any[:] = True
        box_valid[:] = False
        times[::2] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)   # attribute only
        attr_any[1::2] = True                            # time only
    elif name == "dead_and_never":
        alive[::3] = False
        box_valid[1::3] = False                          # never: no box
        box_any[::6] = True                              # dead box_any
        times[:] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
        attr_any[:] = True
    return rows, tables


EDGE_CASES = ("cell_edges", "nan", "outside_world", "world_box",
              "overlapping_boxes", "box_any_time_or_attr", "dead_and_never")


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_pairs_grid_edges(name):
    """The grid's edges against the JAX mask, pair for pair: rows and
    bounds on whole degrees, NaN coordinates, attributes and bounds,
    coordinates past +/-180 and +/-90, world-sized boxes (everywhere), K
    = 4 boxes of a slot over one cell, box_any slots with only a time or
    an attribute bound, dead and never slots (nowhere)."""
    rows, tables = _edge_case(name)
    ids, counts, grid = _assert_pairs_equal_jax(rows, tables, 297, pieces=2)
    mode = grid.mode.numpy()
    boxes, box_valid, box_any, _, _, _, alive = tables
    assert counts.sum() > 0 or name == "dead_and_never"
    if name == "world_box":
        assert (mode[:10] == kernels.STANDING_EVERYWHERE).all()
        assert (mode[10:] == kernels.STANDING_GRID).all()
        held = (~np.isnan(rows[0][:297]) & ~np.isnan(rows[2][:297])).sum()
        assert (counts[5:10] == held).all()
    elif name == "overlapping_boxes":
        assert (mode == kernels.STANDING_GRID).all()
        start = grid.cell_start.numpy()
        assert np.diff(start).max() >= 1 and len(grid.every) == 0
    elif name == "box_any_time_or_attr":
        assert (mode == kernels.STANDING_EVERYWHERE).all()
        assert len(grid.cell_slots) == 0
    elif name == "dead_and_never":
        assert (mode[::3] == kernels.STANDING_NOWHERE).all()
        assert (mode[1::3] == kernels.STANDING_NOWHERE).all()
        assert (mode[2::3] == kernels.STANDING_GRID).all()
    elif name == "nan":
        # a row with a NaN hi coordinate has no cell; only everywhere
        # slots hold it
        nan_rows = np.flatnonzero(np.isnan(rows[0][:297])
                                  | np.isnan(rows[2][:297]))
        hit = np.isin(ids, nan_rows)
        slot = np.repeat(np.arange(len(counts)), counts)
        assert hit.any()
        assert (mode[slot[hit]] == kernels.STANDING_EVERYWHERE).all()


def test_plain_cells_are_monotone_and_clamped():
    """The cell function on hi words: whole degrees start a cell, -0.0
    and 0.0 share one, values past the world and infinities clamp into
    the edge cells, NaN has none; and it never decreases."""
    x = torch.tensor([-np.inf, -1e30, -181, -180, -179.5, -0.0, 0.0, 0.5,
                      179, 179.99, 180, 1e30, np.inf, np.nan, 5],
                     dtype=torch.float32)
    y = torch.tensor([-np.inf, -1e30, -91, -90, -89.5, -0.0, 0.0, 0.5,
                      89, 89.99, 90, 1e30, np.inf, 5, np.nan],
                     dtype=torch.float32)
    c = kernels.standing_cells_plain(x, y).tolist()
    gx = kernels.STANDING_GRID_X
    assert c[:13] == [0, 0, 0, 0, 0, 90 * gx + 180, 90 * gx + 180,
                      90 * gx + 180, 179 * gx + 359, 179 * gx + 359,
                      179 * gx + 359, 179 * gx + 359, 179 * gx + 359]
    assert c[13:] == [-1, -1]
    v = torch.from_numpy(np.sort(np.random.default_rng(2).uniform(
        -400, 400, 10_000)).astype(np.float32))
    cx = kernels.standing_cells_plain(v, torch.zeros_like(v)) % gx
    assert bool((cx[1:] >= cx[:-1]).all())


def test_plain_pairs_in_chunks_accumulate_in_place():
    """The CPU wrappers over three chunks of a dispatch's upload: counts
    accumulate into the caller's tensor, the write pass advances the
    caller's cursor to each segment's end, and the pairs equal one
    chunk's; wrong shapes raise."""
    _, tset = _sets()
    for i, e in enumerate(EXACT_ECQL + RESIDUAL_ECQL):
        tset.register(f"q{i}", parse_ecql(e))
    tables = [torch.from_numpy(getattr(tset, t)) for t in _TABLES]
    dev = tset._rows_device(tset._rows_host(messy_batch("torch", 700)), 768)
    grid = kernels.standing_grid(tables)
    counts = torch.zeros(tset._cap, dtype=torch.int32)
    for s in (0, 256, 512):
        got = kernels.standing_count(tset._chunk_views(dev, s, 256), tables,
                                     grid, min(256, 700 - s), counts)
        assert got is counts
    whole = kernels.standing_pairs([(tset._chunk_views(dev, 0, 768), 700,
                                     0)], tables, grid)
    assert torch.equal(whole[1], counts)
    starts, cursor, total = kernels.standing_offsets(counts)
    out = torch.full((total,), -1, dtype=torch.int32)
    for s in (0, 256, 512):
        kernels.standing_write(tset._chunk_views(dev, s, 256), tables, grid,
                               min(256, 700 - s), s, cursor, out)
    assert torch.equal(cursor, starts[1:])
    got = kernels.standing_sort(out, starts, counts, grid.mode)
    assert torch.equal(got, whole[0]) and int(out.min()) >= 0
    with pytest.raises(ValueError, match="counts must be"):
        kernels.standing_count(tset._chunk_views(dev, 0, 256), tables, grid,
                               256, counts[:-1])
    with pytest.raises(ValueError, match="n_valid"):
        kernels.standing_count(tset._chunk_views(dev, 0, 256), tables, grid,
                               257, counts)
    with pytest.raises(ValueError, match="grid"):
        kernels.standing_count(tset._chunk_views(dev, 0, 256), tables,
                               grid._replace(mode=grid.mode[:-1]), 256,
                               counts)


def test_grid_rebuilds_after_churn_and_reuses_without(monkeypatch):
    """Churn that reuses tombstoned slots: the grid is rebuilt after the
    tables change and reused by a dispatch that follows no change; the
    set's pairs equal the JAX mask's each time."""
    jset, tset = _sets()
    for i, e in enumerate(ALL_ECQL):
        jset.register(f"q{i}", jax_parse_ecql(e))
        tset.register(f"q{i}", parse_ecql(e))
    calls = []
    real = kernels.standing_grid
    monkeypatch.setattr(kernels, "standing_grid",
                        lambda t: (calls.append(1), real(t))[1])

    def check(seed):
        jb = messy_batch("jax", 500, seed=seed)
        want, _ = _jax_mask(jset, jb, 500, 512)
        tb = messy_batch("torch", 500, seed=seed)
        rows = tset._rows_host(tb)
        dev = tset._rows_device(rows, 512)
        ids, counts = tset._match(dev, tset.device_tables(), 500, 512)
        want_ids, want_counts = _mask_pairs(want)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(counts, want_counts)

    check(1)
    check(2)
    assert len(calls) == 1
    for i in (0, 3, 8, 12):
        jset.unregister(f"q{i}")
        tset.unregister(f"q{i}")
    for i, e in enumerate(battery(seed=9, n=6)):
        jset.register(f"r{i}", jax_parse_ecql(e))
        tset.register(f"r{i}", parse_ecql(e))
    assert tset._high == len(ALL_ECQL) + 2    # four tombstones reused
    _assert_tables_equal(jset, tset)
    check(3)
    assert len(calls) == 2
    check(4)
    assert len(calls) == 2


# -- the dispatch: the JAX TestStandingFilterSet on the port ------------------

def _port_set(**kw):
    sft = parse_spec("pts", SPEC)
    return sft, StandingFilterSet(sft, device="cpu", **kw)


def _register_all(fset):
    for i, e in enumerate(ALL_ECQL):
        fset.register(f"q{i}", parse_ecql(e))


def test_dispatch_id_exact_vs_oracle():
    _, fset = _port_set()
    _register_all(fset)
    batch = messy_batch("torch", 3000)
    out = fset.dispatch(batch)
    assert sorted(out) == sorted(f"q{i}" for i in range(len(ALL_ECQL)))
    jset, _ = _sets()
    for i, e in enumerate(ALL_ECQL):
        jset.register(f"q{i}", jax_parse_ecql(e))
    jout = jset.dispatch(messy_batch("jax", 3000))
    for i, e in enumerate(ALL_ECQL):
        np.testing.assert_array_equal(out[f"q{i}"],
                                      oracle("torch", e, batch), err_msg=e)
        np.testing.assert_array_equal(out[f"q{i}"], jout[f"q{i}"], err_msg=e)
    assert set(fset.last_split) == {"prep_s", "upload_s", "match_s",
                                    "patch_s"}


@pytest.mark.parametrize("cells", [64 * 64, 64 * 100, 1 << 27])
def test_multi_chunk_dispatch_matches_single_chunk(cells, monkeypatch):
    _, fset = _port_set()
    _register_all(fset)
    batch = messy_batch("torch", 1500)
    single = fset.dispatch(batch)
    calls = {"standing_count": [], "standing_write": []}
    for name, got in calls.items():
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, r=real, g=got, **k: (g.append(1),
                                                            r(*a, **k))[1])
    old = CQ_DEVICE_MAX_CELLS.get()
    try:
        # cap is 64 -> 64-row chunks -> 24 launches for 1500 rows
        CQ_DEVICE_MAX_CELLS.set(str(cells))
        chunk = fset._chunk_rows(1500)
        out = fset.dispatch(batch)
    finally:
        CQ_DEVICE_MAX_CELLS.set(old)
    assert chunk == (64 if cells < 1 << 27 else 2048)
    # one count and one write launch a chunk
    assert [len(c) for c in calls.values()] == [-(-1500 // chunk)] * 2
    for i, e in enumerate(ALL_ECQL):
        np.testing.assert_array_equal(out[f"q{i}"], single[f"q{i}"],
                                      err_msg=e)
        np.testing.assert_array_equal(out[f"q{i}"],
                                      oracle("torch", e, batch), err_msg=e)


def test_churn_within_cap_keeps_shapes_and_storage():
    sft, fset = _port_set()
    for i in range(40):
        fset.register(f"q{i}", parse_ecql(
            f"BBOX(geom, {-50 + i}, -20, {10 + i}, 30)"))
    batch = messy_batch("torch", 512)
    fset.dispatch(batch)
    assert (fset.cache_misses, fset.cache_hits) == (1, 0)
    ptrs = [t.data_ptr() for t in fset.device_tables()]
    for i in range(20):
        fset.unregister(f"q{i}")
    for i in range(20):
        fset.register(f"r{i}", parse_ecql(f"age < {i + 1}"))
    out = fset.dispatch(messy_batch("torch", 512, seed=9))
    assert fset.cache_misses == 1 and fset.cache_hits == 1
    assert [t.data_ptr() for t in fset._dev] == ptrs
    for name, t in zip(_TABLES, fset._dev):
        assert np.array_equal(t.numpy(), getattr(fset, name)), name
    assert "q0" not in out and "r0" in out
    assert len(fset) == 40 and "r5" in fset and "q5" not in fset
    np.testing.assert_array_equal(
        out["r7"], oracle("torch", "age < 8", messy_batch("torch", 512,
                                                          seed=9)))
    # growth past the padded cap is the one new shape class
    for i in range(40, 70):
        fset.register(f"q{i}", parse_ecql(f"speed > {i}"))
    assert fset.stats()["padded_cap"] == 128
    fset.dispatch(batch)
    assert fset.cache_misses == 2


def test_unregister_tombstones_and_duplicate_raises():
    _, fset = _port_set()
    fset.register("a", parse_ecql("age < 10"))
    with pytest.raises(ValueError, match="exists"):
        fset.register("a", parse_ecql("age < 20"))
    assert fset.unregister("a") is True
    assert fset.unregister("a") is False
    assert fset.dispatch(messy_batch("torch", 32)) == {}


def test_stats_surface():
    _, fset = _port_set()
    _register_all(fset)
    st = fset.stats()
    assert st["live"] == len(ALL_ECQL)
    assert st["padded_cap"] >= len(ALL_ECQL)
    assert st["tracked_attrs"] == ["age", "speed"]
    assert st["residual"] == len(RESIDUAL_ECQL)


def test_subnormal_coordinates_and_bounds_are_exact():
    """XLA's CPU backend flushes subnormals, so the raw bits are not
    compared here; the final hits equal evaluate on rows and boxes at
    subnormal coordinates."""
    _, fset = _port_set()
    tiny = 1e-310
    ecqls = [f"BBOX(geom, {tiny}, {-tiny}, {3 * tiny}, {tiny})",
             f"BBOX(geom, 0, 0, {tiny}, {tiny})",
             f"BBOX(geom, {-2 * tiny}, {-2 * tiny}, 0, 0)",
             "BBOX(geom, -1e-300, -1e-300, 1e-300, 1e-300)"]
    for i, e in enumerate(ecqls):
        fset.register(f"q{i}", parse_ecql(e))
    vals = np.array([0.0, tiny, 2 * tiny, 3 * tiny, 4 * tiny, -tiny,
                     -2 * tiny, 5e-324, -5e-324, 1e-300, 2e-300])
    x, y = (a.ravel() for a in np.meshgrid(vals, vals))
    n = len(x)
    batch = FeatureBatch.from_dict(
        parse_spec("pts", SPEC), [f"s{i}" for i in range(n)],
        {"name": ["n"] * n, "age": np.arange(n), "speed": np.zeros(n),
         "dtg": np.zeros(n, dtype=np.int64), "geom": (x, y)})
    out = fset.dispatch(batch)
    for i, e in enumerate(ecqls):
        want = oracle("torch", e, batch)
        assert len(want) > 0, e
        np.testing.assert_array_equal(out[f"q{i}"], want, err_msg=e)


def test_pre_1970_intervals_floor_like_the_rows():
    """Interval bounds split by Python floor division and rows by numpy
    floor division: pre-1970 millis on and around a day's edge."""
    _, fset = _port_set()
    edges = [-MS_DAY, -MS_DAY - 1, -1, 0, 1, -3 * MS_DAY + 7]
    ecqls = []
    for i, ms in enumerate(edges):
        t = str(np.datetime64(ms, "ms"))
        ecqls += [f"dtg AFTER {t}Z", f"dtg BEFORE {t}Z", f"dtg TEQUALS {t}Z"]
    for i, e in enumerate(ecqls):
        fset.register(f"q{i}", parse_ecql(e))
    ms = np.array(sorted({m + d for m in edges for d in (-1, 0, 1)}),
                  dtype=np.int64)
    n = len(ms)
    batch = FeatureBatch.from_dict(
        parse_spec("pts", SPEC), [f"t{i}" for i in range(n)],
        {"name": ["n"] * n, "age": np.arange(n), "speed": np.zeros(n),
         "dtg": ms, "geom": (np.zeros(n), np.zeros(n))})
    out = fset.dispatch(batch)
    jset, _ = _sets()
    for i, e in enumerate(ecqls):
        jset.register(f"q{i}", jax_parse_ecql(e))
    _assert_tables_equal(jset, fset)
    for i, e in enumerate(ecqls):
        np.testing.assert_array_equal(out[f"q{i}"],
                                      oracle("torch", e, batch), err_msg=e)


# -- the publisher's device path: the JAX TestPublisherDevicePath -------------

def _live(pkg, type_name="pts"):
    if pkg == "jax":
        store = JaxLive()
        store.create_schema(jax_parse_spec(type_name, SPEC))
    else:
        store = LiveDataStore(device="cpu")
        store.create_schema(parse_spec(type_name, SPEC))
    return store


def _run_publishes(pkg, device=True, n_writes=2, rows=200):
    """A fresh store + publisher + per-topic capture of each delta's ids
    and visibilities; for the JAX package with geomesa.cq.device pinned."""
    store = _live(pkg)
    pub, sub = ((JaxPublisher, JaxSubscriber) if pkg == "jax" else
                (ContinuousQueryPublisher, ContinuousQuerySubscriber))
    pub = pub(store)
    topics = {}
    for i, e in enumerate(ALL_ECQL):
        pub.register(f"q{i}", "pts", e)
        got = topics[f"q{i}"] = []
        sub(f"q{i}", bus=store.bus).on_message(lambda m, g=got: g.append(
            (tuple(str(x) for x in m.batch.ids), m.visibilities)))
    old = JAX_CQ_DEVICE.get()
    try:
        JAX_CQ_DEVICE.set("true" if device else "false")
        for w in range(n_writes):
            batch = messy_batch(pkg, rows, seed=w, id_prefix=f"w{w}_")
            store.write("pts", batch, visibilities=tuple(
                None if i % 3 else f"v{i % 7}" for i in range(rows)))
    finally:
        JAX_CQ_DEVICE.set(old)
    return pub, topics


@pytest.mark.parametrize("jax_device", [True, False])
def test_deltas_equal_the_jax_publishers(jax_device):
    """The port (no switch: always the device path) publishes the same
    messages, chunking and order as the JAX publisher on its device path
    and on its host loop."""
    old = (CQ_PUBLISH_BATCH_ROWS.get(), JAX_PUBLISH_ROWS.get())
    try:
        CQ_PUBLISH_BATCH_ROWS.set("32")  # force chunked deltas too
        JAX_PUBLISH_ROWS.set("32")
        pub_j, jax_topics = _run_publishes("jax", device=jax_device)
        pub_t, port_topics = _run_publishes("torch")
    finally:
        CQ_PUBLISH_BATCH_ROWS.set(old[0])
        JAX_PUBLISH_ROWS.set(old[1])
    assert port_topics == jax_topics
    assert sum(map(len, port_topics.values())) > len(ALL_ECQL)
    for qj, qt in zip(pub_j.queries(), pub_t.queries()):
        assert (qj.name, qj.matched, qj.published) == \
               (qt.name, qt.matched, qt.published)
    assert any(s["plan_cache_misses"] >= 1 for s in pub_t.device_stats())


def test_device_path_matches_oracle_per_query():
    store = _live("torch")
    pub = ContinuousQueryPublisher(store)
    for i, e in enumerate(ALL_ECQL):
        pub.register(f"q{i}", "pts", e)
    batch = messy_batch("torch", 400)
    store.write("pts", batch)
    for i, e in enumerate(ALL_ECQL):
        q = next(q for q in pub.queries() if q.name == f"q{i}")
        assert q.matched == len(oracle("torch", e, batch)), e


def test_unreadable_schema_stays_host_only():
    store = LiveDataStore(device="cpu")
    pub = ContinuousQueryPublisher(store)
    # registered BEFORE the schema exists: the publisher cannot compile
    # it, and the type stays on the host loop for good
    cq = pub.register("early", "pts", "age < 10")
    store.create_schema(parse_spec("pts", SPEC))
    kernels_before = dict(kernels.launches)
    store.write("pts", messy_batch("torch", 100))
    assert cq.matched == len(oracle("torch", "age < 10",
                                    messy_batch("torch", 100)))
    assert pub.device_stats() == []
    pub.register("late", "pts", "age < 5")
    assert pub.device_stats() == []
    assert kernels.launches == kernels_before


def test_dispatch_errors_reach_the_writer(monkeypatch):
    """No catch-all fallback: an error of the device dispatch is counted
    and raised to the writer; the cache applied the message first."""
    from geomesa_tpu_torch.metrics import MetricsRegistry
    store = _live("torch")
    reg = MetricsRegistry()
    pub = ContinuousQueryPublisher(store, registry=reg)
    pub.register("a", "pts", "INCLUDE")

    def boom(*a, **k):
        raise RuntimeError("standing launch failed")
    monkeypatch.setattr(kernels, "standing_count", boom)
    with pytest.raises(RuntimeError, match="standing launch failed"):
        store.write("pts", messy_batch("torch", 50))
    assert reg.snapshot()["counters"]["cq.device.errors"] == 1
    assert store.count("pts") == 50
    assert next(iter(pub.queries())).matched == 0


def test_unregister_detaches_listener_on_last_query():
    store = _live("torch")
    pub = ContinuousQueryPublisher(store)
    pub.register("a", "pts", "age < 10")
    pub.register("b", "pts", "age < 20")
    assert len(store._listeners["pts"]) == 1
    pub.unregister("a")
    assert len(store._listeners["pts"]) == 1
    pub.unregister("b")
    assert store._listeners["pts"] == []


def test_close_detaches_everything():
    store = _live("torch")
    pub = ContinuousQueryPublisher(store)
    cq = pub.register("a", "pts", "INCLUDE")
    pub.close()
    assert store._listeners["pts"] == []
    assert pub.queries() == [] and pub.device_stats() == []
    store.write("pts", messy_batch("torch", 10))
    assert cq.matched == 0


def test_reregister_after_unregister_keeps_shape_class():
    store = _live("torch")
    pub = ContinuousQueryPublisher(store)
    pub.register("a", "pts", "age < 10")
    store.write("pts", messy_batch("torch", 256))
    [st] = pub.device_stats()
    misses = st["plan_cache_misses"]
    pub.unregister("a")
    pub.register("a", "pts", "age < 30")  # filter sets survive churn
    store.write("pts", messy_batch("torch", 256, seed=9))
    [st] = pub.device_stats()
    assert st["plan_cache_misses"] == misses
    assert st["plan_cache_hits"] >= 1


def test_visibilities_stay_row_aligned_through_chunks():
    store = _live("torch")
    sft = store.get_schema("pts")
    old = CQ_PUBLISH_BATCH_ROWS.get()
    try:
        CQ_PUBLISH_BATCH_ROWS.set("32")
        pub = ContinuousQueryPublisher(store)
        pub.register("vis", "pts", "age BETWEEN 3 AND 80")
        sub = ContinuousQuerySubscriber("vis", bus=store.bus)
        msgs = []
        sub.on_message(msgs.append)
        n = 120
        ids = np.array([f"f{i}" for i in range(n)], dtype=object)
        batch = FeatureBatch.from_dict(sft, ids, {
            "name": np.array(["n"] * n, dtype=object),
            "age": np.arange(n), "speed": np.zeros(n),
            "dtg": np.full(n, 1609459200000, dtype=np.int64),
            "geom": (np.zeros(n), np.zeros(n))})
        store.write("pts", batch,
                    visibilities=tuple(f"v{i}" for i in range(n)))
        hits = [i for i in range(n) if 3 <= i <= 80]
        assert [m.batch.n for m in msgs] == [32, 32, 14]
        flat_ids, flat_vis = [], []
        for m in msgs:
            assert len(m.visibilities) == m.batch.n
            flat_ids.extend(str(x) for x in m.batch.ids)
            flat_vis.extend(m.visibilities)
        assert flat_ids == [f"f{i}" for i in hits]
        assert flat_vis == [f"v{i}" for i in hits]
    finally:
        CQ_PUBLISH_BATCH_ROWS.set(old)


def test_knob_defaults():
    from geomesa_tpu_torch.store import continuous
    assert CQ_PUBLISH_BATCH_ROWS.default == "8192"
    assert CQ_DEVICE_MAX_CELLS.default == str(1 << 27)
    assert not hasattr(continuous, "CQ_DEVICE")
    assert numeric_attrs(parse_spec("pts", SPEC)) == ["age", "speed"]
