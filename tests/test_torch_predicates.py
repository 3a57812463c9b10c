"""The port's store against the JAX reference store on the CPU, on a
point schema with every attribute type the port stores and two indexed
attributes: the exact predicate grammar (attribute compares, IN, LIKE,
IS NULL, NOT, EXCLUDE, fid filters, the temporal operators, polygon
and multipolygon INTERSECTS/WITHIN/DISJOINT) through every strategy
(z3, z2, id, attr, fullscan) and both secondaries (the dense residual
kernel, the f64 host evaluator on gathered candidates). Tolerance:
exact, the ids id for id and the counts."""

import numpy as np
import pytest

from geomesa_tpu.features import FeatureBatch as JaxBatch
from geomesa_tpu.features import parse_spec as jax_parse_spec
from geomesa_tpu.filters import evaluate as jax_evaluate
from geomesa_tpu.filters import parse_ecql as jax_parse_ecql
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.scan import kernels

SPEC = ("name:String,code:String:index=true,age:Integer:index=true,"
        "big:Long,score:Double,ratio:Float,flag:Boolean,dtg:Date,"
        "*geom:Point:srid=4326")
MS_DAY = 86_400_000
T0 = int(np.datetime64("2021-01-01T00:00:00", "ms").astype(np.int64))
CHUNKS = [0, 20_000, 25_000, 30_000]
SCORE_KEY = 1.0 + 2.0**-25 + 2.0**-52   # shares its (hi, lo) split key ...
SCORE_TWIN = 1.0 + 2.0**-25 + 2.0**-51  # ... with this one


def _rows(n=CHUNKS[-1]):
    rng = np.random.default_rng(55)
    names = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    name = names[rng.integers(0, 40, n)]
    name[::37] = None
    codes = np.array([f"c{i:02d}" for i in range(25)], dtype=object)
    code = codes[np.minimum(rng.zipf(1.6, n) - 1, 24)]
    age = rng.integers(0, 100, n).astype(object)
    age[::101] = None
    big = rng.integers(-(2**40), 2**40, n)
    score = rng.uniform(0, 1, n)
    score[::53] = np.nan
    score[1::211] = SCORE_KEY
    score[2::211] = SCORE_TWIN
    ratio = np.round(rng.uniform(-2, 2, n), 2)
    flag = rng.integers(0, 2, n).astype(bool)
    dtg = T0 + rng.integers(0, 300 * MS_DAY, n)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    # rows on a vertex and on an edge of the star below
    x[:3], y[:3] = [10.0, 5.0, 0.0], [0.0, 0.0, -10.0]
    return {"name": name, "code": code, "age": age, "big": big,
            "score": score, "ratio": ratio, "flag": flag, "dtg": dtg,
            "geom": (x, y)}


def _star(cx, cy, r1, r2, k):
    a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
    r = np.where(np.arange(2 * k) % 2 == 0, r1, r2)
    pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a)]
    pts = np.vstack([pts, pts[:1]])
    return "POLYGON((" + ", ".join(f"{float(x)!r} {float(y)!r}"
                                   for x, y in pts) + "))"


STAR = _star(0, 0, 40, 15, 9)
HOLED = ("POLYGON((-120 -60, 120 -60, 120 60, -120 60, -120 -60), "
         "(-30 -30, 30 -30, 30 30, -30 30, -30 -30))")
MULTI = ("MULTIPOLYGON(((-100 -50, -20 -50, -20 20, -100 20, -100 -50)), "
         "((20 0, 90 0, 90 70, 20 70, 20 0), (40 20, 60 20, 60 40, 40 40, "
         "40 20)))")
ELL = "POLYGON((0 0, 60 0, 60 20, 20 20, 20 60, 0 60, 0 0))"
SPRING = "2021-03-01T00:00:00Z/2021-06-01T00:00:00Z"
YEAR = "2021-01-01T00:00:00Z/2021-12-31T00:00:00Z"

QUERIES = [
    # z3, host evaluator or dense residual kernel on the secondary
    f"BBOX(geom, -80, 30, -60, 45) AND dtg DURING {SPRING}",
    f"INTERSECTS(geom, {STAR}) AND dtg DURING {YEAR}",
    f"WITHIN(geom, {MULTI}) AND dtg BETWEEN 2021-02-01T00:00:00Z AND "
    f"2021-08-01T00:00:00Z",
    f"INTERSECTS(geom, {HOLED}) AND dtg > 2021-04-01T00:00:00Z AND "
    f"dtg < 2021-09-01T00:00:00Z",
    f"BBOX(geom, -170, -80, 170, 80) AND dtg DURING {YEAR} AND age > 50",
    f"BBOX(geom, -170, -80, 170, 80) AND dtg DURING {YEAR} AND "
    f"(score = {SCORE_KEY!r} OR NOT (name IN ('w001', 'w002')))",
    f"BBOX(geom, -10, -10, 10, 10) AND dtg DURING {SPRING} AND "
    f"name LIKE 'w0%'",
    f"DISJOINT(geom, {STAR}) AND dtg DURING {SPRING}",
    # z2
    "BBOX(geom, 0, 0, 50, 40) AND score < 0.5",
    f"INTERSECTS(geom, {ELL}) AND NOT (flag = true)",
    f"(BBOX(geom, -60, -60, -40, -40) OR INTERSECTS(geom, {STAR})) AND "
    f"ratio >= 0.25",
    # id
    "IN ('f1', 'f2', 'f300', 'nope')",
    "IN ('f1', 'f5', 'f7', 'f19999') AND age > 10",
    # attribute index: equality, date-narrowed, range, IN, too wide, LIKE
    "code = 'c07'",
    f"code = 'c03' AND dtg DURING {SPRING}",
    "age BETWEEN 20 AND 30",
    "age IN (1, 2, 3) AND score > 0.5",
    "code >= 'c02'",
    "code LIKE 'c1%'",
    # fullscan: the whole filter as the secondary
    "score < 0.25 OR big > 1000",
    "name IS NULL",
    "NOT (name = 'w007') AND flag = false",
    f"big BETWEEN {-(2**36)} AND {2**37}",
    f"score = {SCORE_KEY!r}",
    f"score >= {SCORE_TWIN!r} AND score <= 1.5",
    "ratio = 0.5 OR ratio IN (-1.25, 1.75)",
    "dtg BEFORE 2021-01-20T00:00:00Z OR dtg AFTER 2021-10-20T00:00:00Z",
    "name ILIKE 'W01_' AND age <> 41",
    "score IS NULL AND flag = true",
    f"DISJOINT(geom, {HOLED})",
    "EXCLUDE",
    "INCLUDE",
]

# tier -> (geomesa.scan.host.rows, geomesa.scan.index.threshold)
TIERS = {"host": (None, None), "dense": ("0", "0")}


def _write(stores, lo, hi):
    data, port, ref = stores
    ids = [f"f{i}" for i in range(lo, hi)]
    part = {k: (tuple(a[lo:hi] for a in v) if isinstance(v, tuple)
                else v[lo:hi]) for k, v in data.items()}
    for s in (port, ref):
        s.write_dict("pts", ids, part)


@pytest.fixture(scope="module")
def stores():
    data = _rows()
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s in (port, ref):
        s.create_schema("pts", SPEC)
    out = (data, port, ref)
    _write(out, CHUNKS[0], CHUNKS[1])
    return out


@pytest.fixture
def tier(monkeypatch):
    def force(name):
        for var, v in zip(("GEOMESA_SCAN_HOST_ROWS",
                           "GEOMESA_SCAN_INDEX_THRESHOLD"), TIERS[name]):
            if v is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, v)
    return force


def _same(port, ref, q):
    got = port.query(q, "pts")
    want = ref.query(q, "pts")
    assert list(got.ids) == list(want.ids), q
    assert port.query_count(q, "pts") == ref.query_count(q, "pts") == got.n
    return got


@pytest.mark.parametrize("name", list(TIERS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(stores, tier, name, q):
    _, port, ref = stores
    tier(name)
    before = dict(kernels.launches)
    _same(port, ref, q)
    # on CPU tensors the wrappers run their plain versions
    assert kernels.launches == before


def test_every_strategy_and_secondary_runs(stores):
    _, port, _ = stores
    plans, text = set(), []
    for q in QUERIES:
        res = port.query(q, "pts")
        plans.add(res.plan.index)
        text.append(res.explain.text)
    text = "\n".join(text)
    assert {"z3", "z2", "id", "attr:code", "attr:age", "fullscan",
            "empty"} <= plans
    for line in ("Device residual scan (dense)", "Residual filter applied",
                 "Attribute index scan", "(date-narrowed)",
                 "Attribute bounds too wide; dense device scan",
                 "Exact geometry predicate applied"):
        assert line in text, line


def test_device_pip_through_the_store(stores):
    """Every INTERSECTS/WITHIN polygon residual goes through the
    point-in-polygon kernel's path (its plain version here), a handful of
    candidates as well as thousands."""
    _, port, ref = stores
    tiny = (f"INTERSECTS(geom, POLYGON((0 0, 20 0, 0 20, 0 0))) AND "
            f"dtg DURING {SPRING}")
    for q in QUERIES[1:4] + QUERIES[9:10] + [tiny]:
        got = _same(port, ref, q)
        assert "Device point-in-polygon residual" in got.explain.text, q


def test_appends_drop_the_column_caches(stores):
    """Writes between queries: the residual's device columns and the
    attribute indexes cover the new rows (they are dropped on flush)."""
    data, port, ref = stores
    st = port._types["pts"]
    for lo, hi in zip(CHUNKS[1:], CHUNKS[2:]):
        port.query("score < 0.25 OR big > 1000", "pts")
        port.query("code = 'c07'", "pts")
        assert st.devcols is not None and "code" in st.attr_idx
        _write(stores, lo, hi)
        for q in QUERIES:
            _same(port, ref, q)
        assert port.count("pts") == hi
        assert st.devcols is None or st.devcols.get("score")["slot"][0] \
            .shape[0] == hi
        assert st.attr_idx["code"].n == int((data["code"][:hi] != None)
                                            .sum())  # noqa: E711


@pytest.mark.parametrize("spec,value", [
    ("v:Integer:index=true", "5"),
    ("v:Long:index=true", "-3"),
    ("v:Double:index=true", "0.5"),
    ("v:Float", "0.5"),
    ("v:Boolean:index=true", "true"),
    ("v:Date:index=true", "2021-01-02T00:00:00Z"),
    ("v:String:index=true", "'b'"),
])
def test_each_type_indexed_or_not(spec, value):
    """Every attribute type, with and without an attribute index, on
    equality and range, against the reference's host f64 evaluator (the
    JAX store itself refuses an index on a Boolean, and its device
    residual overflows on an int64 threshold whose low word is >= 2^31,
    such as -3: ROADMAP.md section 3)."""
    rng = np.random.default_rng(8)
    n = 500
    raw = {"Integer": rng.integers(0, 10, n), "Long": rng.integers(-5, 5, n),
           "Double": np.round(rng.uniform(0, 1, n), 1),
           "Float": np.round(rng.uniform(0, 1, n), 1),
           "Boolean": rng.integers(0, 2, n).astype(bool),
           "Date": T0 + rng.integers(0, 3, n) * MS_DAY,
           "String": np.array(list("abcd"), dtype=object)[
               rng.integers(0, 4, n)]}
    kind = spec.split(":")[1]
    full = f"{spec},dtg:Date,*geom:Point:srid=4326"
    data = {"v": raw[kind], "dtg": T0 + rng.integers(0, 9 * MS_DAY, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    ids = [f"r{i}" for i in range(n)]
    port = InMemoryDataStore(device="cpu")
    port.create_schema("t", full)
    port.write_dict("t", ids, data)
    ref = JaxBatch.from_dict(jax_parse_spec("t", full), ids, data)
    for q in (f"v = {value}", f"v >= {value}", f"v <> {value}",
              f"v = {value} AND dtg DURING 2021-01-01T00:00:00Z/"
              f"2021-01-05T00:00:00Z", "v IS NULL", f"NOT (v < {value})"):
        want = ref.ids[jax_evaluate(jax_parse_ecql(q), ref)]
        assert list(port.query(q, "t").ids) == list(want), q
    if spec.endswith("index=true"):
        assert port.query(f"v = {value}", "t").plan.index == "attr:v"
