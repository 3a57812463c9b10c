"""The port's stats (sketches, serialization, the estimator and the
stats-based planner, the store's stats registry, ``stats_query`` and
``analyze``) against the JAX package on the CPU, on the same seeded
rows.

Tolerance: exact -- to_json_object, count-min tables, serialized bytes,
estimates, plan indexes and costs, ids -- except DescriptiveStats'
moments, within 1e-12 relative. Two departures are held to what the
port does instead: a string hashes by a stable 64-bit blake2b (its
count-min table equals the reference's algorithm fed those hashes), and
remove_schema drops the type's stats (held to a fresh JAX store)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from geomesa_tpu.curves import sfc as jsfc, zorder as jzorder
from geomesa_tpu.curves.normalize import NormalizedDimension as JDim
from geomesa_tpu.features import parse_spec as jparse_spec
from geomesa_tpu.features.batch import FeatureBatch as JFeatureBatch
from geomesa_tpu.filters import parse_ecql as jparse_ecql
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.stats import (deserialize_stat as jdeserialize,
                               parse_stat as jparse_stat,
                               serialize_stat as jserialize)
from geomesa_tpu.stats.sketches import Frequency as JFrequency
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.curves import sfc, zorder
from geomesa_tpu_torch.curves.normalize import NormalizedDimension
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.stats import (deserialize_stat, parse_stat,
                                     serialize_stat)
from geomesa_tpu_torch.stats.sketches import stable_hash

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
MS_DAY = 86_400_000

SPEC = ("name:String:index=true,val:Integer,score:Double,big:Long,"
        "dtg:Date,*geom:Point:srid=4326")


def _data(n: int, seed: int) -> tuple[list, dict]:
    """Seeded rows with a null in every column now and then."""
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.05):
        out = list(vals)
        for i in np.flatnonzero(rng.random(n) < p):
            out[i] = None
        return out
    return [f"f{seed}_{i}" for i in range(n)], {
        "name": nulls([f"n{i % 10}" for i in rng.integers(0, 40, n)]),
        "val": nulls(rng.integers(0, 100, n).tolist()),
        "score": nulls(rng.normal(0.5, 1.0, n).tolist()),
        "big": nulls((rng.integers(-2**40, 2**40, n)).tolist()),
        "dtg": rng.integers(MS("2019-01-01"), MS("2019-03-01"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
    }


def _batches(n: int, seed: int):
    """(port batch, JAX batch) of the same rows."""
    ids, data = _data(n, seed)
    return (FeatureBatch.from_dict(parse_spec("t", SPEC), ids, data),
            JFeatureBatch.from_dict(jparse_spec("t", SPEC), ids, data))


SPECS = [
    "Count()", "MinMax(val)", "MinMax(score)", "MinMax(big)", "MinMax(dtg)",
    "MinMax(geom)", "MinMax(name)", "Enumeration(name)", "Enumeration(val)",
    "TopK(name,3)", "TopK(val)", "Frequency(val)", "Frequency(score)",
    "Frequency(big,10)", "Frequency(name)", "Histogram(val,20,0,100)",
    "Histogram(score,7,-1.5,2.5)",
    "Histogram(dtg,30,'2019-01-01T00:00:00Z','2019-03-01T00:00:00Z')",
    "DescriptiveStats(score)", "DescriptiveStats(val)",
    "GroupBy(name,Count())", "GroupBy(val,MinMax(score))",
    "Z3Histogram(geom,dtg,week,1024)", "Z3Histogram(geom,dtg,day,256)",
    "Z3Frequency(geom,dtg,week,12)", "Z3Frequency(geom,dtg,month,10)",
    "Count();MinMax(val);Enumeration(name)",
]
# the sketches whose state holds string hashes (the departure)
STRING_HASHED = {"MinMax(name)", "Frequency(name)"}


def _json(stat) -> str:
    return json.dumps(stat.to_json_object(), default=str)


def _assert_same(got, want, spec: str):
    """to_json_object equal: exact, DescriptiveStats' moments within
    1e-12 relative."""
    if spec.startswith("DescriptiveStats"):
        g, w = got.to_json_object(), want.to_json_object()
        assert set(g) == set(w) and g["count"] == w["count"]
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), k
        return
    assert _json(got) == _json(want)


def _tables(stat) -> list:
    """Every count-min table inside a stat."""
    fr = getattr(stat, "_freq", stat)
    return [fr.table] if hasattr(fr, "table") else []


def _string_table(values, precision: int = 12) -> np.ndarray:
    """The reference's count-min algorithm fed the port's stable string
    hashes: what the port's table of a String column must hold."""
    f = JFrequency("x", precision)
    keys = [stable_hash(v) for v in values if v is not None]
    f.observe_values(np.array(keys, dtype=np.uint64).view(np.int64))
    return f.table


@pytest.mark.parametrize("spec", SPECS)
def test_observe_merge_json(spec):
    (pa, ja), (pb, jb) = _batches(1_500, 1), _batches(700, 2)
    port, ref = parse_stat(spec), jparse_stat(spec)
    port.observe(pa)
    ref.observe(ja)
    _assert_same(port, ref, spec)
    other, jother = parse_stat(spec), jparse_stat(spec)
    other.observe(pb)
    jother.observe(jb)
    summed = port + other               # a copy: port stays as it was
    _assert_same(port, ref, spec)
    port.merge(other)
    ref.merge(jother)
    _assert_same(port, ref, spec)
    _assert_same(summed, ref, spec)
    if spec == "Frequency(name)":
        names = _data(1_500, 1)[1]["name"] + _data(700, 2)[1]["name"]
        assert np.array_equal(port.table, _string_table(names))
        assert port.total == ref.total
        for v in set(names) - {None}:
            assert port.count(v) >= names.count(v)
    else:
        for t, jt in zip(_tables(port), _tables(ref)):
            assert np.array_equal(t, jt)


@pytest.mark.parametrize("spec", SPECS)
def test_serialized_stats_cross_packages(spec):
    """A payload of either package reads back in the other to the same
    to_json_object; where no string hash is inside, the two packages'
    payloads are byte for byte the same."""
    pa, ja = _batches(900, 3)
    port, ref = parse_stat(spec), jparse_stat(spec)
    port.observe(pa)
    ref.observe(ja)
    data, jdata = serialize_stat(port), jserialize(ref)
    _assert_same(jdeserialize(data), port, spec)
    _assert_same(deserialize_stat(jdata), ref, spec)
    back = deserialize_stat(data)
    assert type(back) is type(port)
    _assert_same(back, port, spec)
    if spec not in STRING_HASHED:
        assert data == jdata
    with pytest.raises(ValueError):
        deserialize_stat(b"\x00\x01\x02\x03\x04\x05\x06\x07rubbish")


def _frequency_in_child(pkg: str, path) -> list:
    """Counts of 'a' and 'b' from a serialized Frequency, read in a new
    process with another string-hash seed than this one."""
    code = (f"from {pkg}.stats import deserialize_stat\n"
            f"f = deserialize_stat(open({str(path)!r}, 'rb').read())\n"
            "print(f.count('a'), f.count('b'))")
    seed = int(os.environ.get("PYTHONHASHSEED", "0") or 0) + 1
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, "PYTHONHASHSEED": str(seed),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return [int(v) for v in out.stdout.split()]


def test_string_frequency_survives_a_second_process(tmp_path):
    """1,000 'a' and 10 'b': the port's sketch counts them in any
    process; the JAX package's reads 0 and 0 where Python's string hash
    has another seed (its process-local hash(), ROADMAP.md section 3)."""
    sft, jsft = parse_spec("s", "k:String"), jparse_spec("s", "k:String")
    vals = ["a"] * 1000 + ["b"] * 10
    ids = [str(i) for i in range(len(vals))]
    port, ref = parse_stat("Frequency(k)"), jparse_stat("Frequency(k)")
    port.observe(FeatureBatch.from_dict(sft, ids, {"k": vals}))
    ref.observe(JFeatureBatch.from_dict(jsft, ids, {"k": vals}))
    assert (port.count("a"), port.count("b")) == (1000, 10)
    assert (ref.count("a"), ref.count("b")) == (1000, 10)
    (tmp_path / "port.bin").write_bytes(serialize_stat(port))
    (tmp_path / "ref.bin").write_bytes(jserialize(ref))
    assert _frequency_in_child("geomesa_tpu_torch",
                               tmp_path / "port.bin") == [1000, 10]
    assert _frequency_in_child("geomesa_tpu", tmp_path / "ref.bin") == [0, 0]


def test_boolean_columns_are_observed():
    """The JAX package raises TypeError on a Boolean column; the port
    observes it as a number (False 0, True 1), held to numpy."""
    sft = parse_spec("b", "flag:Boolean,*geom:Point")
    rng = np.random.default_rng(3)
    flags = [bool(v) if rng.random() > 0.1 else None
             for v in rng.random(500) < 0.3]
    b = FeatureBatch.from_dict(sft, [str(i) for i in range(500)], {
        "flag": flags, "geom": (np.zeros(500), np.zeros(500))})
    valid = [v for v in flags if v is not None]
    s = parse_stat("Enumeration(flag);MinMax(flag);GroupBy(flag,Count());"
                   "Frequency(flag)")
    s.observe(b)
    enum, mm, grp, freq = s.stats
    assert enum.counts == {False: valid.count(False), True: valid.count(True)}
    assert (mm.min, mm.max) == (False, True)
    assert grp.to_json_object() == [{"False": {"count": valid.count(False)}},
                                    {"True": {"count": valid.count(True)}}]
    assert (freq.count(True), freq.count(False)) == (valid.count(True),
                                                     valid.count(False))


def test_curves_decode_like_the_reference():
    """z3_decode, denormalize and Z3SFC.invert (exact)."""
    rng = np.random.default_rng(8)
    z = rng.integers(0, 2**63 - 1, 5_000, dtype=np.int64).astype(np.uint64)
    for a, b in zip(zorder.z3_decode(z), jzorder.z3_decode(z)):
        assert np.array_equal(a, b)
    i = rng.integers(-5, 2**21 + 5, 5_000)
    for lo, hi, p in ((-180.0, 180.0, 21), (0.0, 604800.0, 21),
                      (-90.0, 90.0, 7)):
        assert np.array_equal(NormalizedDimension(lo, hi, p).denormalize(i),
                              JDim(lo, hi, p).denormalize(i))
    for period in ("day", "week", "month", "year"):
        for a, b in zip(sfc.z3sfc(period).invert(z),
                        jsfc.z3sfc(period).invert(z)):
            assert np.array_equal(a, b)


# -- the estimator and the planner ---------------------------------------------

GDELT_SPEC = ("EventCode:String:index=true,Actor1CountryCode:String,"
              "NumMentions:Integer:index=true,AvgTone:Double,"
              "IsRootEvent:Boolean,dtg:Date,*geom:Point:srid=4326")
EVENT_CODES = [f"{r:02d}{k}" for r in range(1, 9) for k in range(5)]   # 40
COUNTRIES = ["USA", "GBR", "CHN", "RUS", "UKR", "FRA", "DEU", "IND"]
G_ROWS = 20_000
G_T0 = MS("2016-07-18")


def _gdelt(seed: int = 12, n: int = G_ROWS):
    """GDELT-shaped rows: Zipf-skewed event codes over a 40-code
    vocabulary (small enough that every count-min estimate is exact),
    heavy-tailed mentions, 100 days, clustered points."""
    rng = np.random.default_rng(seed)
    ev = np.array(EVENT_CODES, dtype=object)[
        np.minimum(rng.zipf(1.5, n) - 1, len(EVENT_CODES) - 1)]
    ac = np.array(COUNTRIES, dtype=object)[rng.integers(0, 8, n)]
    ac[rng.random(n) < 0.15] = None
    mentions = np.minimum(np.floor(rng.pareto(1.1, n) * 3) + 1,
                          200).astype(np.int64)
    near = rng.random(n) < 0.5
    x = np.where(near, rng.normal(-75, 6, n), rng.uniform(-180, 180, n))
    y = np.where(near, rng.normal(40, 4, n), rng.uniform(-90, 90, n))
    return [f"g{i}" for i in range(n)], {
        "EventCode": ev, "Actor1CountryCode": ac, "NumMentions": mentions,
        "AvgTone": rng.uniform(-10, 10, n), "IsRootEvent": rng.random(n) < 0.4,
        "dtg": G_T0 + rng.integers(0, 100 * MS_DAY, n),
        "geom": (np.clip(x, -180, 180), np.clip(y, -90, 90))}


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def _battery(seed: int = 5, n: int = 60) -> list[str]:
    """Seeded filters over every strategy: boxes of 0.5-120 degrees,
    windows of 1-90 days, event-code and mention equalities (head,
    middle, tail and absent values), ranges, IN, LIKE, OR, fid IN."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        w = float(rng.choice([0.5, 2, 8, 30, 120]))
        cx = float(rng.choice([-75.0, rng.uniform(-170, 170)]))
        cy = float(rng.choice([40.0, rng.uniform(-80, 80)]))
        box = (f"BBOX(geom, {cx - w / 2:.3f}, {max(cy - w / 4, -90):.3f}, "
               f"{cx + w / 2:.3f}, {min(cy + w / 4, 90):.3f})")
        lo = G_T0 + int(rng.integers(0, 90)) * MS_DAY
        during = (f"dtg DURING {_iso(lo)}/"
                  f"{_iso(lo + int(rng.integers(1, 90)) * MS_DAY)}")
        code = str(rng.choice(EVENT_CODES[:3] + EVENT_CODES[18:21]
                              + EVENT_CODES[-2:] + ["999"]))
        eq = f"EventCode = '{code}'"
        meq = f"NumMentions = {int(rng.choice([1, 2, 4, 9, 50, 1000]))}"
        kind = k % 10
        out.append([
            f"{box} AND {during}", box, during, eq, f"{eq} AND {during}",
            f"{box} AND {eq}", f"{box} AND {during} AND {eq}",
            f"{meq} AND {box}",
            f"{eq} AND {meq} AND {during}",
            f"({box} OR BBOX(geom, 100, -40, 140, 0)) AND {during} "
            f"AND EventCode >= '05'",
        ][kind])
    return out + [
        "INCLUDE", "EXCLUDE", "IN ('g1', 'g7', 'g12')",
        "EventCode IN ('011', '020')", "EventCode LIKE '01%'",
        "NumMentions > 10", "NumMentions BETWEEN 3 AND 5 AND "
        "BBOX(geom, -80, 35, -70, 45)",
        "AvgTone < -5 AND Actor1CountryCode = 'USA'",
        "NOT (EventCode = '010')",
        f"dtg AFTER {_iso(G_T0 + 95 * MS_DAY)} AND EventCode = '010'",
    ]


def _gdelt_pair(rows=None):
    ids, data = _gdelt()
    if rows is not None:
        ids = [ids[i] for i in rows]
        data = {k: (tuple(c[rows] for c in v) if isinstance(v, tuple)
                    else v[rows]) for k, v in data.items()}
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("g", GDELT_SPEC))
        # two writes: the stats add up across them
        half = len(ids) // 2
        for lo, hi in ((0, half), (half, len(ids))):
            s.write_dict("g", ids[lo:hi], {
                k: (tuple(c[lo:hi] for c in v) if isinstance(v, tuple)
                    else v[lo:hi]) for k, v in data.items()})
    return port, ref, ids, data


def _assert_exact_sketches(port, ref, data):
    """Both packages' count-min tables give every queried value its
    true count (no collision in some row): the condition under which
    the two estimators must agree."""
    pe, je = port.stats.get("g"), ref.stats.get("g")
    counts = {}
    for v in data["EventCode"]:
        counts[v] = counts.get(v, 0) + 1
    for v in EVENT_CODES + ["999"]:
        want = counts.get(v, 0)
        assert pe.attr_freq["EventCode"].count(v) == want, v
        assert je.attr_freq["EventCode"].count(v) == want, v
    assert np.array_equal(pe.attr_freq["NumMentions"].table,
                          je.attr_freq["NumMentions"].table)


def _assert_same_plans(port, ref, battery):
    pe, je = port.stats.get("g"), ref.stats.get("g")
    for ecql in battery:
        assert (pe.estimate_count(parse_ecql(ecql))
                == je.estimate_count(jparse_ecql(ecql))), ecql
        got, want = port.query(ecql, "g"), ref.query(ecql, "g")
        assert got.plan.index == want.plan.index, ecql
        assert got.plan.cost == want.plan.cost, ecql
        assert list(got.ids) == list(want.ids), ecql


@pytest.fixture(scope="module")
def gdelt():
    return _gdelt_pair()


def test_estimates_and_plans_equal(gdelt):
    port, ref, _, data = gdelt
    battery = _battery()
    assert len(battery) >= 50
    _assert_exact_sketches(port, ref, data)
    pe, je = port.stats.get("g"), ref.stats.get("g")
    assert pe.count.count == je.count.count == G_ROWS
    assert _json(pe.z3) == _json(je.z3)
    assert np.array_equal(pe.z3.cell_mass, je.z3.cell_mass)
    _assert_same_plans(port, ref, battery)
    # the stats move plans: both strategies occur, as in the reference
    plans = {port.query(e, "g").plan.index for e in battery}
    assert {"z3", "z2", "attr:EventCode", "attr:NumMentions", "id",
            "fullscan"} <= plans


def test_skewed_equality_flips_attr_vs_z():
    """tests/test_stats.py's skew case: an equality on the dominant
    value plans z2, on a rare value attr:name, in both packages."""
    rng = np.random.default_rng(4)
    n = 60_000
    names = np.array(["common"] * n, dtype=object)
    names[:25] = "rare"
    xy = (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))
    ids = np.arange(n).astype(str).astype(object)
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("t", "name:String:index=true,"
                                   "*geom:Point:srid=4326"))
        s.write_dict("t", ids, {"name": names, "geom": xy})
    for ecql, index in (
            ("BBOX(geom, 10, 10, 11, 11) AND name = 'common'", "z2"),
            ("BBOX(geom, -180, -90, 90, 90) AND name = 'rare'", "attr:name")):
        got, want = port.query(ecql, "t"), ref.query(ecql, "t")
        assert got.plan.index == want.plan.index == index
        assert got.plan.cost == want.plan.cost
        assert list(got.ids) == list(want.ids)


def test_write_side_sample_strides_large_batches(monkeypatch):
    """Batches over the sample cap observe a strided sub-batch with the
    stride as weight, in both packages (the cap lowered to 1,000)."""
    from geomesa_tpu.stats.estimator import StatsEstimator as JEst
    from geomesa_tpu_torch.stats.estimator import StatsEstimator as PEst
    monkeypatch.setattr(JEst, "_Z3_SAMPLE", 1_000)
    monkeypatch.setattr(PEst, "_Z3_SAMPLE", 1_000)
    port, ref, _, data = _gdelt_pair()
    pe, je = port.stats.get("g"), ref.stats.get("g")
    assert pe.count.count == je.count.count == G_ROWS
    assert pe.attr_freq["EventCode"].total == je.attr_freq[
        "EventCode"].total
    assert _json(pe.z3) == _json(je.z3)
    assert np.array_equal(pe.attr_freq["NumMentions"].table,
                          je.attr_freq["NumMentions"].table)
    _assert_same_plans(port, ref, _battery(seed=6, n=20))


def test_analyze_after_delete():
    """A delete leaves the stats stale in both packages; analyze
    recomputes them from the kept rows."""
    port, ref, ids, data = _gdelt_pair()
    gone = [ids[i] for i in range(0, G_ROWS, 3)]
    for s in (port, ref):
        s.delete("g", gone)
    kept = G_ROWS - len(gone)
    assert port.stats.get("g").count.count == G_ROWS   # stale
    for s in (port, ref):
        est = s.analyze("g")
        assert est is s.stats.get("g") and est.count.count == kept
    keep = np.setdiff1d(np.arange(G_ROWS), np.arange(0, G_ROWS, 3))
    _assert_exact_sketches(port, ref, {"EventCode": data["EventCode"][keep]})
    _assert_same_plans(port, ref, _battery(seed=7, n=20))
    # a type without rows has no estimator after analyze
    for s in (port, ref):
        s.delete("g", [ids[i] for i in keep])
        assert s.analyze("g") is None and s.stats.get("g") is None
    assert port.query("EventCode = '010'", "g").n == 0


def test_remove_schema_drops_stats():
    """Create, write 1,000 rows, remove_schema, create again with
    another spec and write 10: the port's stats count only the new rows
    and equal a fresh JAX store's; the JAX store keeps the old ones
    (1,010 rows, the dropped attribute's sketch: ROADMAP.md section 3)."""
    old, new = "name:String:index=true,*geom:Point", \
        "kind:String:index=true,dtg:Date,*geom:Point"
    rng = np.random.default_rng(2)
    port, ref, fresh = InMemoryDataStore(device="cpu"), JaxStore(), \
        JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("t", old))
        s.write_dict("t", [str(i) for i in range(1000)], {
            "name": ["a"] * 1000, "geom": (rng.uniform(-9, 9, 1000),
                                           rng.uniform(-9, 9, 1000))})
        s.remove_schema("t")
    rows = {"kind": ["k1"] * 6 + ["k2"] * 4,
            "dtg": [MS("2020-01-01") + i * MS_DAY for i in range(10)],
            "geom": ([float(i) for i in range(10)], [0.0] * 10)}
    for s, parse in ((port, parse_spec), (ref, jparse_spec),
                     (fresh, jparse_spec)):
        s.create_schema(parse("t", new))
        s.write_dict("t", [f"n{i}" for i in range(10)], rows)
    pe, fe, re_ = port.stats.get("t"), fresh.stats.get("t"), \
        ref.stats.get("t")
    assert pe.count.count == fe.count.count == 10
    assert re_.count.count == 1010 and "name" in re_.attr_freq
    assert set(pe.attr_freq) == set(fe.attr_freq) == {"kind"}
    for ecql in ("kind = 'k1' AND BBOX(geom, 0, -1, 3, 1)",
                 "kind = 'k2' AND dtg DURING 2020-01-02T00:00:00Z/"
                 "2020-01-05T00:00:00Z", "BBOX(geom, 0, -1, 3, 1)"):
        assert (pe.estimate_count(parse_ecql(ecql))
                == fe.estimate_count(jparse_ecql(ecql)))
        got, want = port.query(ecql, "t"), fresh.query(ecql, "t")
        assert (got.plan.index, got.plan.cost) == (want.plan.index,
                                                   want.plan.cost)
        assert list(got.ids) == list(want.ids)


# -- stats_query ----------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "Count()", "MinMax(dtg)", "Histogram(NumMentions,100,0,1000)",
    "Enumeration(EventCode)", "TopK(EventCode,10)",
    "DescriptiveStats(AvgTone)", "Z3Histogram(geom,dtg,week,1024)",
    "GroupBy(Actor1CountryCode,Count())", "MinMax(EventCode)",
    "Frequency(NumMentions)"])
@pytest.mark.parametrize("ecql", [
    None, "INCLUDE", "BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
    "2016-08-07T00:00:00Z/2016-09-06T00:00:00Z", "EventCode = '010'",
    "BBOX(geom, 170, 80, 171, 81)"])
def test_stats_query(gdelt, spec, ecql):
    port, ref, _, _ = gdelt
    got = port.stats_query("g", spec, ecql)
    _assert_same(got, ref.stats_query("g", spec, ecql), spec)
    # a new stat each call: mutating one leaves the next untouched
    got.observe(port.query("INCLUDE", "g").batch)
    _assert_same(port.stats_query("g", spec, ecql),
                 ref.stats_query("g", spec, ecql), spec)


@pytest.mark.parametrize("level", ["feature", "attribute"])
def test_stats_query_with_visibilities(level):
    """On a labelled store a filtered stats_query sees what query()
    sees under no auths (labelled rows hidden); INCLUDE observes the
    stored rows, as in the reference. Both equal the JAX store's."""
    spec = ("name:String,val:Integer,dtg:Date,*geom:Point:srid=4326"
            + (";geomesa.visibility.level='attribute'"
               if level == "attribute" else ""))
    rng = np.random.default_rng(9)
    n = 2_000
    labels = np.array(["", "admin", "user", "admin&user"],
                      dtype=object)[rng.integers(0, 4, n)]
    if level == "attribute":
        labels = np.array([",".join([v] * 4) for v in labels], dtype=object)
    rows = {"name": [f"n{i % 7}" for i in range(n)],
            "val": rng.integers(0, 100, n),
            "dtg": MS("2020-01-01") + rng.integers(0, 30 * MS_DAY, n),
            "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))}
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("v", spec))
        s.write_dict("v", [f"v{i}" for i in range(n)], rows,
                     visibilities=labels)
    for stat in ("Count()", "Enumeration(name)", "MinMax(val)"):
        for ecql in (None, "BBOX(geom, -20, -20, 20, 20)", "val < 50"):
            got = port.stats_query("v", stat, ecql)
            _assert_same(got, ref.stats_query("v", stat, ecql), stat)
    hidden = port.stats_query("v", "Count()", "BBOX(geom, -50, -50, 50, 50)")
    assert hidden.count == int(np.sum(labels == ("" if level == "feature"
                                                  else ",,,")))
    assert port.stats_query("v", "Count()").count == n
    with pytest.raises(KeyError):
        port.stats_query("nope", "Count()")


def test_stats_query_empty_and_bad_spec():
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s, parse in ((port, parse_spec), (ref, jparse_spec)):
        s.create_schema(parse("e", "v:Integer,*geom:Point"))
    assert _json(port.stats_query("e", "Count();MinMax(v)")) == _json(
        ref.stats_query("e", "Count();MinMax(v)"))
    with pytest.raises(ValueError):
        port.stats_query("e", "Nope(v)")


def test_ignored_hints_and_refused_ones(gdelt):
    """query() accepts the hints the reference's query() ignores, and
    TIMEOUT (a deadline it reads); unknown keys are refused."""
    from geomesa_tpu_torch.index.api import QueryHints
    port, ref, _, _ = gdelt
    ecql = "BBOX(geom, -80, 30, -60, 45)"
    hints = {QueryHints.STATS_STRING: "Count()", QueryHints.ENCODE_STATS:
             True, QueryHints.ARROW_ENCODE: True,
             QueryHints.ARROW_DICTIONARY_FIELDS: "EventCode",
             QueryHints.DENSITY_BBOX: (0, 0, 1, 1), QueryHints.DENSITY_WIDTH:
             8, QueryHints.DENSITY_HEIGHT: 8, QueryHints.DENSITY_WEIGHT:
             "NumMentions", QueryHints.BIN_TRACK: "EventCode",
             QueryHints.BIN_GEOM: "geom", QueryHints.BIN_DTG: "dtg",
             QueryHints.BIN_LABEL: "EventCode", QueryHints.BIN_SORT: True,
             QueryHints.BIN_BATCH_SIZE: 10, QueryHints.EXACT_COUNT: True,
             QueryHints.LOOSE_BBOX: True, QueryHints.COST_EVALUATION:
             "stats"}
    got = port.query(Query("g", ecql, hints=hints))
    want = ref.query(JQuery("g", ecql, hints=dict(hints)))
    assert list(got.ids) == list(want.ids)
    assert port.query_count(Query("g", ecql, hints=hints)) == got.n
    timed = port.query(Query("g", ecql, hints={"TIMEOUT": 60}))
    assert list(timed.ids) == list(want.ids)
    for bad in ({"NOT_A_HINT": 5}, {"LAMBDA_QUERY_TRANSIENT": True}):
        with pytest.raises(NotImplementedError, match="not known"):
            port.query(Query("g", ecql, hints=bad))


def test_stats_without_pyarrow(tmp_path):
    """import geomesa_tpu_torch, a write, stats_query, analyze and
    query_stream need no pyarrow (blocked in a subprocess); only the
    Arrow entry points ask for it."""
    code = "\n".join([
        "import sys", "sys.modules['pyarrow'] = None",
        "import numpy as np",
        "import geomesa_tpu_torch",
        "from geomesa_tpu_torch import InMemoryDataStore",
        "import geomesa_tpu_torch.stats, geomesa_tpu_torch.arrow",
        "ds = InMemoryDataStore(device='cpu')",
        "ds.create_schema('t', 'name:String:index=true,dtg:Date,*geom:Point')",
        "ds.write_dict('t', ['a', 'b', 'c'], {'name': ['x', 'y', 'x'],"
        " 'dtg': [0, 1, 2], 'geom': ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])})",
        "print(ds.stats_query('t', 'Enumeration(name)', 'BBOX(geom, 0, 0, "
        "2.5, 2.5)').to_json())",
        "print(ds.analyze('t').count.count)",
        "print([b.n for b in ds.query_stream('INCLUDE', 't', batch_rows=2)])",
        "try:\n    ds.arrow_ipc('t')\nexcept ImportError:\n    print('no arrow')",
        "print('pyarrow' in sys.modules and sys.modules['pyarrow'] is None)",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:5] == [
        '{"x": 1, "y": 1}', "3", "[2, 1]", "no arrow", "True"]
