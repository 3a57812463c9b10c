"""The port's SQL surface (sql/) against the JAX package's, on a port store
on the CPU beside a JAX store holding the same seeded rows (the classes
of test_sql.py, less its REST case).

Tolerance: exact. Column names, row counts, ids, group keys, counts,
integer sums, MIN/MAX, WKT and float SUM/AVG are equal value for value,
rows in the same order: the port runs the same numpy reduces over rows
in the same order. Plans and ``join_order`` notes are equal dicts. A
statement the JAX engine refuses is refused with the same error type and
text. Looser comparisons carry their reason beside them: the partitioned
route against the direct one (the same pairs, met cell by cell), the
merge of leg partials against one store's answer (groups in key order,
float sums within 1e-12 relative)."""

import collections

import numpy as np
import pytest

from geomesa_tpu.geometry import Geometry as JGeometry
from geomesa_tpu.geometry import to_wkt as jto_wkt
from geomesa_tpu.sql import SqlEngine as JEngine
from geomesa_tpu.sql import SqlError as JSqlError
from geomesa_tpu.sql import distributed as jdist
from geomesa_tpu.sql import engine as jeng_mod
from geomesa_tpu.sql import parse_sql as jparse
from geomesa_tpu.sql.planner import SQL_PLANNER as JSQL_PLANNER
from geomesa_tpu.store import FileSystemDataStore as JFsStore
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import FileSystemDataStore, InMemoryDataStore
from geomesa_tpu_torch.analytics.st_functions import SQL_SCALARS
from geomesa_tpu_torch.geometry import Geometry, to_wkt
from geomesa_tpu_torch.sql import SqlEngine, SqlError, SqlResult, parse_sql
from geomesa_tpu_torch.sql import distributed as tdist
from geomesa_tpu_torch.sql import engine as teng_mod
from geomesa_tpu_torch.utils.properties import SQL_PLANNER

MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731

N = 2_500


def _zone_wkts(rng, k=12):
    out = []
    for _ in range(k):
        cx, cy = rng.uniform(-150, 150), rng.uniform(-70, 70)
        w, h = rng.uniform(8, 30), rng.uniform(8, 30)
        out.append(f"POLYGON (({cx-w} {cy-h}, {cx+w} {cy-h}, "
                   f"{cx+w} {cy+h}, {cx-w} {cy+h}, {cx-w} {cy-h}))")
    return out


def _fill(ds):
    """test_sql.py's store at N rows, with nulls in val and name, a
    beacon layer and a small 'pts' layer of 40 rows."""
    rng = np.random.default_rng(31)
    ds.create_schema("gdelt", "name:String:index=true,val:Integer,"
                     "score:Double,dtg:Date,*geom:Point:srid=4326")
    names = [f"actor{i % 50}" for i in range(N)]
    for i in range(0, N, 97):
        names[i] = None
    val = rng.integers(0, 1000, N).astype(object)
    val[::113] = None
    ds.write_dict("gdelt", [f"f{i}" for i in range(N)], {
        "name": names, "val": list(val),
        "score": rng.normal(0.0, 3.0, N),
        "dtg": rng.integers(MS("2018-01-01"), MS("2018-06-01"), N),
        "geom": (rng.uniform(-180, 180, N), rng.uniform(-90, 90, N)),
    })
    ds.create_schema("zones", "zid:Integer,*area:Polygon")
    ds.write_dict("zones", [f"z{i}" for i in range(12)],
                  {"zid": list(range(12)), "area": _zone_wkts(rng)})
    ds.create_schema("beacons", "bid:Integer,*loc:Point")
    ds.write_dict("beacons", [f"b{i}" for i in range(40)], {
        "bid": np.arange(40),
        "loc": (rng.uniform(-150, 150, 40), rng.uniform(-70, 70, 40))})
    ds.create_schema("pts", "name:String,*geom:Point:srid=4326")
    ds.write_dict("pts", [f"p{i}" for i in range(40)], {
        "name": [f"g{i % 4}" for i in range(40)],
        "geom": (rng.uniform(-170, 170, 40), rng.uniform(-80, 80, 40))})
    ds.create_schema("cells", "name:String,*geom:Point:srid=4326")
    ds.write_dict("cells", ["c0", "c1", "c2"], {
        "name": ["u60g0", "9q8yyk", None],
        "geom": ([12.34, -122.4, 0.0], [56.78, 37.7, 0.0])})
    ds.create_schema("rings", "*r:LineString:srid=4326")
    ds.write_dict("rings", ["r0", "r1"], {
        "r": ["LINESTRING (0 0, 3 0, 3 3, 0 0)",
              "LINESTRING (-5 -5, -1 -5, -1 -2, -5 -2, -5 -5)"]})
    ds.create_schema("shapes", "*g:Geometry:srid=4326")
    ds.write_dict("shapes", ["s0", "s1", "s2", "s3"], {
        "g": ["LINESTRING (0 0, 1 2, 3 4)",
              "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))", "POINT (7 8)",
              "POLYGON ((170 -10, 190 -10, 190 10, 170 10, 170 -10))"]})
    return ds


@pytest.fixture(scope="module")
def engines():
    return (SqlEngine(_fill(InMemoryDataStore(device="cpu"))),
            JEngine(_fill(JaxStore())))


def _norm(v):
    """One cell as a comparable Python value: geometries as WKT, numpy
    scalars as Python numbers."""
    if isinstance(v, Geometry):
        return ("geom", to_wkt(v))
    if isinstance(v, JGeometry):
        return ("geom", jto_wkt(v))
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v.is_integer():
        return v                     # 3.0 == 3 across the two packages
    return v


def _rows(res):
    return [tuple(_norm(c) for c in r) for r in res.rows()]


def _same(got, want, ordered=True):
    assert got.names == want.names
    assert got.n == want.n
    g, w = _rows(got), _rows(want)
    if ordered:
        assert g == w
    else:
        assert collections.Counter(map(repr, g)) == \
            collections.Counter(map(repr, w))


def _both(engines, sql, ordered=True):
    port, ref = engines
    want = ref.query(sql)
    got = port.query(sql)
    _same(got, want, ordered)
    assert got.plan == want.plan
    return got, want


# -- parser -----------------------------------------------------------------

PUSHDOWN = [
    "SELECT * FROM gdelt WHERE ST_Contains(ST_MakeBBOX(-30, -20, 40, 35), "
    "geom)",
    "SELECT * FROM gdelt WHERE ST_Intersects(geom, "
    "ST_GeomFromText('POLYGON ((0 0, 40 0, 20 35, 0 0))'))",
    "SELECT * FROM gdelt WHERE ST_Within(geom, "
    "ST_GeomFromText('POLYGON ((0 0, 40 0, 20 35, 0 0))'))",
    "SELECT * FROM gdelt WHERE name = 'actor7' AND val > 500",
    "SELECT * FROM gdelt WHERE ST_Contains(ST_MakeBBOX(-30,-20,40,35), "
    "geom) AND dtg > '2018-03-01T00:00:00Z'",
    "SELECT * FROM gdelt WHERE name IN ('actor1','actor2') "
    "AND val BETWEEN 10 AND 200",
    "SELECT * FROM gdelt WHERE ST_DWithin(geom, ST_Point(10, 10), 25.5)",
    "SELECT * FROM gdelt WHERE ST_DWithin(ST_Point(10.1, -3.3), geom, "
    "1e1)",
    "SELECT * FROM gdelt WHERE NOT (val < 100 OR name LIKE 'actor1%')",
    "SELECT * FROM gdelt WHERE name ILIKE 'ACTOR2%' AND val IS NOT NULL",
    "SELECT * FROM gdelt WHERE val NOT BETWEEN 5 AND 900 OR name IS NULL",
    "SELECT * FROM gdelt WHERE score >= -0.1 AND score != 2.5",
    "SELECT * FROM gdelt WHERE ST_Overlaps(geom, ST_MakeBBOX(0, 0, 9, 9))"
    " OR ST_Touches(geom, ST_Point(1, 1))",
    "SELECT * FROM gdelt WHERE ST_Equals(geom, ST_MakePoint(3, 4)) OR "
    "ST_Disjoint(geom, ST_MakeBox2D(-170, -80, 170, 80))",
    "SELECT * FROM gdelt WHERE ST_Crosses(geom, ST_GeomFromWKT("
    "'LINESTRING (0 0, 10 10)')) OR ST_Covers(ST_MakeBBOX(0, 0, 5, 5), "
    "geom)",
    "SELECT * FROM gdelt g WHERE g.val < 3 AND g.name NOT IN ('actor1')",
]


@pytest.mark.parametrize("sql", PUSHDOWN)
def test_where_parses_to_the_same_filter(sql):
    assert str(parse_sql(sql).where) == str(jparse(sql).where)


@pytest.mark.parametrize("sql", PUSHDOWN)
def test_pushdown_gives_the_same_rows(engines, sql):
    _both(engines, sql)


def test_parsed_statement_fields_equal():
    sql = ("SELECT a.name AS n, COUNT(*) AS c, ST_Extent(a.geom) AS e, "
           "ST_Buffer(a.geom, 0.5) AS b, ST_MakeBBOX(0, 0, 1, 1) AS box "
           "FROM gdelt a LEFT OUTER JOIN zones z ON ST_Contains(z.area, "
           "a.geom) INNER JOIN beacons b ON ST_DWithin(a.geom, b.loc, 2.5) "
           "JOIN gdelt c ON a.name = c.name WHERE a.val < 4 "
           "GROUP BY a.name, z.zid HAVING COUNT(*) >= 2 AND a.name <> 'x' "
           "ORDER BY c DESC LIMIT 7")
    got, want = parse_sql(sql), jparse(sql)
    for f in ("table", "alias", "order_by", "order_desc", "limit",
              "group_by"):
        assert getattr(got, f) == getattr(want, f)
    assert [(i.expr, i.agg, i.alias, i.fn, i.name) for i in got.items] == \
        [(i.expr, i.agg, i.alias, i.fn, i.name) for i in want.items]
    assert [tuple(vars(j).values()) for j in got.joins] == \
        [tuple(vars(j).values()) for j in want.joins]
    assert [(h.item.name, h.op, h.value) for h in got.having] == \
        [(h.item.name, h.op, h.value) for h in want.having]
    assert str(got.where) == str(want.where)


def test_numeric_literals_stay_f64():
    sql = ("SELECT COUNT(*) FROM a JOIN b ON ST_DWithin(a.geom, b.geom, "
           "0.1000000000000001) WHERE a.x > 16777217 AND b.y < 0.3")
    got, want = parse_sql(sql), jparse(sql)
    assert got.joins[0].distance == want.joins[0].distance == \
        0.1000000000000001
    assert str(got.where) == str(want.where)
    assert "16777217" in str(got.where)


BAD = [
    "SELECT FROM gdelt",
    "SELECT * FROM gdelt WHERE",
    "SELECT * FROM gdelt WHERE ST_Contains(geom, geom2)",
    "UPDATE gdelt SET val = 1",
    "SELECT * FROM t WHERE a = 1 GARBAGE MORE",
    "SELECT COUNT(*) FROM t a JOIN t b ON ST_DWithin(geom, geom, 0.1)",
    "SELECT * FROM t a JOIN t b ON a.x < b.x",
    "SELECT * FROM t a JOIN t b ON ST_Touches(a.g, b.g)",
    "SELECT * FROM t WHERE x NOT = 3",
    "SELECT * FROM t WHERE ST_DWithin(a, b, 1)",
    "SELECT * FROM t WHERE x = @",
    "SELECT ST_Buffer(g, other) FROM t",
    "SELECT * FROM t GROUP BY a HAVING COUNT(*) 3",
    "SELECT * FROM t LIMIT x",
]


@pytest.mark.parametrize("sql", BAD)
def test_parser_errors_match(sql):
    with pytest.raises(JSqlError) as jexc:
        jparse(sql)
    with pytest.raises(SqlError) as exc:
        parse_sql(sql)
    assert str(exc.value) == str(jexc.value)


ENGINE_ERRORS = [
    "SELECT val, COUNT(*) FROM gdelt GROUP BY name",
    "SELECT COUNT(*) FROM gdelt HAVING COUNT(*) > 1",
    "SELECT name, COUNT(*) FROM gdelt",
    "SELECT z.zid, c.name FROM zones z JOIN gdelt g "
    "ON ST_Contains(z.area, g.geom)",
    "SELECT g.name FROM gdelt g JOIN gdelt g ON g.name = g.name",
    "SELECT name FROM gdelt g JOIN zones z ON ST_Contains(z.area, g.geom)",
    "SELECT g.name FROM gdelt g JOIN zones z ON ST_Contains(z.area, "
    "g.geom) WHERE val < 3",
    "SELECT g.name FROM gdelt g JOIN zones z ON ST_Contains(g.geom, "
    "z.area)",
    "SELECT SUM(g.__fid__) FROM gdelt g JOIN zones z ON "
    "ST_Contains(z.area, g.geom)",
    "SELECT name, COUNT(*) AS n FROM gdelt GROUP BY name ORDER BY nope",
    "SELECT g.name FROM gdelt g JOIN zones z ON g.val = z.area",
    "SELECT name, ST_X(geom) AS x FROM gdelt GROUP BY name",
    "SELECT __fid__ FROM shapes WHERE __fid__ IN ('s0', 's1')",
    "SELECT ST_GeomFromGeoHash(name, 10) AS cell FROM gdelt "
    "WHERE name = 'actor1'",
]


@pytest.mark.parametrize("sql", ENGINE_ERRORS)
def test_engine_errors_match(engines, sql):
    port, ref = engines
    with pytest.raises(Exception) as jexc:
        ref.query(sql)
    with pytest.raises(Exception) as exc:
        port.query(sql)
    assert type(exc.value).__name__ == type(jexc.value).__name__
    assert str(exc.value) == str(jexc.value)


# -- single table -------------------------------------------------------------

SINGLE = [
    "SELECT COUNT(*) FROM gdelt WHERE val < 100",
    "SELECT COUNT(val), COUNT(name), COUNT(*) FROM gdelt",
    "SELECT MIN(val) AS lo, MAX(val) AS hi, AVG(val) AS mean, SUM(val) AS s"
    " FROM gdelt WHERE name = 'actor3'",
    "SELECT SUM(score) AS s, AVG(score) AS a, MIN(dtg) AS t0, "
    "MAX(dtg) AS t1 FROM gdelt WHERE val > 700",
    "SELECT MIN(val) FROM gdelt WHERE val > 5000",
    "SELECT name, val AS v FROM gdelt WHERE val = 7 LIMIT 5",
    "SELECT val FROM gdelt WHERE name = 'actor9' ORDER BY val DESC LIMIT 3",
    "SELECT __fid__, name, dtg, geom FROM gdelt WHERE val < 40 "
    "ORDER BY dtg",
    "SELECT g.name, g.score FROM gdelt g WHERE g.val < 60 "
    "ORDER BY g.score LIMIT 9",
    "SELECT * FROM zones WHERE zid < 5",
    "SELECT ST_Extent(geom) AS e FROM pts",
    "SELECT ST_ConvexHull(geom) AS h, COUNT(*) AS n FROM pts",
    "SELECT ST_Extent(area) AS e FROM zones WHERE zid > 3",
]


@pytest.mark.parametrize("sql", SINGLE)
def test_single_table(engines, sql):
    _both(engines, sql)


GROUPED = [
    "SELECT name, COUNT(*) AS n FROM gdelt GROUP BY name",
    "SELECT name, SUM(val) AS s, AVG(val) AS a, MIN(val) AS lo, "
    "MAX(val) AS hi, COUNT(val) AS c FROM gdelt GROUP BY name",
    "SELECT name, COUNT(*) AS n FROM gdelt "
    "WHERE ST_Contains(ST_MakeBBOX(-30, -20, 40, 35), geom) "
    "GROUP BY name ORDER BY n DESC LIMIT 5",
    "SELECT name, val, COUNT(*) AS n FROM gdelt WHERE val < 30 "
    "GROUP BY name, val",
    "SELECT val, AVG(score) AS a, SUM(score) AS s FROM gdelt "
    "GROUP BY val ORDER BY val LIMIT 20",
    "SELECT COUNT(*) AS n FROM gdelt GROUP BY name HAVING name = 'actor7'",
    "SELECT name, COUNT(*) AS n, ST_ConvexHull(geom) AS h FROM gdelt "
    "GROUP BY name HAVING COUNT(*) >= 48",
    "SELECT g.name, COUNT(*) AS n FROM gdelt g GROUP BY g.name "
    "ORDER BY g.name LIMIT 4",
    "SELECT name, ST_Extent(geom) AS e FROM pts GROUP BY name",
    "SELECT name, ST_Extent(geom) AS e, COUNT(*) AS n FROM pts "
    "GROUP BY name HAVING COUNT(*) > 9",
    "SELECT name, MAX(val) AS m FROM gdelt GROUP BY name "
    "HAVING AVG(val) > 490 AND MIN(val) < 40 ORDER BY m",
    "SELECT dtg, COUNT(*) AS n FROM gdelt WHERE val < 20 GROUP BY dtg",
    "SELECT name, COUNT(*) AS n FROM gdelt WHERE val > 2000 GROUP BY name",
]


@pytest.mark.parametrize("sql", GROUPED)
def test_group_by(engines, sql):
    _both(engines, sql)


# -- joins --------------------------------------------------------------------

JOINS = [
    "SELECT z.zid, g.__fid__ FROM zones z JOIN gdelt g "
    "ON ST_Contains(z.area, g.geom) WHERE g.val < 500",
    "SELECT COUNT(*) FROM gdelt a JOIN gdelt b "
    "ON ST_DWithin(a.geom, b.geom, 2.5) WHERE a.val < 50 AND b.val >= 5",
    "SELECT COUNT(b.__fid__) AS c FROM gdelt a JOIN gdelt b "
    "ON ST_DWithin(a.geom, b.geom, 2.5)",
    "SELECT COUNT(*) FROM gdelt a JOIN gdelt b "
    "ON ST_DWithin(a.geom, b.geom, 2.5)",
    "SELECT COUNT(*) AS n FROM zones z JOIN gdelt g "
    "ON ST_Contains(z.area, g.geom)",
    "SELECT COUNT(*) AS n FROM gdelt g JOIN zones z "
    "ON ST_Contains(z.area, g.geom) WHERE g.val < 300",
    "SELECT g.__fid__ AS fid, z.zid AS zid FROM gdelt g "
    "LEFT JOIN zones z ON ST_Contains(z.area, g.geom) ORDER BY fid",
    "SELECT g.__fid__ AS fid FROM gdelt g LEFT JOIN zones z "
    "ON ST_Contains(z.area, g.geom) WHERE z.zid IS NULL",
    "SELECT g.__fid__ AS fid, z.zid AS zid FROM gdelt g "
    "LEFT JOIN zones z ON ST_Contains(z.area, g.geom) WHERE z.zid < 4",
    "SELECT g.__fid__ AS fid, z.zid AS zid, b.bid AS bid FROM gdelt g "
    "JOIN zones z ON ST_Contains(z.area, g.geom) "
    "JOIN beacons b ON ST_DWithin(z.area, b.loc, 10.0) WHERE g.val < 500",
    "SELECT g.__fid__ AS fid, z.zid AS zid FROM gdelt g "
    "JOIN zones z ON ST_Contains(z.area, g.geom) "
    "WHERE g.val < 100 AND z.zid >= 6",
    "SELECT COUNT(*) AS n FROM gdelt g "
    "LEFT JOIN zones z ON ST_Contains(z.area, g.geom)",
    "SELECT COUNT(z.zid) AS n FROM gdelt g "
    "LEFT JOIN zones z ON ST_Contains(z.area, g.geom)",
    "SELECT z.zid, COUNT(*) AS n, AVG(g.val) AS av, MIN(g.val) AS mn, "
    "MAX(g.val) AS mx, SUM(g.val) AS sm, SUM(g.score) AS ss "
    "FROM gdelt g JOIN zones z ON ST_Contains(z.area, g.geom) "
    "GROUP BY z.zid ORDER BY z.zid",
    "SELECT z.zid, COUNT(*) AS n FROM gdelt g "
    "JOIN zones z ON ST_Contains(z.area, g.geom) "
    "GROUP BY z.zid HAVING COUNT(*) > 20",
    "SELECT z.zid, COUNT(*) AS n, ST_ConvexHull(g.geom) AS h, "
    "ST_Extent(g.geom) AS e FROM gdelt g JOIN zones z "
    "ON ST_Contains(z.area, g.geom) GROUP BY z.zid HAVING COUNT(*) > 5",
    "SELECT a.name, COUNT(*) AS n FROM gdelt a JOIN gdelt b "
    "ON a.name = b.name WHERE a.val < 60 AND b.val < 60 "
    "GROUP BY a.name ORDER BY a.name",
    "SELECT a.__fid__, b.__fid__ FROM gdelt a JOIN gdelt b "
    "ON a.val = b.val WHERE a.val < 10",
    "SELECT z.zid, g.name, COUNT(*) AS n FROM gdelt g "
    "LEFT JOIN zones z ON ST_Contains(z.area, g.geom) "
    "GROUP BY z.zid, g.name ORDER BY n DESC LIMIT 6",
    "SELECT b.__fid__, COUNT(*) AS n FROM gdelt a JOIN beacons b "
    "ON ST_DWithin(a.geom, b.loc, 6.0) GROUP BY b.__fid__",
    "SELECT a.name, ST_X(a.geom) AS x FROM pts a JOIN zones b "
    "ON ST_Contains(b.area, a.geom)",
    "SELECT * FROM beacons b JOIN zones z ON ST_Intersects(z.area, b.loc)",
    "SELECT g.name, z.zid FROM gdelt g JOIN zones z "
    "ON ST_Contains(z.area, g.geom) WHERE g.val < 200 "
    "ORDER BY g.name LIMIT 10",
    "SELECT MIN(g.val) AS lo, ST_Extent(g.geom) AS e FROM gdelt g "
    "JOIN zones z ON ST_Contains(z.area, g.geom) WHERE z.zid < 3",
]


@pytest.mark.parametrize("sql", JOINS)
def test_joins(engines, sql):
    _both(engines, sql)


def test_count_shortcut_agrees_with_pairs(engines):
    port, _ = engines
    fast = port.query("SELECT COUNT(*) FROM gdelt a JOIN gdelt b "
                      "ON ST_DWithin(a.geom, b.geom, 2.5)")
    slow = port.query("SELECT COUNT(b.__fid__) AS c FROM gdelt a "
                      "JOIN gdelt b ON ST_DWithin(a.geom, b.geom, 2.5)")
    assert int(fast.column("count(*)")[0]) == int(slow.column("c")[0]) > 0


def test_join_count_reaches_kernel_with_resident_columns(engines,
                                                         monkeypatch):
    """A COUNT(*) DWithin join over a whole point table hands the join
    the store's resident scan columns, not a fresh upload."""
    import geomesa_tpu_torch.analytics.join as tjoin
    port, _ = engines
    seen = []
    real = tjoin.dwithin_join

    def spy(*a, **kw):
        seen.append(kw.get("device_xy"))
        return real(*a, **kw)
    monkeypatch.setattr(tjoin, "dwithin_join", spy)
    port.query("SELECT COUNT(*) FROM gdelt a JOIN beacons b "
               "ON ST_DWithin(a.geom, b.loc, 3.0)")
    sd = port.store._state("gdelt").scan_data
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0][0] is sd.xhi and seen[0][1] is sd.yhi
    # a filtered side is a subset: no resident columns
    port.query("SELECT COUNT(*) FROM gdelt a JOIN beacons b "
               "ON ST_DWithin(a.geom, b.loc, 3.0) WHERE a.val < 10")
    assert seen[1] is None


def test_count_statement_gathers_no_ids(engines, monkeypatch):
    """COUNT(*) and aggregate statements never read the result ids."""
    from geomesa_tpu_torch.store import memory
    port, _ = engines
    reads = []
    real = memory.QueryResult.ids

    def ids(self):
        reads.append(1)
        return real.fget(self)
    monkeypatch.setattr(memory.QueryResult, "ids", property(ids))
    for sql in ("SELECT COUNT(*) FROM gdelt WHERE val < 100",
                "SELECT name, SUM(val) AS s FROM gdelt GROUP BY name",
                "SELECT COUNT(*) FROM gdelt a JOIN beacons b "
                "ON ST_DWithin(a.geom, b.loc, 3.0)",
                "SELECT COUNT(*) FROM zones z JOIN gdelt g "
                "ON ST_Contains(z.area, g.geom)"):
        port.query(sql)
    assert reads == []


def _pair_stores(na=4_000, nb=3_000):
    rng = np.random.default_rng(8)
    ax, ay = rng.uniform(-60, 60, na), rng.uniform(-30, 30, na)
    bx, by = rng.uniform(-60, 60, nb), rng.uniform(-30, 30, nb)
    out = []
    for ds in (InMemoryDataStore(device="cpu"), JaxStore()):
        ds.create_schema("a", "*geom:Point:srid=4326")
        ds.write_dict("a", [f"a{i}" for i in range(na)], {"geom": (ax, ay)})
        ds.create_schema("b", "*geom:Point:srid=4326")
        ds.write_dict("b", [f"b{i}" for i in range(nb)], {"geom": (bx, by)})
        out.append(ds)
    return out


def test_partitioned_route(monkeypatch):
    """Both packages' thresholds forced low: the DWithin join routes
    through grid partitioning inside query(), and gives the JAX rows and
    the direct route's pair set."""
    port_ds, ref_ds = _pair_stores()
    port, ref = SqlEngine(port_ds), JEngine(ref_ds)
    sql = ("SELECT a.__fid__, b.__fid__ FROM a JOIN b "
           "ON ST_DWithin(a.geom, b.geom, 0.8)")
    direct = port.query(sql)
    assert direct.n > 1000
    _same(direct, ref.query(sql))
    routed_calls = []
    import geomesa_tpu_torch.analytics.partitioning as tpart
    real = tpart.partitioned_dwithin_join

    def spy(*a, **kw):
        routed_calls.append(kw.get("device"))
        return real(*a, **kw)
    monkeypatch.setattr(tpart, "partitioned_dwithin_join", spy)
    for mod in (teng_mod, jeng_mod):
        monkeypatch.setattr(mod, "_PARTITION_PAIR_BUDGET", 1)
        monkeypatch.setattr(mod, "_PARTITION_MIN_SIDE", 10)
    routed = port.query(sql)
    assert routed_calls and str(routed_calls[0]) == "cpu"
    _same(routed, ref.query(sql))
    _same(routed, direct, ordered=False)


# -- scalars ------------------------------------------------------------------

def test_scalar_registry_equals_reference():
    from geomesa_tpu.analytics.st_functions import SQL_SCALARS as J
    assert set(SQL_SCALARS) == set(J)


SCALARS = [
    "SELECT ST_X(geom) AS x, ST_Y(geom) AS y, ST_AsText(geom) AS wkt, "
    "ST_GeometryType(geom) AS t FROM pts",
    "SELECT ST_AsBinary(geom) AS b, ST_AsGeoJSON(geom) AS j FROM pts",
    "SELECT ST_DistanceSpheroid(geom, ST_Point(10, 6)) AS d, "
    "ST_Relate(geom, ST_Point(10, 5)) AS m, "
    "ST_DistanceSphere(geom, ST_Point(1, 2)) AS ds, "
    "ST_Distance(geom, ST_Point(3, 3)) AS dd FROM pts",
    "SELECT ST_BufferPoint(geom, 10000) AS buf, ST_Buffer(geom, 0.5) AS b2"
    " FROM pts",
    "SELECT ST_Centroid(g) AS c, ST_Envelope(g) AS e, ST_Area(g) AS a, "
    "ST_Length(g) AS l FROM shapes",
    "SELECT ST_CastToPoint(geom) AS p, ST_CastToGeometry(geom) AS g "
    "FROM pts",
    "SELECT ST_CastToLineString(r) AS l FROM rings",
    "SELECT ST_CastToPolygon(area) AS p FROM zones",
    "SELECT ST_Translate(g, 1.0, -2.0) AS t, ST_ClosestPoint(g, "
    "ST_Point(5, 5)) AS cp, ST_RelateBool(g, ST_Point(1, 1), 'T********') "
    "AS rb FROM shapes",
    "SELECT ST_LengthSpheroid(g) AS ls, ST_AntimeridianSafeGeom(g) AS am, "
    "ST_IdlSafeGeom(g) AS idl FROM shapes",
    "SELECT ST_GeoHash(geom, 25) AS h, ST_GeoHash(geom) AS h25, "
    "ST_GeoHash(geom, 32) AS h32 FROM pts",
    "SELECT ST_GeomFromGeoHash(name, 10) AS cell, ST_GeomFromGeoHash(name)"
    " AS c2 FROM cells",
    "SELECT ST_PointN(g, 2) AS p, ST_NumPoints(g) AS n, "
    "ST_ExteriorRing(g) AS ring, ST_MakePolygon(g) AS poly FROM shapes",
    "SELECT ST_MakeBBOX(0, 0, 2, 3) AS b FROM shapes",
    "SELECT a.name, ST_GeoHash(a.geom, 20) AS h FROM pts a JOIN zones z "
    "ON ST_Contains(z.area, a.geom) ORDER BY a.name",
]


@pytest.mark.parametrize("sql", SCALARS)
def test_scalars(engines, sql):
    _both(engines, sql)


def test_every_scalar_is_covered():
    """Every name of SQL_SCALARS is called by some SCALARS statement,
    except ST_CONVEXHULL: in a select list both parsers read it as the
    hull aggregate (GROUPED and JOINS cover that)."""
    text = " ".join(SCALARS).upper()
    missing = [n for n in SQL_SCALARS
               if n + "(" not in text.replace(" (", "(")]
    assert missing == ["ST_CONVEXHULL"]


@pytest.mark.parametrize("wkt", ["LINESTRING (0 0, 1 2, 3 4, 2 -1)",
                                 "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
                                 "POINT (7 8)"])
def test_convex_hull_scalar(wkt):
    from geomesa_tpu.analytics.st_functions import SQL_SCALARS as J
    from geomesa_tpu.geometry import parse_wkt as jwkt
    from geomesa_tpu_torch.geometry import parse_wkt
    assert to_wkt(SQL_SCALARS["ST_CONVEXHULL"](parse_wkt(wkt))) == \
        jto_wkt(J["ST_CONVEXHULL"](jwkt(wkt)))


def test_geohash_scalars_round_trip(engines):
    port, ref = engines
    sql = ("SELECT ST_GeomFromGeoHash(ST_AsText(geom), 25) AS x FROM pts")
    with pytest.raises(Exception) as jexc:
        ref.query(sql)
    with pytest.raises(Exception) as exc:
        port.query(sql)
    assert type(exc.value).__name__ == type(jexc.value).__name__
    got = port.query("SELECT ST_GeoHash(geom, 30) AS h FROM pts")
    for h, g in zip(got.column("h"), port.query(
            "SELECT geom FROM pts").column("geom")):
        cell = SQL_SCALARS["ST_GEOMFROMGEOHASH"](h, 30)
        assert cell.envelope.contains_point(g.x, g.y)


# -- plans and join order -----------------------------------------------------

def _reorder_stores():
    out = []
    for ds in (InMemoryDataStore(device="cpu"), JaxStore()):
        rng = np.random.default_rng(5)
        for name, n, nkeys in (("big", 1500, 10), ("mid", 300, 5),
                               ("small", 30, 2)):
            ds.create_schema(name, "*geom:Point:srid=4326,"
                             "k:String:index=true,v:Integer")
            ds.write_dict(name, [f"{name}{i}" for i in range(n)], {
                "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)),
                "k": [f"k{i % nkeys}" for i in range(n)],
                "v": np.arange(n)})
        out.append(ds)
    return out


REORDER = [
    "SELECT COUNT(*) FROM small s JOIN big b ON s.k = b.k "
    "JOIN mid m ON s.k = m.k",
    "SELECT COUNT(*) FROM small s JOIN mid m ON s.k = m.k "
    "JOIN big b ON s.k = b.k",
    "SELECT s.__fid__, b.__fid__, m.__fid__ FROM small s "
    "JOIN big b ON ST_DWithin(s.geom, b.geom, 0.5) "
    "JOIN mid m ON ST_DWithin(s.geom, m.geom, 1.5) "
    "WHERE b.v < 900 AND m.v < 200 AND s.v < 20",
    "SELECT COUNT(*) FROM small s JOIN big b ON ST_DWithin(s.geom, "
    "b.geom, 0.5) JOIN mid m ON ST_DWithin(s.geom, m.geom, 1.5) "
    "WHERE b.geom IS NOT NULL AND ST_Contains(ST_MakeBBOX(-5, -5, 5, 5), "
    "m.geom)",
]


@pytest.mark.parametrize("planner", ["true", "false"])
@pytest.mark.parametrize("sql", REORDER)
def test_plans_and_join_order(sql, planner):
    port_ds, ref_ds = _reorder_stores()
    SQL_PLANNER.set(planner)
    JSQL_PLANNER.set(planner)
    try:
        got = SqlEngine(port_ds).query(sql)
        want = JEngine(ref_ds).query(sql)
    finally:
        SQL_PLANNER.set(None)
        JSQL_PLANNER.set(None)
    assert got.plan == want.plan
    assert got.plan["mode"] == "local"
    _same(got, want)


@pytest.mark.parametrize("where", [
    "b.k = 'k1' AND m.k = 'k1'", "b.k = 'k3' AND m.k = 'k0'",
    "b.k = 'k9' AND m.k = 'nope'", "b.k IN ('k1', 'k2') AND m.k = 'k4'"])
def test_string_filter_estimates_and_order(where):
    """A string-equality filter estimates through each package's own
    count-min hash (blake2b in the port); at this vocabulary both sketches
    are exact, so the estimates, the chosen order and the rows agree."""
    port_ds, ref_ds = _reorder_stores()
    sql = ("SELECT s.__fid__, m.__fid__, b.__fid__ FROM small s "
           "JOIN big b ON s.k = b.k JOIN mid m ON s.k = m.k WHERE " + where)
    got, want = SqlEngine(port_ds).query(sql), JEngine(ref_ds).query(sql)
    assert got.plan == want.plan
    _same(got, want)


def test_estimate_for_store_matches_reference():
    from geomesa_tpu.sql.planner import estimate_for_store as jest
    from geomesa_tpu_torch.sql.planner import estimate_for_store as test
    port_ds, ref_ds = _reorder_stores()
    for f in ("INCLUDE", "BBOX(geom, -5, -5, 5, 5)", "v < 100",
              "v BETWEEN 10 AND 20 AND BBOX(geom, 0, 0, 10, 10)", None):
        assert test(port_ds, "big", f) == jest(ref_ds, "big", f)
    assert test(port_ds, "nope", "INCLUDE") is None
    assert test(object(), "big", "INCLUDE") is None


def test_cost_model_matches_reference():
    from geomesa_tpu.sql.planner import CostModel as JCost
    from geomesa_tpu_torch.sql.planner import CostModel as TCost

    class Board:
        def latency_p99_s(self, name):
            return {"g0": 0.01, "g1": 0.03}.get(name)
    for legs, board in ((4, None), (3, Board()), (0, None)):
        a = TCost(legs, breakers=board, leg_names=["g0", "g1", "g2"])
        b = JCost(legs, breakers=board, leg_names=["g0", "g1", "g2"])
        assert a.describe() == b.describe()
        assert a.broadcast_cost(10, 10_000) == b.broadcast_cost(10, 10_000)
        assert a.materialize_cost(10, 10_000) == \
            b.materialize_cost(10, 10_000)


def test_result_surface():
    r = SqlResult(["a", "b"], {"a": np.array([1, 2]),
                               "b": np.array(["x", "y"], object)})
    assert r.n == 2 and list(r.rows()) == [(1, "x"), (2, "y")]
    assert r.complete and r.missing_groups == [] and r.plan is None
    assert SqlResult([], {}).n == 0


# -- the distributed legs -----------------------------------------------------

def _split_stores(make):
    """Three stores holding a hand split of the gdelt rows by x (like a
    z-prefix split: disjoint and covering), beside one store with all."""
    rng = np.random.default_rng(44)
    n = 1_800
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    names = np.array([f"a{i % 9}" for i in range(n)], object)
    names[::37] = None
    val = rng.integers(0, 500, n).astype(object)
    val[::53] = None
    data = {"name": names, "val": val, "score": rng.normal(0, 2, n),
            "geom": (x, y)}
    spec = "name:String,val:Integer,score:Double,*geom:Point:srid=4326"
    ids = np.array([f"r{i}" for i in range(n)], object)
    part = np.digitize(x, [-60.0, 60.0])
    whole = make()
    whole.create_schema("gdelt", spec)
    whole.write_dict("gdelt", ids, data)
    legs = []
    for p in range(3):
        m = part == p
        ds = make()
        ds.create_schema("gdelt", spec)
        ds.write_dict("gdelt", ids[m], {
            "name": names[m], "val": val[m], "score": data["score"][m],
            "geom": (x[m], y[m])})
        legs.append(ds)
    zones = _zone_wkts(np.random.default_rng(45), 6)
    for ds in [whole] + legs:
        ds.create_schema("zones", "zid:Integer,*area:Polygon")
        ds.write_dict("zones", [f"z{i}" for i in range(6)],
                      {"zid": list(range(6)), "area": zones})
    return whole, legs


@pytest.fixture(scope="module")
def split():
    return (_split_stores(lambda: InMemoryDataStore(device="cpu")),
            _split_stores(JaxStore))


LEG_AGGS = [
    "SELECT name, COUNT(*) AS n, SUM(val) AS s, AVG(val) AS a, "
    "MIN(score) AS lo, MAX(score) AS hi FROM gdelt GROUP BY name",
    "SELECT COUNT(*), COUNT(val), SUM(score), AVG(val), MIN(val), "
    "MAX(val) FROM gdelt WHERE ST_Contains(ST_MakeBBOX(-100, -50, 100, 50),"
    " geom)",
    "SELECT name, COUNT(*) AS n FROM gdelt WHERE val < 250 GROUP BY name "
    "HAVING COUNT(*) > 60 ORDER BY n DESC LIMIT 4",
    "SELECT name, ST_Extent(geom) AS e, ST_ConvexHull(geom) AS h "
    "FROM gdelt GROUP BY name",
    "SELECT name, val, COUNT(*) AS n FROM gdelt WHERE val < 5 "
    "GROUP BY name, val",
    "SELECT name, SUM(val) AS s FROM gdelt GROUP BY name "
    "HAVING AVG(val) > 240",
    "SELECT COUNT(*) AS n FROM gdelt WHERE val > 9000",
]


@pytest.mark.parametrize("sql", LEG_AGGS)
def test_partial_aggregate_legs(split, sql):
    (twhole, tlegs), (jwhole, jlegs) = split
    sel, jsel = parse_sql(sql), jparse(sql)
    tparts = [tdist.partial_aggregate(ds, sql) for ds in tlegs]
    jparts = [jdist.partial_aggregate(ds, sql) for ds in jlegs]
    # each leg's wire payload equals the JAX leg's
    assert tparts == jparts
    merged = tdist.merge_partial_legs(sel, tparts, qualified=False)
    jmerged = jdist.merge_partial_legs(jsel, jparts, qualified=False)
    _same(merged, jmerged)
    # and the merge equals one store's engine answer: the groups in
    # key order (a merge sorts its keys, None last; one store lists them
    # by code, the null group first) unless the statement orders them,
    # the float sums within 1e-12 relative (three leg sums add in
    # another order than one bincount)
    _close(merged, SqlEngine(twhole).query(sql), sel.order_by is None)


def _close(got, want, by_key):
    assert got.names == want.names and got.n == want.n
    g, w = _rows(got), _rows(want)
    if by_key:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-12, abs=1e-12)
            else:
                assert x == y


JOIN_LEGS = [
    ("count", "SELECT COUNT(*) FROM gdelt g JOIN zones z "
              "ON ST_Contains(z.area, g.geom)"),
    ("count", "SELECT COUNT(*) FROM gdelt g JOIN zones z "
              "ON ST_DWithin(g.geom, z.area, 4.0) WHERE g.val < 300"),
    ("agg", "SELECT z.zid, COUNT(*) AS n, SUM(g.val) AS s, AVG(g.score) "
            "AS a, ST_Extent(g.geom) AS e FROM gdelt g JOIN zones z "
            "ON ST_Contains(z.area, g.geom) GROUP BY z.zid"),
    ("agg", "SELECT COUNT(g.val) AS c, MAX(g.score) AS m FROM gdelt g "
            "JOIN zones z ON ST_Contains(z.area, g.geom)"),
    ("rows", "SELECT g.__fid__, z.zid FROM gdelt g JOIN zones z "
             "ON ST_Contains(z.area, g.geom) WHERE g.val < 100"),
    ("rows", "SELECT g.__fid__, z.zid FROM gdelt g LEFT JOIN zones z "
             "ON ST_Contains(z.area, g.geom) WHERE g.val < 40"),
]


@pytest.mark.parametrize("mode,sql", JOIN_LEGS)
def test_join_partial_legs(split, mode, sql):
    (twhole, tlegs), (jwhole, jlegs) = split
    # broadcast the zones side, filtered at the "coordinator"
    tz = twhole.query("INCLUDE", "zones")
    jz = jwhole.query("INCLUDE", "zones")
    tpay = tdist._encode_batch("zones", twhole.get_schema("zones"), tz)
    jpay = jdist._encode_batch("zones", jwhole.get_schema("zones"), jz)
    assert tpay == jpay
    spec = {"sql": sql, "broadcast": "z", "mode": mode, "payload": tpay}
    tparts = [tdist.join_partial_leg(ds, spec) for ds in tlegs]
    jparts = [jdist.join_partial_leg(ds, spec) for ds in jlegs]
    one = SqlEngine(twhole).query(sql)
    if mode == "count":
        assert tparts == jparts
        total = sum(p["count"] for p in tparts)
        assert total == int(one.column(one.names[0])[0]) > 0
        return
    if mode == "agg":
        assert tparts == jparts
        merged = tdist.merge_partial_legs(parse_sql(sql), tparts,
                                          qualified=True)
        _close(merged, one, True)
        return
    for tp, jp in zip(tparts, jparts):
        assert tp["names"] == jp["names"] and tp["n"] == jp["n"]
        assert collections.Counter(map(repr, zip(*tp["cols"].values()))) == \
            collections.Counter(map(repr, zip(*jp["cols"].values())))
    got = collections.Counter(
        r for p in tparts for r in zip(*[map(repr, p["cols"][n])
                                         for n in p["names"]]))
    want = collections.Counter(repr(r) for r in zip(*[
        [_norm(v) for v in one.column(n)] for n in one.names]))
    assert sum(got.values()) == sum(want.values()) == one.n


def test_leg_payloads_decode_across_packages(split):
    (twhole, _), (jwhole, _) = split
    for ds, enc, dec_other in ((twhole, tdist._encode_batch,
                                jdist._decode_batch),
                               (jwhole, jdist._encode_batch,
                                tdist._decode_batch)):
        for table, f in (("gdelt", "val < 80"), ("zones", "zid > 2"),
                         ("gdelt", "val > 100000")):
            res = ds.query(f, table)
            pay = enc(table, ds.get_schema(table), res)
            sft, ids, batch = dec_other(pay)
            assert sft.to_spec() == ds.get_schema(table).to_spec()
            assert list(ids) == [str(i) for i in res.ids]
            assert batch.n == res.n
            for a in sft.attributes:
                got = [_norm(batch.col(a.name).value(i))
                       for i in range(batch.n)]
                want = [_norm(res.batch.col(a.name).value(i))
                        for i in range(res.n)]
                assert got == want


def test_leg_errors_match(split):
    (twhole, _), (jwhole, _) = split
    for sql in ("SELECT COUNT(*) FROM gdelt a JOIN zones z "
                "ON ST_Contains(z.area, a.geom)",
                "SELECT name, ST_X(geom) FROM gdelt GROUP BY name"):
        with pytest.raises(ValueError) as jexc:
            jdist.partial_aggregate(jwhole, sql)
        with pytest.raises(ValueError) as exc:
            tdist.partial_aggregate(twhole, sql)
        assert str(exc.value) == str(jexc.value)


def test_try_distributed_needs_a_cluster(engines):
    """Over one store the engine finds no cluster and stays local."""
    port, _ = engines
    assert port._cluster_store() is None
    res = port.query("SELECT COUNT(*) FROM gdelt")
    assert res.plan == {"mode": "local", "distributed": False}


def test_try_distributed_switch_off(engines):
    from geomesa_tpu_torch.utils.properties import SQL_DISTRIBUTED
    SQL_DISTRIBUTED.set("false")
    try:
        out, reason = tdist.try_distributed(
            engines[0], None, parse_sql("SELECT COUNT(*) FROM gdelt"),
            "SELECT COUNT(*) FROM gdelt")
    finally:
        SQL_DISTRIBUTED.set(None)
    assert out is None
    assert reason == "disabled (geomesa.sql.distributed=false)"


# -- the file store -----------------------------------------------------------

def test_file_store_group_by_and_join(tmp_path):
    rng = np.random.default_rng(61)
    n = 1_200
    data = {"name": [f"n{i % 7}" for i in range(n)],
            "val": rng.integers(0, 100, n),
            "dtg": rng.integers(MS("2020-01-01"), MS("2020-03-01"), n),
            "geom": (rng.uniform(-50, 50, n), rng.uniform(-40, 40, n))}
    zones = _zone_wkts(np.random.default_rng(62), 5)
    stores = []
    for make, sub in ((lambda r: FileSystemDataStore(r, device="cpu"),
                       "port"), (JFsStore, "jax")):
        ds = make(str(tmp_path / sub))
        ds.create_schema("ev", "name:String,val:Integer,dtg:Date,"
                         "*geom:Point:srid=4326")
        ds.write_dict("ev", [f"e{i}" for i in range(n)], data)
        ds.create_schema("zones", "zid:Integer,*area:Polygon")
        ds.write_dict("zones", [f"z{i}" for i in range(5)],
                      {"zid": list(range(5)), "area": zones})
        stores.append(ds)
    port, ref = SqlEngine(stores[0]), JEngine(stores[1])
    for sql, ordered in (
            ("SELECT name, COUNT(*) AS n, SUM(val) AS s, AVG(val) AS a "
             "FROM ev WHERE val < 50 OR dtg > '2020-02-15T00:00:00Z' "
             "GROUP BY name ORDER BY name", True),
            ("SELECT name, COUNT(*) AS n, SUM(val) AS s FROM ev "
             "WHERE ST_Contains(ST_MakeBBOX(-30, -30, 30, 30), geom) "
             "GROUP BY name ORDER BY name", True),
            ("SELECT z.zid, COUNT(*) AS n, MAX(e.val) AS m FROM ev e "
             "JOIN zones z ON ST_Contains(z.area, e.geom) GROUP BY z.zid "
             "ORDER BY z.zid", True),
            ("SELECT COUNT(*) FROM ev e JOIN zones z "
             "ON ST_DWithin(e.geom, z.area, 3.0)", True)):
        try:
            want = ref.query(sql)
        except Exception as jexc:   # noqa: BLE001 — the same refusal
            with pytest.raises(type(jexc)):
                port.query(sql)
            continue
        _same(port.query(sql), want, ordered)


# -- a plan the planner proves empty ------------------------------------------

EMPTY_PLAN = [
    "SELECT name, val FROM gdelt WHERE ST_Contains(ST_MakeBBOX(0, 0, 1, 1),"
    " geom) AND ST_Contains(ST_MakeBBOX(5, 5, 6, 6), geom)",
    "SELECT * FROM gdelt WHERE ST_Contains(ST_MakeBBOX(-10, 11, 26, 14), "
    "geom) AND ST_Contains(ST_MakeBBOX(30, -30, 35, -25), geom)",
    "SELECT a.name, c.bid FROM gdelt a JOIN beacons c ON "
    "ST_DWithin(a.geom, c.loc, 1.0) WHERE ST_Contains(ST_MakeBBOX(-10, 11, "
    "26, 14), a.geom) AND ST_Contains(ST_MakeBBOX(30, -30, 35, -25), "
    "a.geom)",
]


@pytest.mark.parametrize("sql", EMPTY_PLAN)
def test_empty_plan_answers_the_selected_columns(engines, sql):
    """A WHERE the planner proves empty (two disjoint boxes under AND)
    gives the JAX engine's column names and 0 rows, on a projection and
    on a DWithin join (whose projection reads the empty side's
    columns)."""
    got, want = _both(engines, sql)
    assert got.n == 0 and got.names == want.names


# -- distributed SQL over a real ClusterDataStore (tests/test_sql_distributed.py)
#
# The same four-group cluster in both packages (the port's groups on the
# CPU) and a single store beside each: every statement runs on the port's
# cluster engine, the port's single-store engine and the JAX cluster
# engine. The cluster answers as the single store does (rows in order
# where ORDER BY applies) and as the JAX cluster does (rows in order,
# plans equal): the engine reaches ``try_distributed`` through its own
# gate.

from geomesa_tpu.cluster import ClusterDataStore as JCluster  # noqa: E402
from geomesa_tpu.cluster import \
    ShardUnavailableError as JShardUnavailable  # noqa: E402
from geomesa_tpu.features import FeatureBatch as JBatch  # noqa: E402
from geomesa_tpu.features import parse_spec as jspec  # noqa: E402
from geomesa_tpu.geometry import Polygon as JPolygon  # noqa: E402
from geomesa_tpu.sql.distributed import \
    SQL_BROADCAST_ROWS as JBROADCAST  # noqa: E402
from geomesa_tpu.sql.distributed import \
    SQL_DISTRIBUTED as JDISTRIBUTED  # noqa: E402
from geomesa_tpu.web import GeoMesaWebServer as JServer  # noqa: E402
from geomesa_tpu_torch.cluster import ClusterDataStore  # noqa: E402
from geomesa_tpu_torch.cluster import ShardUnavailableError  # noqa: E402
from geomesa_tpu_torch.features import FeatureBatch  # noqa: E402
from geomesa_tpu_torch.features import parse_spec  # noqa: E402
from geomesa_tpu_torch.geometry import Polygon  # noqa: E402
from geomesa_tpu_torch.utils.properties import (  # noqa: E402
    SQL_BROADCAST_ROWS, SQL_DISTRIBUTED)
from geomesa_tpu_torch.web import GeoMesaWebServer  # noqa: E402

D_PTS_SPEC = "*geom:Point:srid=4326,name:String,val:Integer,dtg:Date"
D_N = 3000
PORT_SIDE = dict(store=lambda: InMemoryDataStore(device="cpu"),
                 cluster=ClusterDataStore, batch=FeatureBatch,
                 spec=parse_spec, poly=Polygon, engine=SqlEngine,
                 server=GeoMesaWebServer)
JAX_SIDE = dict(store=JaxStore, cluster=JCluster, batch=JBatch, spec=jspec,
                poly=JPolygon, engine=JEngine, server=JServer)


def _d_seed(side, *stores):
    """test_sql_distributed.py's pts (3,000), zones (8) and hubs (6)."""
    psft = side["spec"]("pts", D_PTS_SPEC)
    zsft = side["spec"]("zones", "*geom:Polygon:srid=4326,zname:String,"
                                 "zval:Integer")
    hsft = side["spec"]("hubs", "*geom:Point:srid=4326,hname:String")
    rng = np.random.default_rng(7)
    names = np.array(["alpha", "bravo", "charlie", "delta", "echo"],
                     dtype=object)
    pb = side["batch"].from_dict(
        psft, np.array([f"f{i:05d}" for i in range(D_N)], dtype=object), {
            "geom": (rng.uniform(-170, 170, D_N), rng.uniform(-80, 80, D_N)),
            "name": names[rng.integers(0, 5, D_N)],
            "val": rng.permutation(D_N).astype(np.int64),
            "dtg": np.int64(1_600_000_000_000)
            + rng.integers(0, 10_000_000, D_N)})

    def box(x0, y0, x1, y1):
        return side["poly"](np.array([[x0, y0], [x1, y0], [x1, y1],
                                      [x0, y1], [x0, y0]], float))
    zb = side["batch"].from_dict(
        zsft, np.array([f"z{i}" for i in range(8)], dtype=object),
        {"geom": np.array([box(-160 + 40 * i, -60, -130 + 40 * i, -20)
                           for i in range(8)], dtype=object),
         "zname": np.array([f"zone{i}" for i in range(8)], dtype=object),
         "zval": np.arange(8, dtype=np.int64)})
    hrng = np.random.default_rng(11)
    hb = side["batch"].from_dict(
        hsft, np.array([f"h{i}" for i in range(6)], dtype=object),
        {"geom": (hrng.uniform(-150, 150, 6), hrng.uniform(-60, 60, 6)),
         "hname": np.array([f"hub{i}" for i in range(6)], dtype=object)})
    for st in stores:
        for sft, batch in ((psft, pb), (zsft, zb), (hsft, hb)):
            st.create_schema(sft)
            st.write(sft.type_name, batch)


def _d_plane(side, **kw):
    groups = [side["store"]() for _ in range(4)]
    cluster = side["cluster"](groups, leg_deadline_s=30, **kw)
    oracle = side["store"]()
    _d_seed(side, cluster, oracle)
    assert all(g.count("pts") > 0 for g in groups)
    return cluster, oracle


@pytest.fixture(scope="module")
def dplane():
    pc, po = _d_plane(PORT_SIDE)
    jc, _ = _d_plane(JAX_SIDE)
    yield SqlEngine(pc), SqlEngine(po), JEngine(jc)
    pc.close()
    jc.close()


def _dcmp(dplane, stmt, ordered=False, mode=None):
    """The port's cluster against its single store and the JAX cluster."""
    ce, oe, je = dplane
    got, single, ref = ce.query(stmt), oe.query(stmt), je.query(stmt)
    _same(got, single, ordered)
    _same(got, ref, ordered=True)
    assert _timeless(got.plan) == _timeless(ref.plan)
    assert got.complete is True
    if mode is not None:
        assert got.plan["mode"] == mode, got.plan
    return got


def _timeless(plan):
    """A plan without the cost model's measured seconds (the planner
    recalibrates its per-leg cost from observed leg latencies)."""
    if isinstance(plan, dict):
        return {k: _timeless(v) for k, v in plan.items()
                if not (k.endswith("cost_s") or k == "leg_s")}
    if isinstance(plan, list):
        return [_timeless(v) for v in plan]
    return plan


def _flip(knob_port, knob_jax, value):
    knob_port.set(value)
    knob_jax.set(value)


D_AGG_SHAPES = [
    "SELECT name, COUNT(*), SUM(val), MIN(val), MAX(val), AVG(val) "
    "FROM pts GROUP BY name",
    "SELECT name, COUNT(val) AS cv FROM pts GROUP BY name",
    "SELECT name, COUNT(*) AS n FROM pts WHERE val < 1500 GROUP BY name",
    "SELECT name, COUNT(*) AS n FROM pts GROUP BY name "
    "HAVING COUNT(*) > 100",
    "SELECT name, MIN(val) FROM pts GROUP BY name HAVING COUNT(*) > 550",
    "SELECT name, ST_ConvexHull(geom) FROM pts GROUP BY name",
    "SELECT name, ST_Extent(geom) FROM pts GROUP BY name",
    "SELECT COUNT(*), COUNT(val), SUM(val), MIN(val), MAX(val), "
    "AVG(val) FROM pts",
    "SELECT ST_ConvexHull(geom), ST_Extent(geom) FROM pts",
    "SELECT MIN(dtg), MAX(dtg) FROM pts",
    "SELECT COUNT(*), SUM(val), MIN(val) FROM pts WHERE val < 0",
]


def test_cluster_store_reaches_try_distributed(dplane, monkeypatch):
    ce = dplane[0]
    assert ce._cluster_store() is ce.store
    seen = []
    real = tdist.try_distributed
    monkeypatch.setattr(tdist, "try_distributed",
                        lambda *a: seen.append(a[3]) or real(*a))
    ce.query("SELECT COUNT(*) FROM pts")
    assert seen == ["SELECT COUNT(*) FROM pts"]


@pytest.mark.parametrize("stmt", D_AGG_SHAPES)
def test_distributed_aggregate_equivalent(dplane, stmt):
    res = _dcmp(dplane, stmt, mode="distributed-aggregate")
    assert res.plan["distributed"] is True and len(res.plan["legs"]) == 4


def test_distributed_order_by_limit_and_merge_plan(dplane):
    _dcmp(dplane, "SELECT name, COUNT(*) AS cnt FROM pts GROUP BY name "
                  "ORDER BY cnt DESC LIMIT 2", ordered=True,
          mode="distributed-aggregate")
    res = _dcmp(dplane, "SELECT name, AVG(val) FROM pts GROUP BY name")
    assert res.plan["merge"] == "by-key"
    assert any("avg" in p for p in res.plan["partials"])


def test_distributed_kill_switch_falls_back_exactly(dplane):
    _flip(SQL_DISTRIBUTED, JDISTRIBUTED, "false")
    try:
        res = _dcmp(dplane, "SELECT name, SUM(val) FROM pts GROUP BY name",
                    mode="cluster-materialize")
        assert res.plan["distributed"] is False
    finally:
        _flip(SQL_DISTRIBUTED, JDISTRIBUTED, None)


def test_distributed_streamed_order_limit_exact(dplane):
    res = _dcmp(dplane, "SELECT __fid__, name, val FROM pts ORDER BY val "
                        "LIMIT 25", ordered=True, mode="distributed-stream")
    assert res.plan["merge"] == "k-way-stream"


def test_distributed_invalid_statement_raises_like_single_node(dplane):
    ce, oe, je = dplane
    stmt = "SELECT name, SUM(nosuch) FROM pts GROUP BY name"
    errs = []
    for eng in (ce, oe, je):
        with pytest.raises(Exception) as e:
            eng.query(stmt)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1] == errs[2]


D_JOIN_SHAPES = [
    ("SELECT COUNT(*) FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom)", False),
    ("SELECT z.zname, COUNT(*), SUM(p.val) FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom) GROUP BY z.zname", False),
    ("SELECT p.name, COUNT(*), AVG(p.val) FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom) GROUP BY p.name", False),
    ("SELECT COUNT(*), SUM(p.val), MIN(p.val), MAX(p.val) FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom)", False),
    ("SELECT p.__fid__, z.zname, p.val FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom) "
     "ORDER BY p.val LIMIT 30", True),
    ("SELECT p.__fid__, z.zname FROM pts p "
     "JOIN zones z ON ST_Contains(z.geom, p.geom) WHERE p.val < 200", False),
    ("SELECT h.hname, COUNT(*) FROM pts p "
     "JOIN hubs h ON ST_DWithin(p.geom, h.geom, 10.0) GROUP BY h.hname",
     False),
    ("SELECT COUNT(*) FROM pts p JOIN zones z ON p.name = z.zname", False),
    ("SELECT p.__fid__, z.zname FROM pts p "
     "LEFT JOIN zones z ON ST_Contains(z.geom, p.geom) "
     "WHERE p.val < 100", False),
    ("SELECT z.zname, COUNT(*) FROM pts p "
     "LEFT JOIN zones z ON ST_Contains(z.geom, p.geom) "
     "GROUP BY z.zname", False),
]


@pytest.mark.parametrize("stmt,ordered", D_JOIN_SHAPES)
def test_broadcast_join_equivalent(dplane, stmt, ordered):
    res = _dcmp(dplane, stmt, ordered=ordered, mode="broadcast-join")
    assert res.plan["broadcast"]["rows"] <= SQL_BROADCAST_ROWS.as_int()


def test_broadcast_side_choice(dplane):
    res = _dcmp(dplane, "SELECT COUNT(*) FROM pts p "
                        "JOIN zones z ON ST_Contains(z.geom, p.geom)")
    assert res.plan["broadcast"]["table"] == "zones"
    assert res.plan["broadcast"]["rows"] == 8
    res = _dcmp(dplane, "SELECT z.zname, p.name FROM zones z "
                        "LEFT JOIN pts p ON ST_Contains(z.geom, p.geom) "
                        "WHERE p.val < 3", mode="broadcast-join")
    assert res.plan["broadcast"]["side"] == "p"


@pytest.mark.parametrize("rows,stmt,reason", [
    ("100", "SELECT z.zname, p.name FROM zones z LEFT JOIN pts p ON "
            "ST_Contains(z.geom, p.geom) WHERE p.val < 3",
     "anchors cannot broadcast"),
    ("1", "SELECT COUNT(*) FROM pts p "
          "JOIN zones z ON ST_Contains(z.geom, p.geom)",
     "no broadcastable side")])
def test_broadcast_falls_back_exactly(dplane, rows, stmt, reason):
    _flip(SQL_BROADCAST_ROWS, JBROADCAST, rows)
    try:
        res = _dcmp(dplane, stmt, mode="cluster-materialize")
        assert reason in res.plan["fallback_reason"]
    finally:
        _flip(SQL_BROADCAST_ROWS, JBROADCAST, None)


class _DeadLeg:
    """Shard whose every call fails (hedges and retries included)."""

    def close(self):
        pass

    def __getattr__(self, key):
        def boom(*a, **kw):
            raise ConnectionError("injected: shard down")
        return boom


def _wounded(side, allow_partial):
    groups = [side["store"]() for _ in range(4)]
    cluster = side["cluster"](groups, allow_partial=allow_partial)
    oracle = side["store"]()
    _d_seed(side, cluster, oracle)
    cluster._groups[2] = _DeadLeg()
    return cluster, oracle


@pytest.mark.parametrize("stmt", [
    "SELECT name, COUNT(*) FROM pts GROUP BY name",
    "SELECT COUNT(*) FROM pts p JOIN zones z ON ST_Contains(z.geom, p.geom)"])
def test_dead_group_raises_typed_by_default(stmt):
    out = []
    for side, err in ((PORT_SIDE, ShardUnavailableError),
                      (JAX_SIDE, JShardUnavailable)):
        cluster, _ = _wounded(side, allow_partial=False)
        try:
            with pytest.raises(err) as ei:
                side["engine"](cluster).query(stmt)
            assert "shard2" in ei.value.groups and ei.value.z_ranges
            out.append((ei.value.groups, ei.value.z_ranges))
        finally:
            cluster.close()
    assert out[0] == out[1]


def test_dead_group_flagged_when_partials_allowed():
    stmt = "SELECT name, COUNT(*) FROM pts GROUP BY name"
    out = []
    for side in (PORT_SIDE, JAX_SIDE):
        cluster, oracle = _wounded(side, allow_partial=True)
        try:
            res = side["engine"](cluster).query(stmt)
            assert res.complete is False
            assert res.missing_groups == ["shard2"] and res.missing_z_ranges
            got = dict(res.rows())
            want = dict(side["engine"](oracle).query(stmt).rows())
            assert set(got) <= set(want)
            assert all(got[k] <= want[k] for k in got)
            out.append((_rows(res), res.missing_z_ranges,
                        _timeless(res.plan)))
        finally:
            cluster.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("server", ["port", "jax"])
def test_rest_legs_match_single_store(server):
    """The port's ``cluster://`` engine over two web servers of either
    package, against its single store and the JAX engine over the same
    servers' twins."""
    srv_side = PORT_SIDE if server == "port" else JAX_SIDE
    results = []
    for side in (PORT_SIDE, JAX_SIDE):
        backends = [srv_side["store"](), srv_side["store"]()]
        servers = [srv_side["server"](b).start() for b in backends]
        try:
            uri = "cluster://" + ",".join(f"127.0.0.1:{s.port}"
                                          for s in servers)
            cluster = side["cluster"].from_uri(uri, leg_deadline_s=30)
            oracle = side["store"]()
            _d_seed(side, cluster, oracle)
            ce, oe = side["engine"](cluster), side["engine"](oracle)
            got = []
            for stmt, ordered, mode in [
                    ("SELECT name, COUNT(*), SUM(val), AVG(val) FROM pts "
                     "GROUP BY name", False, "distributed-aggregate"),
                    ("SELECT name, ST_Extent(geom) FROM pts GROUP BY name",
                     False, "distributed-aggregate"),
                    ("SELECT z.zname, COUNT(*) FROM pts p JOIN zones z ON "
                     "ST_Contains(z.geom, p.geom) GROUP BY z.zname", False,
                     "broadcast-join"),
                    ("SELECT p.__fid__, z.zname, p.val FROM pts p JOIN zones "
                     "z ON ST_Contains(z.geom, p.geom) ORDER BY p.val "
                     "LIMIT 20", True, "broadcast-join")]:
                a, b = ce.query(stmt), oe.query(stmt)
                _same(a, b, ordered)
                assert a.plan["mode"] == mode
                got.append((_rows(a), a.plan["mode"]))
            results.append(got)
            cluster.close()
        finally:
            for s in servers:
                s.stop()
    assert results[0] == results[1]
