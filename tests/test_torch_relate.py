"""The port's geometry model, relate and distance predicates against the
JAX package: DE-9IM matrices and the predicates built on them, WKB and
GeoJSON, the ST_* functions, the ECQL grammar's DWITHIN and relate
operators, and those filters on a point schema through both stores.

Tolerance is exact (strings, booleans, bytes, dicts and ids equal), except
where a test says otherwise.
"""

import math

import numpy as np
import pytest

from geomesa_tpu.analytics import st_functions as jst
from geomesa_tpu.filters.ecql import ECQLError as JECQLError
from geomesa_tpu.filters.ecql import parse_ecql as jparse_ecql
from geomesa_tpu.filters.helper import dwithin_degrees as jdwithin_degrees
from geomesa_tpu.geometry import geojson as jgeojson
from geomesa_tpu.geometry import parse_wkt as jparse_wkt
from geomesa_tpu.geometry import relate as jrelate
from geomesa_tpu.geometry import wkb as jwkb
from geomesa_tpu.store import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.analytics import st_functions as tst
from geomesa_tpu_torch.filters.ecql import ECQLError, parse_ecql
from geomesa_tpu_torch.filters.helper import (METERS_MULTIPLIERS,
                                              dwithin_degrees)
from geomesa_tpu_torch.geometry import geojson as tgeojson
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.geometry import relate as trelate
from geomesa_tpu_torch.geometry import wkb as twkb

SQ = "POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))"
SQ_SHIFT = "POLYGON ((1 1, 3 1, 3 3, 1 3, 1 1))"
SQ_FAR = "POLYGON ((5 5, 6 5, 6 6, 5 6, 5 5))"
SQ_EDGE = "POLYGON ((2 0, 4 0, 4 2, 2 2, 2 0))"
SQ_CORNER = "POLYGON ((2 2, 3 2, 3 3, 2 3, 2 2))"
SQ_IN = "POLYGON ((0.5 0.5, 1.5 0.5, 1.5 1.5, 0.5 1.5, 0.5 0.5))"
DONUT = ("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), "
         "(3 3, 7 3, 7 7, 3 7, 3 3))")
HOLED_SQ = ("POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0), "
            "(1 1, 1.5 1, 1.5 1.5, 1 1.5, 1 1))")
THIN_DONUT = ("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), "
              "(1 1, 9 1, 9 9, 1 9, 1 1))")

# tests/test_relate.py's pairs (its known matrices, hole, shared-boundary
# and derived-predicate cases), now run through both packages
RELATE_PAIRS = [
    (SQ, SQ_SHIFT), (SQ, SQ_FAR), (SQ, SQ_EDGE), (SQ, SQ_CORNER),
    (SQ, SQ_IN), (SQ_IN, SQ), (SQ, SQ),
    ("LINESTRING (-1 1, 3 1)", SQ), ("LINESTRING (0.5 1, 1.5 1)", SQ),
    ("LINESTRING (0 0, 2 0)", SQ),
    ("LINESTRING (0 0, 1 1)", "LINESTRING (1 0, 0 1)"),
    ("LINESTRING (0 0, 1 1)", "LINESTRING (0 0, 1 1)"),
    ("LINESTRING (0 0, 2 2)", "LINESTRING (1 1, 3 3)"),
    ("LINESTRING (0 0, 1 1)", "LINESTRING (1 1, 2 0)"),
    ("POINT (1 1)", SQ), ("POINT (0 1)", SQ), ("POINT (9 9)", SQ),
    ("POINT (1 1)", "LINESTRING (0 0, 2 2)"),
    ("POINT (0 0)", "LINESTRING (0 0, 2 2)"),
    ("POINT (3 3)", "POINT (3 3)"), ("POINT (3 3)", "POINT (4 4)"),
    (DONUT, "POLYGON ((4 4, 6 4, 6 6, 4 6, 4 4))"),
    (DONUT, "POLYGON ((2 2, 8 2, 8 8, 2 8, 2 2))"),
    (SQ, HOLED_SQ), (HOLED_SQ, SQ),
    ("LINESTRING (0 0, 2 2)", "LINESTRING (0 2, 2 0)"),
    (SQ, "LINESTRING (2 0.5, 3 1.5)"),
    (SQ, "POLYGON ((0 0, 1 0, 1 2, 0 2, 0 0))"),
    ("POINT (0 1)", SQ), (THIN_DONUT, "POINT (5 5)"),
    ("MULTIPOINT ((0 0), (1 1), (5 5))", SQ),
    ("MULTILINESTRING ((0 0, 1 1), (3 3, 4 4))", SQ),
    ("MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), "
     "((3 3, 4 3, 4 4, 3 4, 3 3)))", SQ_SHIFT),
]

PREDICATES = ["touches", "crosses", "overlaps", "topo_equals", "covers",
              "covered_by"]
METHODS = ["intersects", "disjoint", "contains", "within"]


def _outcome(fn):
    """('ok', value) or ('err', exception type name): the two packages
    must agree on failures too."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001
        return "err", type(e).__name__


def _same_geometry(a, b) -> bool:
    return a.geom_type == b.geom_type and repr(a) == repr(b)


def _check_pair(wa: str, wb: str):
    ja, jb = jparse_wkt(wa), jparse_wkt(wb)
    ta, tb = parse_wkt(wa), parse_wkt(wb)
    assert _outcome(lambda: trelate.relate(ta, tb)) == \
        _outcome(lambda: jrelate.relate(ja, jb)), (wa, wb)
    for p in PREDICATES:
        assert _outcome(lambda: getattr(trelate, p)(ta, tb)) == \
            _outcome(lambda: getattr(jrelate, p)(ja, jb)), (p, wa, wb)
    for m in METHODS:
        assert _outcome(lambda: getattr(ta, m)(tb)) == \
            _outcome(lambda: getattr(ja, m)(jb)), (m, wa, wb)
    # distances: the same float64 operations in the same order, so equal
    assert _outcome(lambda: ta.distance(tb)) == \
        _outcome(lambda: ja.distance(jb)), ("distance", wa, wb)
    assert _outcome(lambda: ta.dwithin(tb, 0.75)) == \
        _outcome(lambda: ja.dwithin(jb, 0.75)), ("dwithin", wa, wb)


@pytest.mark.parametrize("wa,wb", RELATE_PAIRS)
def test_relate_cases_match_reference(wa, wb):
    _check_pair(wa, wb)
    _check_pair(wb, wa)


@pytest.mark.parametrize("matrix,pattern", [
    ("212101212", "T*T***T**"), ("FF2FF1212", "T********"),
    ("0FFFFF212", "0FFFFF***"), ("FF2F01212", "FF*FT****"),
    ("1010F0102", "1*T***T**"), ("2FFF1FFF2", "T*F**FFF*")])
def test_relate_matches_reference(matrix, pattern):
    assert trelate.relate_matches(matrix, pattern) == \
        jrelate.relate_matches(matrix, pattern)


@pytest.mark.parametrize("wkt", [SQ, DONUT, THIN_DONUT, HOLED_SQ,
                                 "LINESTRING (0 0, 3 1, 4 4)",
                                 "POINT (2 3)",
                                 "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), "
                                 "((3 3, 4 3, 4 4, 3 3)))"])
def test_interior_point_matches_reference(wkt):
    """Equal points for polygonal geometries; the same error for others."""
    assert _outcome(lambda: trelate.interior_point(parse_wkt(wkt))) == \
        _outcome(lambda: jrelate.interior_point(jparse_wkt(wkt)))


# -- a seeded battery --------------------------------------------------------

def _coord(rng) -> str:
    # a half-unit grid over [0, 6]: shared vertices, edges and collinear
    # runs happen often
    return f"{rng.integers(0, 13) / 2} {rng.integers(0, 13) / 2}"


def _ring(rng, x0, y0, w, h) -> str:
    return (f"({x0} {y0}, {x0 + w} {y0}, {x0 + w} {y0 + h}, "
            f"{x0} {y0 + h}, {x0} {y0})")


def _polygon_body(rng) -> str:
    x0, y0 = rng.integers(0, 9, 2) / 2
    w, h = rng.integers(1, 7, 2) / 2
    if rng.random() < 0.3:
        # a triangle
        return f"(({x0} {y0}, {x0 + w} {y0}, {x0} {y0 + h}, {x0} {y0}))"
    body = _ring(rng, x0, y0, w, h)
    if rng.random() < 0.3 and w >= 1.5 and h >= 1.5:
        body += ", " + _ring(rng, x0 + 0.5, y0 + 0.5, w - 1.0, h - 1.0)
    return f"({body})"


def _line_body(rng) -> str:
    k = int(rng.integers(2, 5))
    return "(" + ", ".join(_coord(rng) for _ in range(k)) + ")"


def _random_wkt(rng) -> str:
    kind = rng.choice(["POINT", "LINESTRING", "POLYGON", "MULTIPOINT",
                       "MULTILINESTRING", "MULTIPOLYGON"],
                      p=[0.15, 0.25, 0.3, 0.1, 0.1, 0.1])
    if kind == "POINT":
        return f"POINT ({_coord(rng)})"
    if kind == "LINESTRING":
        return "LINESTRING " + _line_body(rng)
    if kind == "POLYGON":
        return "POLYGON " + _polygon_body(rng)
    if kind == "MULTIPOINT":
        return "MULTIPOINT (" + ", ".join(
            f"({_coord(rng)})" for _ in range(int(rng.integers(1, 4)))) + ")"
    if kind == "MULTILINESTRING":
        return "MULTILINESTRING (" + ", ".join(
            _line_body(rng) for _ in range(int(rng.integers(1, 3)))) + ")"
    return "MULTIPOLYGON (" + ", ".join(
        _polygon_body(rng) for _ in range(int(rng.integers(1, 3)))) + ")"


BATTERY_CHUNKS = 12
BATTERY_PAIRS = 50     # 600 pairs in all, each checked both ways


@pytest.mark.parametrize("chunk", range(BATTERY_CHUNKS))
def test_relate_battery_matches_reference(chunk):
    """600 seeded pairs of points, lines, polygons (holes included) and
    multi geometries on a half-unit grid, so shared vertices, shared
    edges and touches are common: relate strings, the named predicates,
    the geometry methods and distances equal both ways."""
    rng = np.random.default_rng(1000 + chunk)
    kinds = set()
    for _ in range(BATTERY_PAIRS):
        wa, wb = _random_wkt(rng), _random_wkt(rng)
        kinds.add(jrelate.relate(jparse_wkt(wa), jparse_wkt(wb))
                  if _outcome(lambda: jrelate.relate(
                      jparse_wkt(wa), jparse_wkt(wb)))[0] == "ok" else "err")
        _check_pair(wa, wb)
        _check_pair(wb, wa)
    # the battery reaches many distinct matrices, not one
    assert len(kinds) >= 10


# -- WKB, GeoJSON and WKT ----------------------------------------------------

CODEC_WKTS = [SQ, DONUT, "POINT (1.5 -2.25)", "LINESTRING (0 0, 1 2, 3 1)",
              "MULTIPOINT ((0 0), (1 1))",
              "MULTILINESTRING ((0 0, 1 1), (2 2, 3 1))",
              "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), "
              "((3 3, 4 3, 4 4, 3 3), (3.2 3.1, 3.8 3.1, 3.8 3.6, 3.2 3.1)))",
              "GEOMETRYCOLLECTION (POINT (1 2), LINESTRING (0 0, 1 1))",
              "LINESTRING EMPTY", "POLYGON EMPTY", "MULTIPOINT EMPTY",
              "GEOMETRYCOLLECTION EMPTY",
              "POINT (-73.98765432101234 40.7123456789012)"]


@pytest.mark.parametrize("wkt", CODEC_WKTS)
def test_wkb_and_geojson_match_reference(wkt):
    """WKB bytes and GeoJSON dicts equal; each package reads the other's
    encoding back to the same geometry; WKT round trips equal."""
    jg, tg = jparse_wkt(wkt), parse_wkt(wkt)
    assert repr(tg) == repr(jg)
    b, jb = _outcome(lambda: twkb.to_wkb(tg)), _outcome(
        lambda: jwkb.to_wkb(jg))
    assert b == jb
    if b[0] == "ok":
        assert _same_geometry(twkb.from_wkb(jb[1]), jwkb.from_wkb(b[1]))
        assert repr(twkb.from_wkb(b[1])) == repr(jwkb.from_wkb(jb[1]))
    d, jd = _outcome(lambda: tgeojson.to_geojson(tg)), _outcome(
        lambda: jgeojson.to_geojson(jg))
    assert d == jd
    if d[0] == "ok":
        assert repr(tgeojson.from_geojson(jd[1])) == \
            repr(jgeojson.from_geojson(d[1]))


# -- the ST_* functions ------------------------------------------------------

ST_UNARY = ["st_area", "st_length", "st_centroid", "st_envelope",
            "st_convex_hull", "st_as_text", "st_num_points",
            "st_exterior_ring", "st_cast_to_point", "st_cast_to_linestring",
            "st_cast_to_polygon", "st_cast_to_geometry", "st_as_binary",
            "st_as_geojson", "st_antimeridian_safe_geom", "st_idl_safe_geom",
            "st_length_spheroid"]
ST_BINARY = ["st_contains", "st_covers", "st_within", "st_intersects",
             "st_disjoint", "st_equals", "st_crosses", "st_overlaps",
             "st_touches", "st_relate", "st_distance", "st_distance_sphere",
             "st_distance_spheroid"]
ST_WKTS = [SQ, DONUT, "LINESTRING (0 0, 3 1, 4 4)", "POINT (2 3)",
           "MULTIPOINT ((0 0), (1 1))",
           "LINESTRING (170 10, -170 12)",
           "POLYGON ((170 0, 190 0, 190 5, 170 5, 170 0))",
           "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((3 3, 4 3, 4 4, 3 3)))"]


def _norm(v):
    """A function's value in a comparable form: geometries as their WKT
    (and type), floats as float, bytes as bytes."""
    if hasattr(v, "geom_type"):
        return ("geom", v.geom_type, repr(v))
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@pytest.mark.parametrize("wkt", ST_WKTS)
def test_st_functions_match_reference(wkt):
    """Every ST_* function (the geohash pair waits for the geohash
    module) gives the same value or the same error. The spheroid and
    sphere distances and lengths run the same float64 operations in the
    same order as the reference, so they are compared exactly too."""
    jg, tg = jparse_wkt(wkt), parse_wkt(wkt)
    for name in ST_UNARY:
        got = _outcome(lambda: _norm(getattr(tst, name)(tg)))
        want = _outcome(lambda: _norm(getattr(jst, name)(jg)))
        assert got == want, name
    for other in ST_WKTS:
        jo, to = jparse_wkt(other), parse_wkt(other)
        for name in ST_BINARY:
            got = _outcome(lambda: _norm(getattr(tst, name)(tg, to)))
            want = _outcome(lambda: _norm(getattr(jst, name)(jg, jo)))
            assert got == want, (name, other)
        assert _outcome(lambda: tst.st_dwithin(tg, to, 1.5)) == \
            _outcome(lambda: jst.st_dwithin(jg, jo, 1.5))
        assert _outcome(lambda: tst.st_relate_bool(tg, to, "T********")) \
            == _outcome(lambda: jst.st_relate_bool(jg, jo, "T********"))
    for d in (0.0, 0.5, 2.0):
        assert _outcome(lambda: _norm(tst.st_buffer(tg, d))) == \
            _outcome(lambda: _norm(jst.st_buffer(jg, d)))
        assert _outcome(lambda: _norm(tst.st_translate(tg, d, -d))) == \
            _outcome(lambda: _norm(jst.st_translate(jg, d, -d)))
    if tg.geom_type == "Point":
        assert _norm(tst.st_buffer_point(tg, 1000.0)) == \
            _norm(jst.st_buffer_point(jg, 1000.0))
    assert _norm(tst.st_closest_point(tg, parse_wkt("POINT (1 5)"))) == \
        _norm(jst.st_closest_point(jg, jparse_wkt("POINT (1 5)")))
    xs, ys = np.linspace(-1, 11, 25), np.linspace(-1, 11, 25)[::-1]
    assert np.array_equal(tst.contains_points(tg, xs, ys),
                          jst.contains_points(jg, xs, ys))
    assert np.array_equal(tst.distance_points(tg, xs, ys),
                          jst.distance_points(jg, xs, ys))


def test_st_scalar_registry_matches_reference():
    """The SQL scalar registry names the same functions, the geohash pair
    included."""
    assert set(tst.SQL_SCALARS) == set(jst.SQL_SCALARS)


# -- ECQL: DWITHIN, the relate operators, BEYOND ------------------------------

def test_beyond_raises_ecqlerror_in_both():
    """BEYOND is in neither grammar: the port raises ECQLError, as the
    JAX parser does."""
    ecql = "BEYOND(geom, POINT(0 0), 10, meters)"
    with pytest.raises(JECQLError) as jexc:
        jparse_ecql(ecql)
    with pytest.raises(ECQLError) as exc:
        parse_ecql(ecql)
    assert type(exc.value).__name__ == type(jexc.value).__name__
    assert str(exc.value) == str(jexc.value)


UNITS = ["meters", "kilometers", "feet", "statute miles", "nautical miles",
         "degrees", "furlongs"]


@pytest.mark.parametrize("units", UNITS)
def test_dwithin_parse_and_degrees_match_reference(units):
    """DWITHIN parses to the same filter in every unit (an unknown unit
    counts as meters in both), and the meters-to-degrees factor equals
    the reference's (the same float64 operations)."""
    ecql = f"DWITHIN(geom, POINT(-73.5 40.25), 1234.5, {units})"
    f, jf = parse_ecql(ecql), jparse_ecql(ecql)
    assert str(f) == str(jf)
    for wkt in ("POINT (-73.5 40.25)", SQ, "LINESTRING (0 -80, 10 89.9)",
                "POINT (0 90)"):
        assert dwithin_degrees(parse_wkt(wkt), 1234.5, units) == \
            jdwithin_degrees(jparse_wkt(wkt), 1234.5, units)
    assert set(METERS_MULTIPLIERS) == set(UNITS) - {"degrees", "furlongs"}


@pytest.mark.parametrize("op", ["INTERSECTS", "DISJOINT", "CONTAINS",
                                "WITHIN", "TOUCHES", "CROSSES", "OVERLAPS",
                                "EQUALS"])
def test_relate_operators_parse_like_reference(op):
    ecql = f"{op}(geom, {DONUT}) AND dtg DURING " \
           f"2020-01-01T00:00:00Z/2020-02-01T00:00:00Z"
    assert str(parse_ecql(ecql)) == str(jparse_ecql(ecql))


# -- the filters on a point schema, through both stores -----------------------

POINT_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


@pytest.fixture(scope="module")
def point_stores():
    """One seeded point store per package: 6,000 points, a quarter on a
    half-unit grid (so boundary and vertex hits occur), 2 % null."""
    rng = np.random.default_rng(7)
    n = 6000
    x = rng.uniform(-8, 8, n)
    y = rng.uniform(-8, 8, n)
    grid = rng.random(n) < 0.25
    x[grid] = rng.integers(-16, 17, grid.sum()) / 2
    y[grid] = rng.integers(-16, 17, grid.sum()) / 2
    x[rng.random(n) < 0.02] = np.nan
    ms = 1_577_836_800_000 + rng.integers(0, 60 * 86_400_000, n)
    ids = [f"p{i}" for i in range(n)]
    data = {"name": [f"n{i % 5}" for i in range(n)], "dtg": ms,
            "geom": (x, y)}
    port, ref = InMemoryDataStore(device="cpu"), JaxStore()
    for s in (port, ref):
        s.create_schema("pts", POINT_SPEC)
        s.write_dict("pts", ids, data)
    return port, ref


POINT_LITERALS = [
    "POINT (1 1)", "POINT (0.5 0.5)", "LINESTRING (-4 -4, 0 0, 4 -4)",
    "LINESTRING (-8 1, 8 1)", SQ, DONUT, "MULTIPOINT ((1 1), (2 2), (0 0.5))",
    "MULTILINESTRING ((0 0, 3 3), (-3 1, -1 1))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((3 3, 4 3, 4 4, 3 3)))",
    "GEOMETRYCOLLECTION (POINT (2 2), POLYGON ((-2 -2, -1 -2, -1 -1, -2 -2)))",
]


@pytest.mark.parametrize("op", ["INTERSECTS", "DISJOINT", "CONTAINS",
                                "WITHIN", "TOUCHES", "CROSSES", "OVERLAPS",
                                "EQUALS"])
def test_relate_operators_on_points_match_reference(point_stores, op):
    """Every relate operator against every kind of literal: ids, counts,
    strategies and costs equal the JAX store's (or both raise alike)."""
    port, ref = point_stores
    for lit in POINT_LITERALS:
        for tail in ("", " AND dtg DURING 2020-01-10T00:00:00Z/"
                         "2020-02-10T00:00:00Z"):
            ecql = f"{op}(geom, {lit}){tail}"
            got = _outcome(lambda: port.query(ecql, "pts"))
            want = _outcome(lambda: ref.query(ecql, "pts"))
            assert got[0] == want[0], (ecql, got, want)
            if got[0] == "err":
                assert got[1] == want[1], ecql
                continue
            g, w = got[1], want[1]
            assert list(g.ids) == list(w.ids), ecql
            assert (g.plan.index, g.plan.cost) == (w.plan.index,
                                                   w.plan.cost), ecql
            assert port.query_count(ecql, "pts") == len(w.ids)


@pytest.mark.parametrize("units", UNITS)
def test_dwithin_on_points_matches_reference(point_stores, units):
    """DWITHIN in every unit, around a point, a line and a polygon, alone
    and with time and an attribute: ids equal the JAX store's."""
    port, ref = point_stores
    dist = {"degrees": 1.5, "kilometers": 150.0, "statute miles": 90.0,
            "nautical miles": 80.0}.get(units, 150_000.0)
    if units == "feet":
        dist = 500_000.0
    for lit in ("POINT (0.5 0.5)", "LINESTRING (-4 -4, 0 0, 4 -4)", SQ,
                "MULTIPOINT ((1 1), (-3 2))"):
        for tail in ("", " AND name = 'n2'",
                     " AND dtg DURING 2020-01-10T00:00:00Z/"
                     "2020-02-10T00:00:00Z"):
            ecql = f"DWITHIN(geom, {lit}, {dist}, {units}){tail}"
            g, w = port.query(ecql, "pts"), ref.query(ecql, "pts")
            assert list(g.ids) == list(w.ids), ecql
            assert (g.plan.index, g.plan.cost) == (w.plan.index,
                                                   w.plan.cost), ecql
            assert len(w.ids) > 0, ecql


def test_dwithin_degrees_widest_arc():
    """The meters-to-degrees factor is the widest eastward arc at the
    envelope's corner latitudes: larger toward the poles."""
    eq = dwithin_degrees(parse_wkt("POINT (0 0)"), 1000.0, "meters")
    north = dwithin_degrees(parse_wkt("POINT (0 60)"), 1000.0, "meters")
    assert north > eq and math.isclose(north / eq, 2.0, rel_tol=0.01)
