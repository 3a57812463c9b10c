"""The port's converters (``convert/``) against the JAX package's on the
same inputs: the cases of tests/test_convert_formats.py (less the CLI's
export) and tests/test_geo_formats.py run in both packages, batches
equal id for id and column for column, and EvaluationContext counters
equal; the transform expressions of TestTransformersParity; the scalar
and the columnar paths on delimited text and JSON with malformed
records, under ``geomesa.ingest.verify``. Nondeterministic functions
(uuid(), now()) compare by form. Tolerance: exact."""

import hashlib
import io
import json
import re
import sqlite3
import sys
import time

import numpy as np
import pytest

from geomesa_tpu.convert import converter_for as jconverter_for
from geomesa_tpu.convert import dsl as jdsl
from geomesa_tpu.convert import enrichment as jenrich
from geomesa_tpu.convert import vectorized as jvec
from geomesa_tpu.convert.avro_reader import AvroFileReader as JAvroReader
from geomesa_tpu.convert.avro_reader import read_avro as jread_avro
from geomesa_tpu.convert.avro_reader import write_avro as jwrite_avro
from geomesa_tpu.convert.avro_writer import write_avro_batch as jwrite_batch
from geomesa_tpu.convert.geo_formats import _polygon_wkt as j_polygon_wkt
from geomesa_tpu.convert.geo_formats import read_shapefile as jread_shp
from geomesa_tpu.features import FeatureBatch as JBatch
from geomesa_tpu.features.sft import parse_spec as jparse
from geomesa_tpu.geometry import to_wkt as jto_wkt
from geomesa_tpu_torch.convert import converter_for
from geomesa_tpu_torch.convert import dsl
from geomesa_tpu_torch.convert import enrichment
from geomesa_tpu_torch.convert import vectorized
from geomesa_tpu_torch.convert.avro_reader import (AvroFileReader, read_avro,
                                                   write_avro)
from geomesa_tpu_torch.convert.avro_writer import write_avro_batch
from geomesa_tpu_torch.convert.geo_formats import (_polygon_wkt,
                                                   read_shapefile)
from geomesa_tpu_torch.features import FeatureBatch
from geomesa_tpu_torch.features.batch import StringColumn
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.geometry import parse_wkt, to_wkt

SPEC = "name:String,age:Integer,*geom:Point"

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_geo_formats import OSM, write_point_shapefile  # noqa: E402


# -- helpers ------------------------------------------------------------------

def _cells(batch, wkt) -> list:
    """(id, every attribute's value) a row; geometries as WKT, points as
    (x, y)."""
    out = []
    cols = [(a.name, a.type.name) for a in batch.sft.attributes]
    for i in range(batch.n):
        row = [str(batch.ids[i])]
        for name, kind in cols:
            c = batch.col(name)
            v = c.value(i)
            if v is not None and kind == "Point":
                v = (v.x, v.y)
            elif v is not None and hasattr(v, "envelope"):
                v = wkt(v)
            elif isinstance(v, (np.generic,)):
                v = v.item()
            row.append(v)
        out.append(tuple(row))
    return out


def _counters(ctx) -> tuple:
    return (ctx.success, ctx.failure, ctx.line)


def _both(spec, config, source, type_name="t"):
    """Run the config through both packages on the same source (a
    callable of the package for file-backed sources)."""
    out = []
    for conv_for, parse, pkg in ((jconverter_for, jparse, "jax"),
                                 (converter_for, parse_spec, "port")):
        conv = conv_for(parse(type_name, spec), config)
        src = source(pkg) if callable(source) else source
        batch, ctx = conv.process(src)
        out.append((batch, ctx))
    (jb, jc), (tb, tc) = out
    assert _cells(tb, to_wkt) == _cells(jb, jto_wkt)
    assert _counters(tc) == _counters(jc)
    return tb, tc


# -- tests/test_convert_formats.py's cases ------------------------------------

XML_CONF = {
    "type": "xml", "feature-path": ".//entry", "id-field": "$1",
    "fields": [
        {"path": "@id"},
        {"name": "name", "path": "name"},
        {"name": "age", "path": "age", "transform": "$3::int"},
        {"name": "geom", "path": "lon",
         "transform": "point($4::double, $5::double)"},
        {"path": "lat"},
    ]}

XML = """<root>
  <entry id="a"><name>alpha</name><age>5</age>
    <lon>1.5</lon><lat>2.5</lat></entry>
  <entry id="b"><name>beta</name><age>7</age>
    <lon>3.5</lon><lat>4.5</lat></entry>
  <entry id="c"><name>gamma</name><age>x</age>
    <lon>3.5</lon><lat>4.5</lat></entry>
</root>"""


@pytest.mark.parametrize("conf,source,ok", [
    (XML_CONF, XML, 2),
    (dict(XML_CONF, **{"id-field": "concat('x', $1)"}), XML, 2),
    (XML_CONF, "<not-closed>", 0),
])
def test_xml(conf, source, ok):
    batch, ctx = _both(SPEC, conf, source)
    assert ctx.success == ok


AVRO_SCHEMA = {"type": "record", "name": "obs", "fields": [
    {"name": "name", "type": "string"},
    {"name": "age", "type": "long"},
    {"name": "pos", "type": {"type": "record", "name": "p", "fields": [
        {"name": "lon", "type": "double"},
        {"name": "lat", "type": "double"}]}},
    {"name": "tag", "type": ["null", "string"]},
]}
AVRO_RECORDS = [
    {"name": "alpha", "age": 5, "pos": {"lon": 1.5, "lat": 2.5}, "tag": "x"},
    {"name": "beta", "age": -7, "pos": {"lon": 3.5, "lat": 4.5},
     "tag": None},
]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_files_equal_and_read_across(codec):
    data = write_avro(AVRO_SCHEMA, AVRO_RECORDS, codec=codec)
    jdata = jwrite_avro(AVRO_SCHEMA, AVRO_RECORDS, codec=codec)
    # the sync marker is random: equal past it, and each reads the other
    assert list(AvroFileReader(jdata)) == list(JAvroReader(data)) \
        == AVRO_RECORDS
    assert read_avro(jdata)[0] == jread_avro(data)[0]


def test_avro_zigzag_longs():
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "v", "type": "long"}]}
    vals = [{"v": v} for v in (0, -1, 1, -2**40, 2**40, 2**62, -2**63)]
    assert list(AvroFileReader(write_avro(schema, vals))) == vals
    assert list(JAvroReader(write_avro(schema, vals))) == vals


def test_avro_converter():
    data = jwrite_avro(AVRO_SCHEMA, AVRO_RECORDS)
    batch, ctx = _both(SPEC, {
        "type": "avro", "id-field": "$1",
        "fields": [
            {"path": "name"},
            {"name": "name", "path": "name"},
            {"name": "age", "path": "age", "transform": "$3::int"},
            {"name": "geom", "path": "pos.lon",
             "transform": "point($4::double, $5::double)"},
            {"path": "pos.lat"},
        ]}, data)
    assert ctx.success == 2 and batch.col("geom").y[0] == 2.5


def test_fixed_width():
    batch, ctx = _both(SPEC, {
        "type": "fixed-width", "id-field": "$1",
        "fields": [
            {"name": "name", "start": 0, "width": 6},
            {"name": "age", "start": 6, "width": 4, "transform": "$2::int"},
            {"name": "geom", "start": 10, "width": 8,
             "transform": "point($3::double, $4::double)"},
            {"start": 18, "width": 8},
        ]}, ("alpha 5   1.50    2.50\n"
             "beta  7   3.50    4.50\n"
             "bad   z   3.50    4.50\n"))
    assert ctx.success == 2 and ctx.failure == 1


def test_composite_dispatch():
    conf = {"type": "composite", "converters": [
        {"predicate": "^J", "type": "delimited-text", "id-field": "$2",
         "fields": [
             {"name": "name", "transform": "$3"},
             {"name": "age", "transform": "$4::int"},
             {"name": "geom",
              "transform": "point($5::double, $6::double)"}]},
        {"predicate": ".*", "type": "delimited-text", "id-field": "$1",
         "fields": [
             {"name": "name", "transform": "$2"},
             {"name": "age", "transform": "$3::int"},
             {"name": "geom",
              "transform": "point($4::double, $5::double)"}]},
    ]}
    batch, ctx = _both(SPEC, conf, ("J,j1,alpha,5,1.0,2.0\n"
                                    "p1,beta,7,3.0,4.0\n"
                                    "p2,beta,x,3.0,4.0\n"))
    assert set(batch.ids) == {"j1", "p1"} and ctx.failure == 1


def _delimited(validators, geom_transform):
    return {"type": "delimited-text", "id-field": "$1",
            "options": {"validators": validators},
            "fields": [
                {"name": "name", "transform": "$1"},
                {"name": "age", "transform": "$2::int"},
                {"name": "geom", "transform": geom_transform}]}


@pytest.mark.parametrize("validators,geom,text,ok", [
    (["has-geo"], "try(point($3::double, $4::double), null)",
     "a,1,1.0,2.0\nb,2,,\n", 1),
    (["bounds-geo"], "point($3::double, $4::double)",
     "a,1,1.0,2.0\nb,2,500.0,2.0\n", 1),
    # the index validator checks a date too: this schema has none
    (["index"], "try(point($3::double, $4::double), null)",
     "a,1,1.0,2.0\nb,2,500.0,2.0\nc,3,,\n", 0),
    (["none"], "point($3::double, $4::double)",
     "a,1,1.0,2.0\nb,2,500.0,2.0\n", 2),
])
def test_validators(validators, geom, text, ok):
    batch, ctx = _both(SPEC, _delimited(validators, geom), text)
    assert ctx.success == ok


def test_unknown_validator_raises_in_both():
    conf = _delimited(["bogus"], "point($3::double, $4::double)")
    with pytest.raises(ValueError):
        jconverter_for(jparse("t", SPEC), conf)
    with pytest.raises(ValueError):
        converter_for(parse_spec("t", SPEC), conf)


def test_enrichment_cache_lookup():
    for mod in (jenrich, enrichment):
        mod.clear_caches()
        mod.register_cache("vessels", {"alpha": {"flag": "US"},
                                       "beta": {"flag": "NO"}})
    try:
        batch, _ = _both(SPEC, {
            "type": "delimited-text", "id-field": "$1",
            "fields": [
                {"name": "name",
                 "transform": "cacheLookup('vessels', $1, 'flag')"},
                {"name": "age", "transform": "$2::int"},
                {"name": "geom",
                 "transform": "point($3::double, $4::double)"}]},
            "alpha,1,1.0,2.0\nbeta,2,3.0,4.0\ngamma,3,1,1\n")
        assert [batch.col("name").value(i) for i in range(3)] == \
            ["US", "NO", None]
    finally:
        for mod in (jenrich, enrichment):
            mod.clear_caches()


def test_enrichment_csv_cache(tmp_path):
    p = tmp_path / "c.csv"
    p.write_text("id,flag,kind\n1,US,cargo\n2,NO,tanker\n")
    try:
        a = jenrich.load_csv_cache("ships", str(p), "id")
        b = enrichment.load_csv_cache("ships", str(p), "id")
        for key in ("1", "2", "3"):
            assert a.lookup(key) == b.lookup(key)
            assert a.lookup(key, "kind") == b.lookup(key, "kind")
        assert len(a) == len(b) == 2
        assert enrichment.cache_lookup("ships", 2, "flag") == "NO"
    finally:
        for mod in (jenrich, enrichment):
            mod.clear_caches()


AVRO_SPEC = ("name:String,age:Integer,score:Double,dtg:Date,"
             "*geom:Point:srid=4326")
AVRO_DATA = {"name": ["x", None], "age": [3, 7], "score": [1.5, -2.25],
             "dtg": [1_600_000_000_000, 1_600_000_100_000],
             "geom": ["POINT (1 2)", "POINT (-3.5 4.5)"]}


def test_avro_writer_records_equal():
    data = write_avro_batch(parse_spec("t", AVRO_SPEC), FeatureBatch.from_dict(
        parse_spec("t", AVRO_SPEC), ["a", "b"], AVRO_DATA))
    jdata = jwrite_batch(jparse("t", AVRO_SPEC), JBatch.from_dict(
        jparse("t", AVRO_SPEC), ["a", "b"], AVRO_DATA))
    (s1, r1), (s2, r2) = read_avro(data), jread_avro(jdata)
    assert s1 == s2 and r1 == r2
    assert r1[0]["__fid__"] == "a" and r1[1]["name"] is None
    assert r1[1]["geom"] == "POINT (-3.5 4.5)"
    assert jread_avro(data)[1] == r1


# -- the DSL: TestTransformersParity's expressions ----------------------------

DSL_CASES = [
    ("regexReplace('foo'::r, 'bar', 'foobaz')", None, None),
    ("regexReplace('\\d+'::r, 'N', 'a1b22c')", None, None),
    ("regexExtract('id=(\\d+)'::r, 'x id=42 y')", None, None),
    ("regexExtract('(a+)(b+)', 'caabbd', 2)", None, None),
    ("regexExtract('zz', 'abc')", None, None),
    ("regexExtract('abc', 'xabcy')", None, None),
    ("add(trim($1)::int, $3::int)", [None, "  7 ", "points", "3"], None),
    ("concat(uppercase($2), '-', trim($1))", [None, "  7 ", "points", "3"],
     None),
    ("concat($greeting, ' ', $1)", [None, "world"], {"greeting": "hello"}),
    ("isodate('20170101')", None, None),
    ("basicDateTimeNoMillis('20170101T000000Z')", None, None),
    ("dateHourMinuteSecondMillis('2017-01-01T00:00:00.000')", None, None),
    ("datetime('2017-01-01T00:00:00Z')", None, None),
    ("dateToString('yyyy-MM-dd', 1483228800000)", None, None),
    ("dateToString('HH:mm:ss.SSS', 1483228800123)", None, None),
    ("secsToDate(1483228800)", None, None),
    ("millisToDate(1483228800123)", None, None),
    ("md5(stringToBytes('row'))", None, None),
    ("base64('abc')", None, None),
    ("murmur3_64('abc')", None, None),
    ("murmur3_32('abc')", None, None),
    ("mean(1, 2, 3, 6)", None, None),
    ("subtract(10, 3, 2)", None, None),
    ("divide(100, 5, 2)", None, None),
    ("multiply(2, 3.5)", None, None),
    ("min(4, -2, 9)", None, None),
    ("max(4, -2, 9)", None, None),
    ("parseList('int', '1,2,3')", None, None),
    ("parseMap('int', 'a->1,b->2')", None, None),
    ("listItem(list('x', 'y'), 1)", None, None),
    ("mapValue(parseMap('string', 'a->x'), 'a')", None, None),
    ("stripQuotes('''quoted''')", None, None),
    ("capitalize('hello')", None, None),
    ("emptyToNull('  ')", None, None),
    ("mkstring('-', 'a', 'b', 'c')", None, None),
    ("stringToInt('42')", None, None),
    ("stringToInt('x', 7)", None, None),
    ("stringToDouble('2.5')", None, None),
    ("stringToBoolean('garbage', 'true'::boolean)", None, None),
    ("stringToBoolean('no')", None, None),
    ("substring('abcdef', 1, 3)", None, None),
    ("length('abcdef')", None, None),
    ("stripPrefix('xxabc', 'x')", None, None),
    ("try($1::int, 0)", [None, "nan-ish"], None),
    ("withDefault($1, 'd')", [None, ""], None),
    ("linestring('0 0, 1 1, 2 0')", None, None),
    ("polygon('0 0, 4 0, 4 4, 0 4, 0 0')", None, None),
    ("multilinestring('0 0, 1 1')", None, None),
    ("point(1.5, -2.25)", None, None),
    ("geometry('POINT (3 4)')", None, None),
    ("'abc'::string", None, None),
    ("'12'::long", None, None),
    ("'1.5'::double", None, None),
]


def _norm(v):
    if hasattr(v, "envelope"):
        return ("geom", to_wkt(v) if type(v).__module__.startswith(
            "geomesa_tpu_torch") else jto_wkt(v))
    if isinstance(v, re.Pattern):
        return ("re", v.pattern)
    return v


@pytest.mark.parametrize("text,cols,fields", DSL_CASES)
def test_dsl_expressions_equal(text, cols, fields):
    got = dsl.compile_expression(text)(cols or [None], fields)
    want = jdsl.compile_expression(text)(cols or [None], fields)
    assert _norm(got) == _norm(want)
    assert dsl.parse_expression(text) == jdsl.parse_expression(text)


@pytest.mark.parametrize("text,cols", [
    ("$missing", [None]),
    ("regexExtract('abc', 'xabcy', 2)", [None]),
    ("geometrycollection('0 0')", [None]),
    ("$1::int", [None, "x"]),
])
def test_dsl_errors_raise_in_both(text, cols):
    kinds = set()
    for mod in (jdsl, dsl):
        with pytest.raises(Exception) as e:
            mod.compile_expression(text)(cols, {})
        kinds.add(type(e.value).__name__)
    assert len(kinds) == 1


def test_hash_vectors():
    for mod in (jdsl, dsl):
        assert mod.murmur3_32(b"") == 0
        assert mod.murmur3_32(b"hello") == 0x248BFA47
        assert mod.murmur3_32(
            b"The quick brown fox jumps over the lazy dog") == 0x2E4FF723
        assert mod.murmur3_128(b"hello") == (0xCBD8A7B341BD9B02,
                                              0x5B1E906A48AE1D19)


def test_nondeterministic_functions_by_form():
    u = dsl.compile_expression("uuid()")([None], {})
    ju = jdsl.compile_expression("uuid()")([None], {})
    shape = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-"
                       r"[0-9a-f]{4}-[0-9a-f]{12}$")
    assert shape.match(u) and shape.match(ju) and u != ju
    t0 = int(time.time() * 1000)
    now = dsl.compile_expression("now()")([None], {})
    jnow = jdsl.compile_expression("now()")([None], {})
    t1 = int(time.time() * 1000)
    assert type(now) is type(jnow)
    assert t0 - 1000 <= int(now) <= t1 + 1000


def test_converter_field_chain():
    conf = {"type": "delimited-text", "id-field": "md5($fullname)",
            "fields": [
                {"name": "first", "transform": "trim($1)"},
                {"name": "fullname",
                 "transform": "concat($first, '_', lowercase($2))"},
                {"name": "name", "transform": "uppercase($fullname)"},
                {"name": "geom",
                 "transform": "point($3::double, $4::double)"}]}
    batch, ctx = _both("name:String,*geom:Point:srid=4326", conf,
                       " Ann ,SMITH,10,20\n")
    assert ctx.success == 1
    assert batch.ids[0] == hashlib.md5(b"Ann_smith").hexdigest()


def test_json_bad_record_counts_as_failure():
    lines = "\n".join([json.dumps({"items": [1, 2, 3]}),
                       json.dumps({"items": [1]}), "{not json"])
    _, ctx = _both("v:Integer,*geom:Point", {
        "type": "json", "id-field": "md5($0)",
        "fields": [
            {"name": "v", "path": "$.items.2"},
            {"name": "geom",
             "transform": "point(0.0::double, 0.0::double)"},
        ]}, lines)
    assert ctx.success == 1 and ctx.failure == 2


# -- tests/test_geo_formats.py's cases ----------------------------------------

def test_shapefile_rows(tmp_path):
    shp = str(tmp_path / "pts.shp")
    write_point_shapefile(shp, [(10.5, 20.25), (-30.0, 45.5)],
                          [("alpha", 7), ("beta", 42)])
    assert list(read_shapefile(shp)) == list(jread_shp(shp))


def test_shapefile_converter(tmp_path):
    shp = str(tmp_path / "pts.shp")
    write_point_shapefile(shp, [(1.0, 2.0), (3.0, 4.0)],
                          [("a", 1), ("b", 2)])
    batch, ctx = _both("name:String,size:Integer,*geom:Point", {
        "type": "shapefile", "id-field": "$2",
        "fields": [
            {"name": "name", "transform": "$2"},
            {"name": "size", "transform": "$3::int"},
            {"name": "geom", "transform": "geometry($1)"},
        ]}, shp)
    assert ctx.success == 2 and batch.ids.tolist() == ["a", "b"]


def test_polygon_wkt_grouping():
    outer = [(0, 0), (0, 10), (10, 10), (10, 0), (0, 0)]
    hole = [(2, 2), (4, 2), (4, 4), (2, 4), (2, 2)]
    second = [(20, 20), (20, 30), (30, 30), (30, 20), (20, 20)]
    for rings in ([outer, hole], [outer, hole, second], [hole]):
        assert _polygon_wkt(rings) == j_polygon_wkt(rings)
    g = parse_wkt(_polygon_wkt([outer, hole]))
    assert g.contains_points(np.array([1.0]), np.array([1.0]))[0]
    assert not g.contains_points(np.array([3.0]), np.array([3.0]))[0]


def test_jdbc_query_ingest(tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE obs (name TEXT, lon REAL, lat REAL)")
    conn.executemany("INSERT INTO obs VALUES (?,?,?)",
                     [("x", 1.0, 2.0), ("y", 3.0, 4.0), ("z", None, 1.0)])
    conn.commit()
    conn.close()
    batch, ctx = _both("name:String,*geom:Point", {
        "type": "jdbc",
        "query": "SELECT name, lon, lat FROM obs ORDER BY name",
        "id-field": "$1",
        "fields": [
            {"name": "name", "transform": "$1"},
            {"name": "geom", "transform": "point($2::double, $3::double)"},
        ]}, db)
    assert ctx.success == 2 and batch.col("geom").y.tolist() == [2.0, 4.0]


def test_osm_nodes_and_ways():
    batch, ctx = _both("kind:String,name:String,*geom:Geometry", {
        "type": "osm", "id-field": "concat($2, '/', $1)",
        "fields": [
            {"name": "kind", "transform": "$2"},
            {"name": "name", "transform": "mapValue($0, 'name')"},
            {"name": "geom", "transform": "geometry($3)"},
        ]}, OSM)
    assert ctx.success == 4
    feats = {batch.ids[i]: batch.feature(i) for i in range(batch.n)}
    assert feats["node/1"]["name"] == "stop-a"
    assert feats["way/10"]["geom"].envelope.xmax == 8.8


# -- the columnar path against the scalar one ---------------------------------

AIS_SPEC = ("name:String,mmsi:Integer,dtg:Date,speed:Double,"
            "course:Double,heading:Double,*geom:Point:srid=4326")
AIS_CSV = {"type": "delimited-text", "format": "CSV",
           "id-field": "concat('v', $2)",
           "fields": [
               {"name": "name", "transform": "$1"},
               {"name": "mmsi", "transform": "$2::int"},
               {"name": "dtg", "transform": "isoDate($3)"},
               {"name": "geom",
                "transform": "point($4::double, $5::double)"},
               {"name": "speed", "transform": "$6::double"},
               {"name": "course", "transform": "$7::double"},
               {"name": "heading", "transform": "$8::double"}]}


def ais_csv(seed: int, rows: int, bad_every: int = 0, quote_at=None) -> str:
    """bench.py config 16's CSV; every bad_every-th line malformed in
    one of five ways, and a quoted field at line quote_at."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, rows), rng.uniform(-90, 90, rows)
    day, hh = rng.integers(1, 28, rows), rng.integers(0, 24, rows)
    spd, crs = rng.uniform(0, 30, rows), rng.uniform(0, 360, rows)
    lines = []
    for i in range(rows):
        line = (f"vessel{i % 5000},{i},2017-03-{day[i]:02d}T{hh[i]:02d}"
                f":15:00Z,{x[i]:.5f},{y[i]:.5f},{spd[i]:.2f},{crs[i]:.2f},"
                f"{crs[i]:.1f}")
        if bad_every and i % bad_every == bad_every - 1:
            line = [line.replace(f",{x[i]:.5f},", ",east,"),
                    line.rsplit(",", 2)[0],
                    line.replace("2017-03-", "2017-13-"),
                    line + ",extra",
                    line.replace(f",{i},", ",12x,")][(i // bad_every) % 5]
        if quote_at is not None and i == quote_at:
            line = line.replace(f"vessel{i % 5000}", f'"vessel, {i}"')
        lines.append(line)
    return "\n".join(lines) + "\n"


def _run(conv_for, parse, mod, text, rows, vectorized, verify="false"):
    """iter_batches over the CSV under the package's ingest properties:
    (batches, the cumulative context)."""
    conv = conv_for(parse("ais16", AIS_SPEC), AIS_CSV)
    mod.INGEST_VECTORIZED.set("true" if vectorized else "false")
    mod.INGEST_VERIFY.set(verify)
    try:
        out = list(conv.iter_batches(io.StringIO(text), batch_rows=rows))
    finally:
        mod.INGEST_VECTORIZED.set(None)
        mod.INGEST_VERIFY.set(None)
    return [b for b, _ in out], out[-1][1]


def _flat(batches, wkt):
    return [r for b in batches for r in _cells(b, wkt)]


@pytest.mark.parametrize("rows,bad_every,quote_at", [
    (257, 0, None), (512, 13, None), (1000, 7, 600), (64, 3, 0)])
def test_columnar_equals_scalar_across_packages(rows, bad_every, quote_at):
    text = ais_csv(rows, 3000, bad_every, quote_at)
    got = {}
    for pkg, conv_for, parse, mod, wkt in (
            ("jax", jconverter_for, jparse, jvec, jto_wkt),
            ("port", converter_for, parse_spec, vectorized, to_wkt)):
        for vec in (True, False):
            batches, ctx = _run(conv_for, parse, mod, text, rows, vec)
            got[(pkg, vec)] = (_flat(batches, wkt), _counters(ctx))
    want = got[("jax", False)]
    assert want[1][0] > 0
    if bad_every:
        assert want[1][1] > 0
    for key, val in got.items():
        assert val == want, key


def test_port_paths_equal_under_verify():
    """geomesa.ingest.verify runs both paths a chunk and raises on an id
    divergence; the chunks it yields equal the scalar path's."""
    text = ais_csv(5, 2000, 9, 1500)
    ver, vctx = _run(converter_for, parse_spec, vectorized, text, 300, True,
                     verify="true")
    sca, sctx = _run(converter_for, parse_spec, vectorized, text, 300, False)
    assert _flat(ver, to_wkt) == _flat(sca, to_wkt)
    assert _counters(vctx) == _counters(sctx)
    assert sctx.failure > 0


def test_columnar_json_equals_scalar():
    rng = np.random.default_rng(2)
    recs = []
    for i in range(400):
        r = {"id": f"j{i}", "pos": {"lon": float(rng.uniform(-180, 180)),
                                    "lat": float(rng.uniform(-90, 90))},
             "age": int(rng.integers(0, 90)), "name": f"n{i % 13}"}
        recs.append(json.dumps(r))
    recs[17] = "{broken"
    recs[40] = json.dumps({"id": "j40", "pos": {"lon": "x", "lat": 1.0},
                           "age": 3, "name": "n"})
    text = "\n".join(recs)
    conf = {"type": "json", "id-field": "$1",
            "fields": [{"path": "$.id"},
                       {"name": "name", "path": "$.name"},
                       {"name": "age", "path": "$.age",
                        "transform": "$3::int"},
                       {"name": "geom", "path": "$.pos.lon",
                        "transform": "point($4::double, $5::double)"},
                       {"path": "$.pos.lat"}]}
    got = {}
    for pkg, conv_for, parse, mod, wkt in (
            ("jax", jconverter_for, jparse, jvec, jto_wkt),
            ("port", converter_for, parse_spec, vectorized, to_wkt)):
        for vec in ("true", "false"):
            mod.INGEST_VECTORIZED.set(vec)
            try:
                conv = conv_for(parse("t", SPEC), conf)
                out = list(conv.iter_batches(text, batch_rows=128))
            finally:
                mod.INGEST_VECTORIZED.set(None)
            got[(pkg, vec)] = (_flat([b for b, _ in out], wkt),
                               _counters(out[-1][1]))
    want = got[("jax", "false")]
    assert want[1][1] == 2
    for key, val in got.items():
        assert val == want, key


# -- the Arrow string path of the column builder ------------------------------

@pytest.mark.parametrize("values", [
    ["b", "a", "b", "c", "a", "é", "Z", ""],
    ["only"] * 5,
    [],
    ["x", None, "y", None],
    [f"v{i % 37}" for i in range(1000)],
])
def test_arrow_string_column_equals_from_strings(values):
    import pyarrow as pa
    want = StringColumn.from_strings("s", values)
    arrays = [pa.array(values, type=pa.string()),
              pa.chunked_array([pa.array(values[:3], type=pa.string()),
                                pa.array(values[3:], type=pa.string())]),
              pa.array(values, type=pa.string()).dictionary_encode(),
              pa.array(values, type=pa.large_string())]
    sft = parse_spec("t", "s:String,*geom:Point")
    for arr in arrays:
        got = FeatureBatch.from_dict(sft, [str(i) for i in range(len(values))],
                                     {"s": arr, "geom": (np.zeros(len(values)),
                                                         np.zeros(len(values)))})
        col = got.col("s")
        assert col.vocab.tolist() == want.vocab.tolist()
        assert col.codes.tolist() == want.codes.tolist()
    # the JAX builder on the same Arrow array
    jb = JBatch.from_dict(jparse("t", "s:String,*geom:Point"),
                          [str(i) for i in range(len(values))],
                          {"s": pa.array(values, type=pa.string()),
                           "geom": (np.zeros(len(values)),
                                    np.zeros(len(values)))})
    assert [jb.col("s").value(i) for i in range(len(values))] == \
        [want.value(i) for i in range(len(values))]


@pytest.mark.parametrize("case", ["unused", "duplicates", "chunks",
                                  "parquet", "empty", "null_entry"])
def test_dictionary_string_column_equals_from_strings(tmp_path, case):
    """A dictionary-encoded Arrow column (the port's own Parquet files
    store strings so) builds by its indices: the vocabulary and codes
    equal ``from_strings``' on the decoded values, and the JAX
    package's ``from_arrow`` reads the same values."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(8)
    idx = pa.array(rng.integers(0, 5, 300).astype(np.int32))
    if case == "unused":        # entries 'zz' and 'q' used by no row
        arr = pa.DictionaryArray.from_arrays(
            pa.array(np.asarray(idx) % 3), ["b", "zz", "é", "q", ""])
    elif case == "duplicates":  # one value under two entries
        arr = pa.DictionaryArray.from_arrays(idx, ["b", "a", "b", "", "a"])
    elif case == "chunks":      # a dictionary a chunk
        arr = pa.chunked_array([
            pa.DictionaryArray.from_arrays(idx, ["v", "w", "x", "y", "z"]),
            pa.DictionaryArray.from_arrays(idx, ["z", "y", "a", "b", "c"])])
    elif case == "parquet":
        values = [f"v{i}" for i in rng.integers(0, 40, 2000)]
        path = str(tmp_path / "s.parquet")
        pq.write_table(pa.table({"s": pa.array(values).dictionary_encode()}),
                       path)
        arr = pq.read_table(path).column("s")
        assert pa.types.is_dictionary(arr.type)
    elif case == "empty":
        arr = pa.DictionaryArray.from_arrays(pa.array([], pa.int32()),
                                             ["a", "b"])
    else:                       # a null entry: decoded, not by indices
        arr = pa.DictionaryArray.from_arrays(idx, ["a", None, "c", "d", "e"])
    values = arr.to_pylist()
    want = StringColumn.from_strings("s", values)
    n = len(values)
    got = FeatureBatch.from_dict(
        parse_spec("t", "s:String,*geom:Point"), [str(i) for i in range(n)],
        {"s": arr, "geom": (np.zeros(n), np.zeros(n))}).col("s")
    assert got.vocab.tolist() == want.vocab.tolist()
    assert got.codes.tolist() == want.codes.tolist()
    assert got.codes.dtype == np.int32
    jcol = JBatch.from_dict(
        jparse("t", "s:String,*geom:Point"), [str(i) for i in range(n)],
        {"s": arr.to_pylist(), "geom": (np.zeros(n), np.zeros(n))}).col("s")
    assert [got.value(i) for i in range(n)] == \
        [jcol.value(i) for i in range(n)]


def test_from_arrow_equals_the_reference():
    """FeatureBatch.from_arrow of one record batch in both packages:
    every column's values and validity equal (strings through the Arrow
    path, numbers without nulls through numpy)."""
    spec = ("name:String,n:Integer,big:Long,f:Float,d:Double,ok:Boolean,"
            "dtg:Date,*geom:Point")
    rng = np.random.default_rng(4)
    n = 500
    data = {"name": [None if i % 9 == 0 else f"n{i % 17}" for i in range(n)],
            "n": [None if i % 11 == 0 else int(v)
                  for i, v in enumerate(rng.integers(-9, 9, n))],
            "big": rng.integers(-2**62, 2**62, n),
            "f": rng.normal(size=n), "d": np.where(rng.random(n) < 0.1,
                                                    np.nan, rng.normal(size=n)),
            "ok": rng.random(n) < 0.5,
            "dtg": rng.integers(0, 10**12, n),
            "geom": (rng.uniform(-1, 1, n), rng.uniform(-1, 1, n))}
    ids = [f"r{i}" for i in range(n)]
    jb = JBatch.from_dict(jparse("t", spec), ids, data)
    rb = jb.to_arrow()
    got = FeatureBatch.from_arrow(parse_spec("t", spec), rb)
    want = JBatch.from_arrow(jparse("t", spec), rb)
    assert _cells(got, to_wkt) == _cells(want, jto_wkt)
    for a in ("n", "big", "f", "d", "ok"):
        assert got.col(a).valid.tolist() == want.col(a).valid.tolist()
        assert got.col(a).values.dtype == want.col(a).values.dtype
