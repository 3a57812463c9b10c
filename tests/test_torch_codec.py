"""The port's SFB codec (geomesa_tpu_torch/features/codec.py, with its
native encoder native/src/feature_codec.cpp) against its plain twins and
the JAX package's codec, on the same seeded batches, on the CPU: blob
bytes and row offsets over every column type with nulls and geometries,
the column extracts, lazy single-attribute reads, single features with
List, Map and Bytes values, and collection-typed schemas in the store.

Tolerance: exact everywhere (bytes, values and NaN bit patterns)."""

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JaxBatch
from geomesa_tpu.features.codec import FeatureCodec as JaxCodec
from geomesa_tpu.features.codec import _BytesColumn as JaxBytesColumn
from geomesa_tpu.features.sft import parse_spec as jax_parse_spec
from geomesa_tpu.geometry import parse_wkt as jax_parse_wkt
from geomesa_tpu.store.memory import InMemoryDataStore as JaxStore
from geomesa_tpu_torch import InMemoryDataStore, native
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.codec import (EncodedBatch, FeatureCodec,
                                              LazyFeature, _BytesColumn)
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.geometry import parse_wkt

ALL_TYPES = ("name:String,uid:UUID,age:Integer,seen:Long,f:Float,w:Double,"
             "ok:Boolean,dtg:Date,line:LineString,poly:Polygon,"
             "mp:MultiPolygon,any:Geometry,*geom:Point:srid=4326")
POINT_ONLY = "dtg:Date,*geom:Point:srid=4326"
NO_GEOM = "kind:String,val:Integer,dtg:Date"
SPECS = {"all": ALL_TYPES, "point": POINT_ONLY, "no_geom": NO_GEOM,
         # nine attributes: the null bitmap takes two bytes
         "wide": ("a:Integer,b:Integer,c:Integer,d:Integer,e:Integer,"
                  "f:Integer,g:Integer,h:Integer,*geom:Point")}


def _wkts(rng, n, kind):
    out = []
    for i in range(n):
        if rng.random() < 0.2:
            out.append(None)
            continue
        x, y = rng.uniform(-170, 170), rng.uniform(-80, 80)
        d = rng.uniform(0.01, 5)
        if kind == "line" or (kind == "any" and i % 3 == 0):
            out.append(f"LINESTRING ({x} {y}, {x + d} {y + d / 2}, "
                       f"{x + 2 * d} {y})")
        elif kind == "mp":
            out.append(f"MULTIPOLYGON ((({x} {y}, {x + d} {y}, {x + d} "
                       f"{y + d}, {x} {y})), (({x + 2 * d} {y}, "
                       f"{x + 3 * d} {y}, {x + 3 * d} {y + d}, "
                       f"{x + 2 * d} {y})))")
        elif kind == "any" and i % 3 == 1:
            out.append(f"POINT ({x} {y})")
        else:
            out.append(f"POLYGON (({x} {y}, {x + d} {y}, {x + d} {y + d}, "
                       f"{x} {y + d}, {x} {y}), ({x + d / 4} {y + d / 4}, "
                       f"{x + d / 2} {y + d / 4}, {x + d / 2} {y + d / 2}, "
                       f"{x + d / 4} {y + d / 4}))")
    return out


def _data(spec_key, n, seed):
    """Column inputs for a spec: about a fifth of each column null,
    non-ASCII strings, extreme numbers."""
    rng = np.random.default_rng(seed)
    null = rng.random((16, n)) < 0.2

    def opt(k, vals):
        return [None if null[k, i] else v for i, v in enumerate(vals)]
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[null[0]] = np.nan
    y[null[0]] = np.nan
    if spec_key == "point":
        return {"dtg": rng.integers(0, 2 * 10**12, n), "geom": (x, y)}
    if spec_key == "no_geom":
        return {"kind": opt(1, [f"k{i % 7}é" for i in range(n)]),
                "val": opt(2, rng.integers(-2**31, 2**31, n).tolist()),
                "dtg": rng.integers(-10**12, 10**12, n)}
    if spec_key == "wide":
        out = {c: opt(k, rng.integers(-50, 50, n).tolist())
               for k, c in enumerate("abcdefgh")}
        out["geom"] = (x, y)
        return out
    seen = rng.integers(-2**62, 2**62, n).tolist()
    if n:
        seen[0] = -2**63
    return {
        "name": opt(1, [f"näme-{i % 5}" if i % 3 else "" for i in range(n)]),
        "uid": opt(2, [f"123e4567-e89b-12d3-a456-{i:012d}" for i in range(n)]),
        "age": opt(3, rng.integers(-2**31, 2**31, n).tolist()),
        "seen": opt(4, seen),
        "f": opt(5, rng.uniform(-1e30, 1e30, n).astype(np.float32)
                 .astype(np.float64).tolist()),
        "w": opt(6, rng.normal(0, 1e300, n).tolist()),
        "ok": opt(7, [bool(i % 2) for i in range(n)]),
        "dtg": rng.integers(-10**12, 10**12, n),
        "line": _wkts(rng, n, "line"),
        "poly": _wkts(rng, n, "poly"),
        "mp": _wkts(rng, n, "mp"),
        "any": _wkts(rng, n, "any"),
        "geom": (x, y)}


def _batches(spec_key, n, seed):
    spec = SPECS[spec_key]
    data = _data(spec_key, n, seed)
    ids = [f"fid-{seed}-{i}" for i in range(n)]
    return (FeatureBatch.from_dict(parse_spec("t", spec), ids, data),
            JaxBatch.from_dict(jax_parse_spec("t", spec), ids, data))


def _cell(v):
    """A value as comparable plain data (geometries as WKT)."""
    if v is None or isinstance(v, (str, bytes, bool, int)):
        return v
    if isinstance(v, (float, np.floating)):
        return np.float64(v).tobytes()
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return str(v)


def _rows(batch):
    return [{k: _cell(v) for k, v in batch.feature(i).items()}
            for i in range(batch.n)]


CASES = [(k, n, s) for k in SPECS for n, s in ((1, 1), (37, 2), (300, 3))]


@pytest.mark.parametrize("spec_key,n,seed", CASES)
def test_blob_equals_plain_and_reference(spec_key, n, seed):
    """Native and plain encodes give the JAX codec's blob and offsets."""
    batch, jbatch = _batches(spec_key, n, seed)
    codec = FeatureCodec(batch.sft)
    got = codec.encode_batch(batch)
    plain = codec.encode_batch_plain(batch)
    want = JaxCodec(jbatch.sft, use_native=False).encode_batch(jbatch)
    assert got.blob == plain.blob == want.blob
    assert got.row_offsets.dtype == np.int64
    assert np.array_equal(got.row_offsets, want.row_offsets)
    assert np.array_equal(plain.row_offsets, want.row_offsets)
    assert list(got.ids) == list(want.ids)


@pytest.mark.parametrize("spec_key,n,seed", CASES)
def test_decode_equals_plain_and_reference(spec_key, n, seed):
    """The native extracts equal the plain ones and the JAX decode of
    the same blob, row for row; decode(encode(b)) is b."""
    batch, jbatch = _batches(spec_key, n, seed)
    codec = FeatureCodec(batch.sft)
    enc = codec.encode_batch(batch)
    got = codec.decode_batch(enc)
    assert _rows(got) == _rows(codec.decode_batch_plain(enc)) == _rows(batch)
    jenc = JaxCodec(jbatch.sft, use_native=False).encode_batch(jbatch)
    want = JaxCodec(jbatch.sft, use_native=False).decode_batch(jenc)
    # the JAX decode of the port's blob, the port's decode of the JAX one
    assert _rows(got) == _rows(want)
    assert _rows(codec.decode_batch(EncodedBatch(jenc.blob, jenc.row_offsets,
                                                 jenc.ids))) == _rows(want)


@pytest.mark.parametrize("spec_key", list(SPECS))
def test_empty_batch(spec_key):
    """No rows: an empty blob and one offset, native and plain, and an
    empty batch back. (The JAX codec raises on an empty batch with a
    fixed-width column, in its input normalization's reshape, so it is
    no oracle here.)"""
    batch, _ = _batches(spec_key, 0, 0)
    codec = FeatureCodec(batch.sft)
    for enc in (codec.encode_batch(batch), codec.encode_batch_plain(batch)):
        assert enc.blob == b"" and list(enc.row_offsets) == [0]
        assert codec.decode_batch(enc).n == 0
        assert codec.decode_batch_plain(enc).n == 0


@pytest.mark.parametrize("spec_key", list(SPECS))
def test_lazy_single_attribute_reads(spec_key):
    """One column extracted alone, native and plain, equals the JAX
    codec's extract of it."""
    batch, jbatch = _batches(spec_key, 64, 5)
    codec = FeatureCodec(batch.sft)
    jcodec = JaxCodec(jbatch.sft, use_native=False)
    enc = codec.encode_batch(batch)
    jenc = jcodec.encode_batch(jbatch)
    for a in batch.sft.attributes:
        got = codec.decode_attribute(enc, a.name)
        plain = codec.decode_attribute_plain(enc, a.name)
        want = jcodec.decode_attribute(jenc, a.name)
        vals = [[_cell(c.value(i)) for i in range(64)]
                for c in (got, plain, want)]
        assert vals[0] == vals[1] == vals[2], a.name
        assert np.array_equal(got.valid, want.valid)


def test_lazy_feature_view():
    batch, jbatch = _batches("all", 20, 6)
    codec = FeatureCodec(batch.sft)
    jcodec = JaxCodec(jbatch.sft, use_native=False)
    enc = codec.encode_batch(batch)
    for r in range(20):
        f = codec.deserialize(enc.row(r))
        jf = jcodec.deserialize(enc.row(r))
        assert isinstance(f, LazyFeature)
        want = {k: _cell(v) for k, v in jf.as_dict().items()}
        assert {k: _cell(v) for k, v in f.as_dict().items()} == want
        for i, a in enumerate(batch.sft.attributes):
            assert _cell(f.get(i)) == _cell(f.get_by_name(a.name)) \
                == want[a.name]
    with pytest.raises(ValueError, match="bad SFB version"):
        codec.deserialize(b"\x02" + enc.row(0)[1:])


COLLECTIONS = ("s:String,l:List[Integer],ls:List[String],"
               "m:Map[String,Double],mi:Map[Integer,Boolean],b:Bytes,"
               "u:UUID,dt:Date,ln:LineString,*geom:Point")


def _collection_values(rng, i):
    return {"s": f"héllo{i}",
            "l": rng.integers(-100, 100, i % 4).tolist(),
            "ls": [f"x{j}é" for j in range(i % 3)],
            "m": {f"k{j}": float(rng.normal()) for j in range(i % 5)},
            "mi": {j: bool(j % 2) for j in range(i % 3)},
            "b": bytes(rng.integers(0, 256, i % 9).astype(np.uint8)),
            "u": "123e4567-e89b-12d3-a456-426614174000",
            "dt": int(rng.integers(0, 10**12)),
            "ln": f"LINESTRING ({i} 0, {i + 1} 1)",
            "geom": (float(rng.uniform(-180, 180)),
                     float(rng.uniform(-90, 90)))}


@pytest.mark.parametrize("seed", range(4))
def test_single_features_with_collections(seed):
    """List, Map and Bytes values (and every other type) serialize to
    the JAX codec's bytes and read back through the lazy view, both
    ways; a None value is a null cell."""
    rng = np.random.default_rng(seed)
    codec = FeatureCodec(parse_spec("u", COLLECTIONS))
    jcodec = JaxCodec(jax_parse_spec("u", COLLECTIONS), use_native=False)
    for i in range(12):
        vals = _collection_values(rng, i)
        for k in list(vals):
            if rng.random() < 0.15:
                vals[k] = None
        pv = dict(vals, ln=None if vals["ln"] is None
                  else parse_wkt(vals["ln"]))
        jv = dict(vals, ln=None if vals["ln"] is None
                  else jax_parse_wkt(vals["ln"]))
        buf = codec.serialize(pv)
        assert buf == jcodec.serialize(jv)
        for f in (codec.deserialize(buf), jcodec.deserialize(buf)):
            got = f.as_dict()
            for k, v in vals.items():
                if v is None:
                    assert got[k] is None
                elif k == "geom":
                    assert (got[k].x, got[k].y) == v
                elif k == "ln":
                    assert str(got[k]) == str(parse_wkt(v))
                else:
                    assert got[k] == v and type(got[k]) is type(v), k


def test_bytes_column_batch():
    """A Bytes column (the codec's own column type) encodes to the JAX
    codec's blob and decodes back."""
    vals = [b"", None, b"\x00\xff", bytes(range(200)), None, b"abc"]
    ids = [f"f{i}" for i in range(len(vals))]
    sft, jsft = parse_spec("t", "b:Bytes,n:Integer"), \
        jax_parse_spec("t", "b:Bytes,n:Integer")
    nums = FeatureBatch.from_dict(parse_spec("x", "n:Integer"), ids,
                                  {"n": list(range(6))}).col("n")
    jnums = JaxBatch.from_dict(jax_parse_spec("x", "n:Integer"), ids,
                               {"n": list(range(6))}).col("n")
    batch = FeatureBatch(sft, ids, {"b": _BytesColumn("b", vals), "n": nums})
    jbatch = JaxBatch(jsft, ids, {"b": JaxBytesColumn("b", vals),
                                  "n": jnums})
    codec = FeatureCodec(sft)
    enc = codec.encode_batch(batch)
    assert enc.blob == codec.encode_batch_plain(batch).blob \
        == JaxCodec(jsft, use_native=False).encode_batch(jbatch).blob
    for dec in (codec.decode_attribute(enc, "b"),
                codec.decode_attribute_plain(enc, "b")):
        assert [dec.value(i) for i in range(6)] == vals
        assert list(dec.valid) == [v is not None for v in vals]
        assert dec.take([5, 2]).data == [b"abc", b"\x00\xff"]


@pytest.mark.parametrize("plain", [False, True])
def test_corrupt_blob_raises(plain):
    """A fixed-width cell of the wrong length raises ValueError, in the
    native extract and its twin alike."""
    batch, _ = _batches("point", 4, 7)
    codec = FeatureCodec(batch.sft)
    enc = codec.encode_batch(batch)
    # the second row's dtg cell claims 4 bytes: offsets (u32) [0, 4]
    row = bytearray(enc.row(1))
    row[1 + 1 + 4:1 + 1 + 8] = (4).to_bytes(4, "little")
    blob = enc.row(0) + bytes(row) + enc.blob[enc.row_offsets[2]:]
    bad = EncodedBatch(blob, enc.row_offsets, enc.ids)
    decode = codec.decode_attribute_plain if plain else codec.decode_attribute
    with pytest.raises(ValueError, match="width mismatch"):
        decode(bad, "dtg")


def test_failed_build_raises(monkeypatch, tmp_path):
    """With the compiler missing, the codec's native entries raise the
    build error; no plain twin runs in their place."""
    monkeypatch.setattr(native, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cache", {})

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran in place of the library")
    for name in ("encode_batch_plain", "decode_attribute_plain",
                 "_decode_fixed_plain", "_decode_var_plain"):
        monkeypatch.setattr(FeatureCodec, name, refuse)
    batch, _ = _batches("no_geom", 10, 8)
    codec = FeatureCodec(batch.sft)
    enc = EncodedBatch(b"", np.zeros(1, dtype=np.int64),
                       np.empty(0, dtype=object))
    for call in (lambda: codec.encode_batch(batch),
                 lambda: codec.decode_attribute(enc, "val"),
                 lambda: codec.decode_attribute(enc, "kind")):
        with pytest.raises(native.NativeBuildError, match="no-such-g"):
            call()


COLLECTION_WRITES = [
    # (spec, values, the JAX store raises ValueError too)
    ("tags:List[String],dtg:Date,*geom:Point:srid=4326",
     [["a", "b"], ["c"]], True),
    ("tags:List[Integer],dtg:Date,*geom:Point:srid=4326",
     [[1, 2], [3, 4]], False),
    ("attrs:Map[String,Integer],name:String,dtg:Date,*geom:Point:srid=4326",
     [{"a": 1}, {"b": 2}], False),
    ("blob:Bytes,val:Integer,dtg:Date", [b"\x00\x01", b"\x02"], True),
    ("blob:Bytes,val:Integer,dtg:Date", [None, None], False),
]


@pytest.mark.parametrize("spec,values,jax_raises", COLLECTION_WRITES)
def test_collection_schemas_in_the_store(spec, values, jax_raises):
    """create_schema accepts List, Map and Bytes attributes in both
    packages. Building such a column for a write raises ValueError in
    the port whatever the values (the JAX package's _column_for raises
    ValueError for ragged lists and bytes, TypeError for maps, and
    stores equal-length integer lists or all-null cells as a number
    column: its store is no oracle there, its codec is)."""
    ds = InMemoryDataStore(device="cpu")
    jds = JaxStore()
    ds.create_schema("c", spec)
    jds.create_schema("c", spec)
    name = spec.split(":")[0]
    assert str(ds.get_schema("c").attributes[0].type) \
        == str(jds.get_schema("c").attributes[0].type)
    data = {"dtg": [1, 2]}
    for a in ds.get_schema("c").attributes:
        if a.type.name == "Point":
            data[a.name] = (np.array([0.0, 2.0]), np.array([1.0, 3.0]))
        elif a.type.name == "String":
            data[a.name] = ["x", "y"]
        elif a.type.name == "Integer":
            data[a.name] = [1, 2]
    data[name] = values
    with pytest.raises(ValueError, match="cannot build"):
        ds.write_dict("c", ["f0", "f1"], data)
    assert ds.count("c") == 0
    if jax_raises:
        with pytest.raises(ValueError):
            jds.write_dict("c", ["f0", "f1"], data)
    # the codec serializes such values one feature at a time
    codec = FeatureCodec(ds.get_schema("c"))
    jcodec = JaxCodec(jds.get_schema("c"), use_native=False)
    for v in values:
        row = {name: v}
        assert codec.serialize(row) == jcodec.serialize(row)
        assert codec.deserialize(codec.serialize(row)).get_by_name(name) == v
