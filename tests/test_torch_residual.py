"""The port's residual compiler and the residual kernel's plain version
against the JAX package's device residual, on the same seeded batch as
tests/test_residual.py rebuilt with numpy for both packages, plus NaN
doubles, thresholds equal to data values, two doubles that share one
split key, numeric IN lists of 300 values and a nesting depth of 40.
Tolerance: exact. The masks equal the JAX package's
``residual.device_mask`` and the port's host evaluator, and the rows the
compiled program flags as its f64 band equal the rows where one of the
filter's f64 thresholds has the same split key as the value (the JAX
package's patch set)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from geomesa_tpu.features import FeatureBatch as JaxBatch
from geomesa_tpu.features import parse_spec as jax_parse_spec
from geomesa_tpu.filters import evaluate as jax_evaluate
from geomesa_tpu.filters import parse_ecql as jax_parse_ecql
from geomesa_tpu.scan import residual as jax_residual
from geomesa_tpu_torch import InMemoryDataStore
from geomesa_tpu_torch.features import FeatureBatch, parse_spec
from geomesa_tpu_torch.filters import ast, evaluate, parse_ecql
from geomesa_tpu_torch.scan import kernels, residual
from geomesa_tpu_torch.scan.kernels import Op

SPEC = ("name:String,age:Integer,score:Double,flag:Boolean,big:Long,"
        "dtg:Date,*geom:Point:srid=4326")
N = 10_000
KEY = 1.0 + 2.0**-25 + 2.0**-52     # these two doubles share one split key
TWIN = 1.0 + 2.0**-25 + 2.0**-51


def _ms(s):
    return int(np.datetime64(s, "ms").astype(np.int64))


def _data():
    """tests/test_residual.py's batch (seed 3, same draws), with NaN and
    split-key twins in score and an int64 column beside it."""
    rng = np.random.default_rng(3)
    names = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    vals = names[rng.integers(0, 40, N)].tolist()
    for i in range(0, N, 97):
        vals[i] = None
    age = rng.integers(0, 100, N).astype(object)
    age[5] = None
    score = rng.uniform(0, 1, N)
    flag = rng.integers(0, 2, N).astype(bool)
    dtg = rng.integers(_ms("2021-01-01"), _ms("2021-12-31"), N)
    geom = (rng.uniform(-180, 180, N), rng.uniform(-90, 90, N))
    score[::61] = np.nan
    score[7::113] = KEY
    score[8::113] = TWIN
    big = rng.integers(-(2**45), 2**45, N)
    return {"name": vals, "age": age, "score": score, "flag": flag,
            "big": big, "dtg": dtg, "geom": geom}


@pytest.fixture(scope="module")
def batches():
    data = _data()
    ids = [f"f{i}" for i in range(N)]
    port = FeatureBatch.from_dict(parse_spec("t", SPEC), ids, data)
    ref = JaxBatch.from_dict(jax_parse_spec("t", SPEC), ids, data)
    return (port, residual.DeviceColumns(port, "cpu"), ref,
            jax_residual.DeviceColumns(ref))


# tests/test_residual.py's FILTERS
FILTERS = [
    "name = 'w007'",
    "name <> 'w007'",
    "name < 'w010'",
    "name <= 'w010'",
    "name > 'w035'",
    "name >= 'w035'",
    "name = 'absent'",
    "name <> 'absent'",
    "name BETWEEN 'w010' AND 'w012'",
    "name > 'w0071'",
    "name IN ('w001', 'w002', 'nope')",
    "name LIKE 'w00%'",
    "name LIKE '%3'",
    "name ILIKE 'W01_'",
    "name IS NULL",
    "NOT (name = 'w007')",
    "age = 41",
    "age <> 41",
    "age BETWEEN 20 AND 30",
    "age IN (1, 2, 3)",
    "age IS NULL",
    "score < 0.25 OR score > 0.9",
    "flag = true",
    "dtg DURING 2021-03-01T00:00:00Z/2021-04-01T00:00:00Z",
    "dtg BEFORE 2021-02-01T00:00:00Z",
    "dtg AFTER 2021-11-01T00:00:00Z",
    "dtg >= '2021-06-01T00:00:00Z'",
    "age > 50 AND name = 'w002' AND score <= 0.5",
    "(name = 'w001' OR name = 'w002') AND flag = false",
    "age < 30.5",
    "age >= 0.5",
    "age = 41.5",
    "age <> 41.5",
    "age BETWEEN 19.5 AND 30.5",
]


def _deep(depth: int) -> str:
    """A filter nested ``depth`` levels: alternating AND/OR (which do not
    flatten) over compares on every column type."""
    leaves = ["age > {i}", "score < 0.{j}", "name <> 'w0{i:02d}'",
              "flag = true", "big > {k}", "NOT (age = {i})"]
    f = "score IS NULL"
    for i in range(depth):
        leaf = leaves[i % len(leaves)].format(i=i, j=(i % 9) + 1,
                                              k=i * 10**9)
        f = f"({leaf} {'AND' if i % 2 else 'OR'} {f})"
    return f


EXTRA = [
    "score IS NULL",
    "NOT (score < 0.5)",
    "score <> 0.5",
    f"score = {KEY!r}",
    f"score >= {KEY!r}",
    f"score < {TWIN!r} AND score > 0.99",
    "score IN (" + ", ".join(repr(0.001 * i) for i in range(299))
    + f", {KEY!r})",
    "age IN (" + ", ".join(str(i) for i in range(300)) + ")",
    "big > 1000000 AND big <= 17592186044416",
    "big BETWEEN -17592186044416 AND -2",
    _deep(40),
    "NOT " * 40 + "(flag = false)",
    "EXCLUDE OR age = 3",
    "INCLUDE AND name LIKE '%1_'",
]


def _f64_band(f, ref, names=("score",)):
    """The JAX package's patch set: rows where a Double compare's split
    key equals its threshold's, over the filter's f64 leaves."""
    band = np.zeros(ref.n, dtype=bool)
    for node in _walk(f):
        prop = getattr(node, "prop", None)
        if prop not in names:
            continue
        col = ref.col(prop)
        hi, lo = jax_residual._split_f64(col.values)
        for v in _literals(node):
            vh, vl = jax_residual._split_f64(float(v))
            band |= (hi == vh) & (lo == vl) & col.valid
    return band


def _walk(f):
    yield f
    for c in getattr(f, "children", ()) or ():
        yield from _walk(c)
    if getattr(f, "child", None) is not None:
        yield from _walk(f.child)


def _literals(node):
    if isinstance(node, ast.Compare):
        return [node.value]
    if isinstance(node, ast.Between):
        return [node.lo, node.hi]
    if isinstance(node, ast.InList):
        return list(node.values)
    return []


@pytest.mark.parametrize("ecql", FILTERS + EXTRA)
def test_matches_reference(batches, ecql):
    port, cols, ref, ref_cols = batches
    f = parse_ecql(ecql)
    assert residual.is_compilable(f, port)
    got = residual.device_mask(f, port, cols)
    jf = jax_parse_ecql(ecql)
    if "big" in ecql:
        # the reference's device residual overflows on an int64
        # threshold whose low word is >= 2^31 (ROADMAP.md section 3):
        # its host evaluator is the oracle there
        want = jax_evaluate(jf, ref)
    else:
        want = np.asarray(jax_residual.device_mask(jf, ref, ref_cols))
    assert np.array_equal(got, want), ecql
    assert np.array_equal(got, evaluate(f, port)), ecql
    prog = residual.compile_program(f, port, cols)
    band = (prog.run(cols, port.n).numpy() & 2) != 0
    assert np.array_equal(band, _f64_band(f, ref)), ecql
    assert prog.stack <= residual.MAX_STACK


@pytest.mark.parametrize("ecql", FILTERS + EXTRA)
def test_reference_columns_give_the_same_bytes(batches, ecql):
    """The kernel's plain version over the JAX package's own split device
    columns (fetched as numpy) gives the bytes it gives over the port's:
    both packages split the columns into the same words."""
    port, cols, _, ref_cols = batches
    f = parse_ecql(ecql)
    prog = residual.compile_program(f, port, cols)
    fetched = {name: {k: np.asarray(v) for k, v in ref_cols.get(name).items()}
               for name in prog.slots}
    theirs = residual.device_columns_from_numpy(port, fetched, "cpu")
    assert torch.equal(prog.run(theirs, port.n), prog.run(cols, port.n))


def test_band_rows_exist(batches):
    """The twins and the threshold's own rows are in the band of an
    equality on one of them, and the host patch decides them."""
    port, cols, ref, _ = batches
    f = parse_ecql(f"score = {KEY!r}")
    prog = residual.compile_program(f, port, cols)
    out = prog.run(cols, port.n).numpy()
    score = port.col("score").values
    assert set(np.flatnonzero(out & 2)) == set(
        np.flatnonzero((score == KEY) | (score == TWIN)))
    assert np.array_equal(residual.device_mask(f, port, cols), score == KEY)


def test_stack_stays_shallow(batches):
    """Sethi-Ullman order: 40 levels of nesting and a 300-value IN list
    need a stack of a few bits, and a wide OR of ANDs grows like
    log2 of its leaves."""
    port, cols, _, _ = batches
    deep = residual.compile_program(parse_ecql(_deep(40)), port, cols)
    assert deep.stack <= 3
    wide = residual.compile_program(parse_ecql(EXTRA[7]), port, cols)
    assert wide.stack == 2 and len(wide.code) == 599
    tree = " OR ".join(f"(age > {i} AND score < 0.{i % 9 + 1})"
                       for i in range(256))
    prog = residual.compile_program(parse_ecql(tree), port, cols)
    assert prog.stack <= 3


def test_wrapper_takes_plain_on_cpu_only(batches):
    """On CPU tensors the wrapper runs its plain version (no launch);
    the program's tensors and the slots must share one device."""
    port, cols, _, _ = batches
    prog = residual.compile_program(parse_ecql("age > 5"), port, cols)
    before = dict(kernels.launches)
    prog.run(cols, port.n)
    assert kernels.launches == before
    slot = cols.get("age")["slot"]
    with pytest.raises(ValueError, match="code"):
        kernels.residual_mask(torch.zeros((0, 4), dtype=torch.int32),
                              torch.from_numpy(prog.consts),
                              torch.from_numpy(prog.table), [slot], port.n)


def test_program_without_columns_takes_the_named_device(monkeypatch):
    """A program that reads no column runs on ``device``; None means
    CUDA there, as for every entry point, and never the CPU."""
    code = torch.tensor([[Op.TRUE, 0, 0, 0], [Op.NOT, 0, 0, 0],
                         [Op.NOT, 0, 0, 0]], dtype=torch.int32)
    consts = torch.zeros((0, 2), dtype=torch.int32)
    table = torch.zeros(0, dtype=torch.uint8)
    for fn in (kernels.residual_mask, kernels.residual_mask_plain):
        got = fn(code, consts, table, [], 5, device="cpu")
        assert got.device.type == "cpu"
        assert got.tolist() == [1] * 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (kernels.residual_mask, kernels.residual_mask_plain):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(code, consts, table, [], 5)


@pytest.mark.parametrize("code,match", [
    ([[Op.AND, 0, 0, 0]], "empty"),
    ([[Op.TRUE, 0, 0, 0], [Op.TRUE, 0, 0, 0]], "exactly one"),
    ([[99, 0, 0, 0]], "opcode"),
    ([[Op.VALID, 3, 0, 0]], "slot"),
    ([[Op.PAIR_F64, 0, 5, 0]], "threshold"),
    ([[Op.VOCAB, 0, 1, 40]], "vocab"),
])
def test_malformed_programs_raise(batches, code, match):
    """The wrapper checks a program before either path runs it: the
    kernel indexes its stack, slots, thresholds and tables by it."""
    port, cols, _, _ = batches
    slot = cols.get("age")["slot"]
    with pytest.raises(ValueError, match=match):
        kernels.residual_mask(torch.tensor(code, dtype=torch.int32),
                              torch.zeros((1, 2), dtype=torch.int32),
                              torch.zeros(40, dtype=torch.uint8), [slot],
                              port.n)


def test_spatial_and_fid_not_compilable(batches):
    port = batches[0]
    for ecql in ("BBOX(geom, 0, 0, 10, 10)", "IN ('f1')",
                 "age > 5 AND BBOX(geom, 0, 0, 10, 10)"):
        assert not residual.is_compilable(parse_ecql(ecql), port)


def test_opcodes_match_the_kernel_source():
    """csrc/residual.cu's enum values equal kernels.Op and kernels.Cmp
    name by name, and its geomesa_residual_codes table lists them in
    RESIDUAL_CODES' order (the loader compares the built table too)."""
    src = (Path(kernels.__file__).parents[1] / "csrc"
           / "residual.cu").read_text()
    values = {}
    for enum, cls in (("Op", kernels.Op), ("Cmp", kernels.Cmp)):
        body = re.search(rf"enum {enum} : int32_t \{{(.*?)\}};", src,
                         re.S).group(1)
        got = {name.upper(): int(v)
               for name, v in re.findall(r"\bk(\w+) = (\d+)", body)}
        want = {k.replace("_", ""): v for k, v in vars(cls).items()
                if k.isupper()}
        assert got == want, enum
        values.update(got)
    table = re.search(r"codes\[\] = \{(.*?)\};", src, re.S).group(1)
    order = [values[name.upper()]
             for name in re.findall(r"\bk(\w+)", table)]
    assert tuple(order) == kernels.RESIDUAL_CODES
    assert len(set(kernels.RESIDUAL_CODES[:16])) == 16


# -- ±inf and values past the f32 range in Double and Float columns ---------

INF_SPEC = "v:Double,w:Float,dtg:Date,*geom:Point:srid=4326"
INF_N = 600
BIG_LITERALS = ["v = 1e300", "v > 1e299", "v > 1e308", "v < -1e308",
                "w > 3.5e38", "w < -3.5e38"]
# 1e309 parses to float inf
INF_LITERALS = ["v = 1e309", "v < 1e309", "v >= 1e309", "v <> 1e309",
                "v > -1e309", "v <= -1e309", "w = 1e309", "w > -1e309",
                "v BETWEEN 1e300 AND 1e309", "v IN (1e309, -1e309, 1e300)",
                "NOT (v < 1e309) AND w < 1e309"]


def _inf_data():
    """INF_N seeded rows whose Double and Float columns hold +inf, -inf,
    NaN (null), values past the f32 range and ordinary values."""
    rng = np.random.default_rng(9)
    v = rng.uniform(-1e3, 1e3, INF_N)
    v[::7], v[1::7] = np.inf, -np.inf
    v[2::11] = np.nan
    v[3::13], v[4::13] = 1e300, -1e300
    v[5::17], v[6::17] = 1e308, 3.5e38
    w = np.round(rng.uniform(-2, 2, INF_N), 2)
    w[::5], w[1::9] = np.inf, -np.inf
    w[2::11] = np.nan
    w[3::7], w[4::7] = 3.6e38, -3.6e38
    return {"v": v, "w": w,
            "dtg": _ms("2021-01-01") + rng.integers(0, 10**9, INF_N),
            "geom": (rng.uniform(-180, 180, INF_N),
                     rng.uniform(-90, 90, INF_N))}


@pytest.fixture(scope="module")
def inf_batches():
    data = _inf_data()
    ids = [f"f{i}" for i in range(INF_N)]
    return (FeatureBatch.from_dict(parse_spec("t", INF_SPEC), ids, data),
            JaxBatch.from_dict(jax_parse_spec("t", INF_SPEC), ids, data))


@pytest.mark.parametrize("ecql", BIG_LITERALS + INF_LITERALS)
def test_infinities_match_the_evaluator(inf_batches, ecql):
    """The residual (its plain version here) and the store's fullscan
    residual give the host evaluators' rows on ±inf, NaN and values past
    the f32 range. The JAX package's device residual splits ±inf into
    (±inf, NaN) and is wrong here, so both evaluators are the oracle."""
    port, ref = inf_batches
    f = parse_ecql(ecql)
    want = jax_evaluate(jax_parse_ecql(ecql), ref)
    assert np.array_equal(want, evaluate(f, port)), ecql
    got = residual.device_mask(f, port, residual.DeviceColumns(port, "cpu"))
    assert np.array_equal(got, want), ecql
    ds = InMemoryDataStore(device="cpu")
    ds.create_schema("t", INF_SPEC)
    ds.write("t", FeatureBatch(ds.get_schema("t"), port.ids, port.columns))
    res = ds.query(ecql, "t")
    assert res.plan.index == "fullscan"
    assert np.array_equal(res.rows, np.flatnonzero(want)), ecql
    assert ds.query_count(ecql, "t") == int(want.sum())


def test_infinities_split_and_band(inf_batches):
    """±inf splits as (±inf, 0), so it orders against every finite key
    without the band; a finite value past the f32 range keeps the key
    (±inf, ∓inf) that every such value and literal shares, so it lands
    in the band and the float64 recheck decides it."""
    port, _ = inf_batches
    hi, lo = residual._split_f64(np.array([np.inf, -np.inf, 1e300, -1e300,
                                           3.6e38, 1.5]))
    assert np.array_equal(hi, np.float32([np.inf, -np.inf, np.inf, -np.inf,
                                          np.inf, 1.5]))
    assert np.array_equal(lo, np.float32([0, 0, -np.inf, np.inf, -np.inf,
                                          0]))
    cols = residual.DeviceColumns(port, "cpu")
    v = port.col("v").values

    def band(ecql):
        prog = residual.compile_program(parse_ecql(ecql), port, cols)
        return (prog.run(cols, port.n).numpy() & 2) != 0
    top = np.finfo(np.float32).max
    assert np.array_equal(band("v > 1e299"), np.isfinite(v) & (v > top))
    assert np.array_equal(band("v < -1e308"), np.isfinite(v) & (v < -top))
    assert np.array_equal(band("v = 1e309"), v == np.inf)
