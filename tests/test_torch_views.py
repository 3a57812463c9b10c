"""The port's materialized views (``geomesa_tpu_torch.views``) against
the JAX package's on the CPU.

All 15 tests of ``tests/test_views.py`` run here, each scenario in both
packages (``both(fn)``) on stores built from the same numpy seed (the
port's on ``device="cpu"``). Each run keeps the reference test's own
gate: the view is bit-identical to a from-scratch ``SqlEngine``
re-execution at the same LSN (floats by hex pattern, dtypes included,
geometries as WKT: the reference's ``canon``). The two packages'
outcomes must then be equal too: the views' rows as text, their
statuses, the deltas published on the bus and the error types. No
comparison here has a tolerance. Cross-package cases restore a view
sidecar written by one package in the other, both ways, without a
rebuild.

The ``gpu`` test at the end folds a view on a CUDA store through writes
and a delete wave (``python -m pytest --noconftest -m gpu
tests/test_torch_views.py``)."""

import importlib
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

SPEC = "cat:String,n:Integer,v:Double,*geom:Point:srid=4326"

NUM_SQL = ("SELECT cat, count(*) AS c, sum(n) AS s, avg(v) AS a, "
           "min(v) AS lo, max(v) AS hi FROM t WHERE n > 0 "
           "GROUP BY cat ORDER BY cat")
GEO_SQL = ("SELECT cat, count(*) AS c, st_extent(geom) AS ext, "
           "st_convexHull(geom) AS hull FROM t GROUP BY cat")
SIMPLE_SQL = "SELECT cat, count(*) AS c, sum(n) AS s FROM t GROUP BY cat"


def _ns(pkg, cpu):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    views = m("views")
    store = m("store.memory").InMemoryDataStore

    def make(**kw):
        if cpu:
            kw.setdefault("device", "cpu")
        return store(**kw)

    return types.SimpleNamespace(
        pkg=pkg, m=m, store=make, views=views,
        ViewRegistry=views.ViewRegistry, ViewState=views.ViewState,
        ViewDeltaSubscriber=views.ViewDeltaSubscriber,
        view_topic=views.view_topic, VIEWS_ENABLED=views.VIEWS_ENABLED,
        VIEW_RESERVOIR_K=views.VIEW_RESERVOIR_K,
        SqlEngine=m("sql").SqlEngine,
        FeatureBatch=m("features").FeatureBatch,
        parse_spec=m("features").parse_spec,
        Geometry=m("geometry.base").Geometry, to_wkt=m("geometry").to_wkt)


T = _ns("geomesa_tpu_torch", cpu=True)
try:        # the CPU tests hold the port to the JAX package
    import geomesa_tpu  # noqa: F401
    J = _ns("geomesa_tpu", cpu=False)
    PKGS = (J, T)
except ImportError:     # the card's machine has no JAX: gpu tests only
    J = None
    PKGS = (T,)

needs_jax = pytest.mark.skipif(J is None, reason="needs JAX")


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


@pytest.fixture(autouse=True)
def _views_on():
    for P in PKGS:
        P.VIEWS_ENABLED.set("true")
    yield
    for P in PKGS:
        P.VIEWS_ENABLED.set(None)
        P.VIEW_RESERVOIR_K.set(None)


def make_batch(P, sft, n, seed=7, id_prefix="f", cats=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    ids = np.array([f"{id_prefix}{i}" for i in range(n)], dtype=object)
    return P.FeatureBatch.from_dict(sft, ids, {
        "cat": np.array([cats[i % len(cats)] for i in range(n)],
                        dtype=object),
        "n": rng.integers(-50, 50, n),
        "v": rng.normal(0.0, 10.0, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


def fresh_store(P, n=0, seed=7, **store_kw):
    sft = P.parse_spec("t", SPEC)
    ds = P.store(**store_kw)
    ds.create_schema(sft)
    if n:
        ds.write("t", make_batch(P, sft, n, seed=seed))
    return ds, sft


def canon(P, res):
    """The reference's bit-exact canonical form of a SqlResult: dtypes
    and per-value encodings (floats by hex pattern, geometries as WKT)."""
    def enc(x):
        if isinstance(x, np.generic):
            x = x.item()
        if isinstance(x, float):
            return ("f", float(x).hex())
        if isinstance(x, P.Geometry):
            return ("g", P.to_wkt(x))
        return x

    dtypes = [str(np.asarray(res.columns[n]).dtype) for n in res.names]
    return (list(res.names), dtypes,
            [tuple(enc(x) for x in r) for r in res.rows()])


def matches_scratch(P, reg, ds, name, sql):
    """The view's canon, held equal to a from-scratch re-execution."""
    got = canon(P, reg.result(name))
    assert got == canon(P, P.SqlEngine(ds).query(sql))
    return got


def test_exports_equal_reference():
    j = importlib.import_module("geomesa_tpu.views")
    t = importlib.import_module("geomesa_tpu_torch.views")
    assert j.__all__ == t.__all__
    for name in ("VIEWS_ENABLED", "VIEW_RESERVOIR_K"):
        assert getattr(j, name).name == getattr(t, name).name
        assert getattr(j, name).default == getattr(t, name).default
    assert j.view_topic("x") == t.view_topic("x")


# -- fold-state bit-identity ------------------------------------------------

@needs_jax
class TestBitIdentity:
    def test_initial_build_matches_engine(self):
        def run(P):
            ds, sft = fresh_store(P, 60)
            reg = P.ViewRegistry(ds)
            reg.register("num", NUM_SQL)
            reg.register("geo", GEO_SQL)
            return (matches_scratch(P, reg, ds, "num", NUM_SQL),
                    matches_scratch(P, reg, ds, "geo", GEO_SQL),
                    reg.status())
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("seed", [3, 17, 202, 4049])
    def test_randomized_write_delete_interleavings(self, seed):
        """After EVERY commit of a random mix of inserts and deletes the
        folded state matches a from-scratch re-execution, and the port's
        views equal the reference's."""
        def run(P):
            ds, sft = fresh_store(P, 40, seed=seed)
            reg = P.ViewRegistry(ds)
            reg.register("num", NUM_SQL)
            reg.register("geo", GEO_SQL)
            rng = np.random.default_rng(seed)
            live = {f"f{i}" for i in range(40)}
            trail = []
            for step in range(20):
                if live and rng.random() < 0.45:
                    k = int(rng.integers(1, min(8, len(live)) + 1))
                    doom = [str(x) for x in rng.choice(
                        sorted(live), size=k, replace=False)]
                    ds.delete("t", doom)
                    live -= set(doom)
                else:
                    k = int(rng.integers(1, 9))
                    b = make_batch(P, sft, k,
                                   seed=int(rng.integers(1 << 30)),
                                   id_prefix=f"s{step}_")
                    ds.write("t", b)
                    live |= {str(i) for i in b.ids}
                trail.append((matches_scratch(P, reg, ds, "num", NUM_SQL),
                              matches_scratch(P, reg, ds, "geo", GEO_SQL)))
            return trail, reg.status()
        j, t = both(run)
        assert t == j

    def test_delete_all_of_a_group_removes_it(self):
        def run(P):
            ds, sft = fresh_store(P)
            reg = P.ViewRegistry(ds)
            ds.write("t", make_batch(P, sft, 12))
            reg.register("s", SIMPLE_SQL)
            ds.delete("t", [f"f{i}" for i in (1, 4, 7, 10)])
            res = reg.result("s")
            assert [r[0] for r in res.rows()] == ["a", "c"]
            out = [matches_scratch(P, reg, ds, "s", SIMPLE_SQL)]
            ds.delete("t", [f"f{i}" for i in (0, 2, 3, 5, 6, 8, 9, 11)])
            out.append(matches_scratch(P, reg, ds, "s", SIMPLE_SQL))
            assert list(reg.result("s").rows()) == []
            return out, reg.status()
        j, t = both(run)
        assert t == j

    def test_minmax_reservoir_drain_falls_back_to_recompute(self):
        def run(P):
            P.VIEW_RESERVOIR_K.set("2")
            sql = "SELECT cat, min(v) AS lo, max(v) AS hi FROM t GROUP BY cat"
            ds, sft = fresh_store(P)
            vals = [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5]
            ids = np.array([f"f{i}" for i in range(len(vals))], dtype=object)
            ds.write("t", P.FeatureBatch.from_dict(sft, ids, {
                "cat": np.array(["a"] * len(vals), dtype=object),
                "n": np.arange(len(vals)),
                "v": np.array(vals),
                "geom": (np.zeros(len(vals)), np.zeros(len(vals)))}))
            reg = P.ViewRegistry(ds)
            reg.register("m", sql)
            ds.delete("t", ["f0"])
            ds.delete("t", ["f1"])
            ds.delete("t", ["f2"])
            assert reg.get("m").retraction_fallbacks > 0
            out = [matches_scratch(P, reg, ds, "m", sql)]
            ds.delete("t", ["f7", "f6", "f5"])
            out.append(matches_scratch(P, reg, ds, "m", sql))
            return out, reg.status()
        j, t = both(run)
        assert t == j

    def test_refresh_is_a_noop_on_clean_state(self):
        def run(P):
            ds, sft = fresh_store(P, 30)
            reg = P.ViewRegistry(ds)
            reg.register("s", SIMPLE_SQL)
            before = canon(P, reg.result("s"))
            st = reg.refresh("s")
            assert canon(P, reg.result("s")) == before
            return before, st
        j, t = both(run)
        assert t == j


# -- refusals and the kill switch --------------------------------------------

@needs_jax
class TestRefusalsAndKillSwitch:
    def test_unsupported_shapes_refuse_typed(self):
        def run(P):
            ds, sft = fresh_store(P, 5)
            reg = P.ViewRegistry(ds)
            out = []
            for stmt, needle in [
                    ("SELECT count(*) FROM t", "GROUP BY"),
                    ("SELECT cat FROM t GROUP BY cat ORDER BY nope",
                     "ORDER BY"),
                    ("SELECT cat, sum(cat) AS s FROM t GROUP BY cat", "sum"),
                    ("SELEC nope", "SELEC")]:
                with pytest.raises(ValueError, match=needle) as e:
                    reg.register("x", stmt)
                out.append((type(e.value).__name__, str(e.value)))
            assert reg.status() == []
            return out
        j, t = both(run)
        assert t == j

    def test_kill_switch_off_register_refuses_and_no_hooks(self):
        def run(P):
            P.VIEWS_ENABLED.set(None)    # default: false
            ds, sft = fresh_store(P, 5)
            twin, _ = fresh_store(P, 5)
            reg = P.ViewRegistry(ds)
            with pytest.raises(ValueError, match="disabled") as e:
                reg.register("x", SIMPLE_SQL)
            assert reg._orig == {}
            assert "write" not in ds.__dict__ and "delete" not in ds.__dict__
            for s in (ds, twin):
                s.write("t", make_batch(P, sft, 3, id_prefix="g"))
                s.delete("t", ["f1"])
            assert ds.count("t") == 7
            got = canon(P, P.SqlEngine(ds).query(SIMPLE_SQL))
            assert got == canon(P, P.SqlEngine(twin).query(SIMPLE_SQL))
            assert ds.pushdown_version("t") == twin.pushdown_version("t")
            return str(e.value), got, [str(i) for i in
                                       ds.query("INCLUDE", "t").ids]
        j, t = both(run)
        assert t == j

    def test_unregister_restores_write_path(self):
        def run(P):
            ds, sft = fresh_store(P, 5)
            reg = P.ViewRegistry(ds)
            reg.register("s", SIMPLE_SQL)
            assert reg._orig
            reg.unregister("s")
            assert reg._orig == {}
            ds.write("t", make_batch(P, sft, 2, id_prefix="g"))
            assert ds.count("t") == 7
            with pytest.raises(KeyError) as e:
                reg.unregister("s")
            return str(e.value), reg.status()
        j, t = both(run)
        assert t == j


# -- durability: checkpoint save and restart restore -------------------------

def _count_builds(P, monkeypatch):
    builds = []
    orig_build = P.ViewState.build
    monkeypatch.setattr(
        P.ViewState, "build",
        lambda self, store: (builds.append(1), orig_build(self, store))[1])
    return builds


@needs_jax
class TestRestartRecovery:
    def test_checkpoint_then_reopen_restores_without_rebuild(
            self, tmp_path, monkeypatch):
        def run(P):
            root = str(tmp_path / P.pkg / "dur")
            ds, sft = fresh_store(P, 50, durable_dir=root, wal_fsync="never")
            reg = P.ViewRegistry(ds)
            reg.register("num", NUM_SQL)
            ds.write("t", make_batch(P, sft, 10, seed=23, id_prefix="g"))
            ds.delete("t", ["f1", "f2"])
            expect = canon(P, reg.result("num"))
            ds.checkpoint()
            with monkeypatch.context() as mp:
                builds = _count_builds(P, mp)
                ds2 = P.store(durable_dir=root, wal_fsync="never")
                reg2 = P.ViewRegistry(ds2)
                assert builds == []
            assert [v["name"] for v in reg2.status()] == ["num"]
            assert canon(P, reg2.result("num")) == expect
            ds2.write("t", make_batch(P, sft, 5, seed=99, id_prefix="h"))
            return expect, matches_scratch(P, reg2, ds2, "num", NUM_SQL)
        j, t = both(run)
        assert t == j

    def test_stale_sidecar_rebuilds_once(self, tmp_path, monkeypatch):
        def run(P):
            root = str(tmp_path / P.pkg / "dur")
            ds, sft = fresh_store(P, 30, durable_dir=root, wal_fsync="never")
            reg = P.ViewRegistry(ds)
            reg.register("s", SIMPLE_SQL)
            ds.checkpoint()
            ds.write("t", make_batch(P, sft, 7, seed=5, id_prefix="g"))
            with monkeypatch.context() as mp:
                builds = _count_builds(P, mp)
                ds2 = P.store(durable_dir=root, wal_fsync="never")
                reg2 = P.ViewRegistry(ds2)
                assert builds == [1]
            return matches_scratch(P, reg2, ds2, "s", SIMPLE_SQL)
        j, t = both(run)
        assert t == j


# -- the delta stream ---------------------------------------------------------

@needs_jax
class TestDeltaStream:
    def test_fold_publishes_changed_and_removed_groups(self):
        def run(P):
            bus = P.m("store.live").MessageBus()
            ds, sft = fresh_store(P, 6)
            got = []
            bus.subscribe(P.view_topic("s"), lambda m: got.append(
                json.loads(m.ids[0])))
            reg = P.ViewRegistry(ds, bus=bus)
            reg.register("s", SIMPLE_SQL)
            ds.write("t", make_batch(P, sft, 3, seed=2, id_prefix="g",
                                     cats=("a",)))
            assert len(got) == 1 and got[0]["seq"] == 0
            assert [r["key"] for r in got[0]["rows"]] == [["a"]]
            assert got[0]["rows"][0]["row"]["c"] == 5
            ds.delete("t", ["f1", "f4"])
            assert got[-1]["seq"] == 1 and got[-1]["removed"] == [["b"]]
            return got
        j, t = both(run)
        assert t == j

    def test_exactly_once_across_broker_restart(self, tmp_path):
        def run(P):
            sb = P.m("store.socketbus")
            root = str(tmp_path / P.pkg / "viewlog")
            broker = sb.SocketBroker(root=root).start()
            port = broker.port
            ds, sft = fresh_store(P, 10)
            pub_bus = sb.SocketBus(broker.host, port, group="view-pub")
            reg = P.ViewRegistry(ds, bus=pub_bus)
            reg.register("hot", SIMPLE_SQL)
            sub = P.ViewDeltaSubscriber("hot", host=broker.host, port=port,
                                        group="g1", timeout_s=10.0)
            deltas = []
            sub.on_delta(deltas.append)
            try:
                for i in range(4):
                    ds.write("t", make_batch(P, sft, 3, seed=i + 1,
                                             id_prefix=f"a{i}_"))
                deadline = time.monotonic() + 15.0
                while len(deltas) < 4 and time.monotonic() < deadline:
                    sub.poll(wait_s=1.0)
                assert [d["seq"] for d in deltas] == [0, 1, 2, 3]
                committed = sub.offset()
                broker.stop()
                broker = sb.SocketBroker(port=port, root=root).start()
                for i in range(4):
                    ds.write("t", make_batch(P, sft, 3, seed=100 + i,
                                             id_prefix=f"b{i}_"))
                deadline = time.monotonic() + 15.0
                while len(deltas) < 8 and time.monotonic() < deadline:
                    sub.poll(wait_s=1.0)
                assert [d["seq"] for d in deltas] == list(range(8))
                assert sub.offset() > committed
                sub2 = P.ViewDeltaSubscriber("hot", host=broker.host,
                                             port=port, group="g1",
                                             timeout_s=10.0)
                replays = []
                sub2.on_delta(replays.append)
                sub2.poll(wait_s=0.5)
                assert replays == []
                sub2.close()
                return deltas
            finally:
                sub.close()
                pub_bus.close()
                broker.stop()
        j, t = both(run)
        assert t == j


# -- the web surface ----------------------------------------------------------

def _req(base, method, path, body=None, hdrs=None):
    r = urllib.request.Request(base + path, data=body, method=method,
                               headers=hdrs or {})
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _serve(P, fn):
    ds, sft = fresh_store(P, 12)
    srv = P.m("web").GeoMesaWebServer(ds, port=0, auth_token="sekret").start()
    try:
        return fn(ds, sft, srv, f"http://127.0.0.1:{srv.port}/rest")
    finally:
        srv.stop()


def _wire(reply):
    """A reply as the two servers must agree on it: status, ETag, body."""
    return reply[0], reply[1].get("ETag"), reply[2]


@needs_jax
class TestViewsWeb:
    def test_register_read_etag_unregister(self):
        def run(P):
            def go(ds, sft, srv, base):
                tok = {"Authorization": "Bearer sekret"}
                out = [_req(base, "GET", "/views")]
                assert out[-1][0] == 200
                assert json.loads(out[-1][2]) == {"views": []}
                body = json.dumps({"name": "s", "sql": SIMPLE_SQL}).encode()
                out.append(_req(base, "POST", "/views/register", body, tok))
                assert out[-1][0] == 201
                assert json.loads(out[-1][2])["registered"] == "s"
                out.append(_req(base, "GET", "/views/s"))
                etag = out[-1][1].get("ETag")
                assert out[-1][0] == 200 and etag
                out.append(_req(base, "GET", "/views/s",
                                hdrs={"If-None-Match": etag}))
                assert out[-1][0] == 304
                ds.write("t", make_batch(P, sft, 3, seed=9, id_prefix="g"))
                out.append(_req(base, "GET", "/views/s",
                                hdrs={"If-None-Match": etag}))
                assert out[-1][0] == 200
                wire = [tuple(r) for r in json.loads(out[-1][2])["rows"]]
                oracle = [tuple(json.loads(json.dumps(
                    [x.item() if isinstance(x, np.generic) else x
                     for x in r])))
                    for r in P.SqlEngine(ds).query(SIMPLE_SQL).rows()]
                assert wire == oracle
                out.append(_req(base, "POST", "/views/refresh",
                                json.dumps({"name": "s"}).encode(), tok))
                assert out[-1][0] == 200
                out.append(_req(base, "POST", "/views/unregister",
                                json.dumps({"name": "s"}).encode(), tok))
                assert out[-1][0] == 200
                assert json.loads(out[-1][2]) == {"unregistered": "s"}
                out.append(_req(base, "GET", "/views/s"))
                assert out[-1][0] == 404
                return [_wire(r) for r in out]
            return _serve(P, go)
        j, t = both(run)
        assert t == j

    def test_register_validation_errors_are_400_with_message(self):
        def run(P):
            def go(ds, sft, srv, base):
                tok = {"Authorization": "Bearer sekret"}
                out = []
                for stmt, needle in [
                        ("SELECT count(*) FROM t", b"GROUP BY"),
                        ("SELEC nope", b"SELEC"),
                        ("SELECT cat, sum(cat) AS s FROM t GROUP BY cat",
                         b"sum")]:
                    out.append(_req(base, "POST", "/views/register",
                                    json.dumps({"name": "bad",
                                                "sql": stmt}).encode(), tok))
                    assert out[-1][0] == 400 and needle in out[-1][2]
                out.append(_req(base, "POST", "/views/register",
                                json.dumps({"name": "bad"}).encode(), tok))
                assert out[-1][0] == 400 and b"sql required" in out[-1][2]
                return [_wire(r) for r in out]
            return _serve(P, go)
        j, t = both(run)
        assert t == j

    def test_mutations_are_token_gated(self):
        def run(P):
            def go(ds, sft, srv, base):
                body = json.dumps({"name": "s", "sql": SIMPLE_SQL}).encode()
                out = [_req(base, "POST", "/views/register", body),
                       _req(base, "GET", "/views")]
                assert [r[0] for r in out] == [403, 200]
                return [_wire(r) for r in out]
            return _serve(P, go)
        j, t = both(run)
        assert t == j


# -- across packages ------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_view_sidecar_restores_across_packages(tmp_path, monkeypatch,
                                               writer, reader):
    """A view sidecar saved by one package's checkpoint restores in the
    other without a rebuild when the LSN matches (floats hex-encoded, so
    the restored state is bit-identical), and keeps folding there."""
    W = J if writer == "jax" else T
    R = J if reader == "jax" else T
    root = str(tmp_path / "dur")
    ds, sft = fresh_store(W, 50, durable_dir=root, wal_fsync="never")
    reg = W.ViewRegistry(ds)
    reg.register("num", NUM_SQL)
    reg.register("geo", GEO_SQL)
    ds.write("t", make_batch(W, sft, 10, seed=23, id_prefix="g"))
    ds.delete("t", ["f1", "f2"])
    want = (canon(W, reg.result("num")), canon(W, reg.result("geo")))
    ds.checkpoint()
    ds.close()
    builds = _count_builds(R, monkeypatch)
    ds2 = R.store(durable_dir=root, wal_fsync="never")
    reg2 = R.ViewRegistry(ds2)
    assert builds == []
    got = (canon(R, reg2.result("num")), canon(R, reg2.result("geo")))
    assert got == want
    rsft = R.parse_spec("t", SPEC)
    ds2.write("t", make_batch(R, rsft, 5, seed=99, id_prefix="h"))
    ds2.delete("t", ["f7"])
    matches_scratch(R, reg2, ds2, "num", NUM_SQL)
    matches_scratch(R, reg2, ds2, "geo", GEO_SQL)
    reg2.close()
    ds2.close()


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_view_on_cuda_store_stays_bit_identical():
    """A view on a CUDA store folds a firehose of commits and a delete
    wave and stays bit-identical to ``SqlEngine`` re-execution."""
    T.VIEWS_ENABLED.set("true")
    try:
        sft = T.parse_spec("t", SPEC)
        ds = T.m("store.memory").InMemoryDataStore()
        ds.create_schema(sft)
        ds.write("t", make_batch(T, sft, 50_000, seed=1,
                                 cats=tuple("abcdefgh")))
        reg = T.ViewRegistry(ds, restore=False)
        reg.register("num", NUM_SQL)
        reg.register("geo", GEO_SQL)
        for j in range(10):
            ds.write("t", make_batch(T, sft, 1_000, seed=100 + j,
                                     id_prefix=f"c{j}_",
                                     cats=tuple("abcdefgh")))
            matches_scratch(T, reg, ds, "num", NUM_SQL)
        ds.delete("t", [f"c0_{i}" for i in range(500)]
                  + [f"f{i}" for i in range(0, 5_000, 7)])
        matches_scratch(T, reg, ds, "num", NUM_SQL)
        matches_scratch(T, reg, ds, "geo", GEO_SQL)
        assert reg.get("num").folds == 11
        reg.close()
    finally:
        T.VIEWS_ENABLED.set(None)
