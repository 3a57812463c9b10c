"""The port's elastic topology (``cluster/reshard.py``,
``cluster/autoscale.py`` and the splitter's key-density functions)
against the JAX package's on the CPU.

Every class of ``tests/test_reshard.py`` but ``TestCli`` (the tools CLI
is queue 1 item 10) runs in both packages (``both(fn)``) on shard
groups built from the same skewed rows (the port's on
``device="cpu"``). Each run keeps the reference test's own assertions
(id-exact against a single-store oracle, no row lost or duplicated
across groups) and the outcomes must be equal: split points, epochs,
the history entries with times left out, the rows each group holds,
the autoscaler's decisions and the error types at every kill point.
``prefix_histogram``, ``pick_split_prefix`` and ``_batch_prefixes`` are
held to the JAX functions on seeded point, extent and geometry-less
batches. A migration stages on its source group's device.

The ``gpu`` test at the end splits a CUDA cluster: its staging store is
on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_reshard.py``)."""

import importlib
import threading

import numpy as np
import pytest
import torch

from test_torch_replication import J, T, both, needs_jax

SPEC = "*geom:Point:srid=4326,dtg:Date,name:String"
VOLATILE = {"ts_ms", "flip_ms", "started_ms", "cooldown_remaining_s",
            "ts", "p99_s", "hot_p99_s", "sustained_s"}


def m(P, name):
    return importlib.import_module(f"{P.pkg}.{name}")


def cl(P):
    return m(P, "cluster")


def steady(obj):
    if isinstance(obj, dict):
        return {k: steady(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [steady(v) for v in obj]
    return obj


def hot_seeded(n=600, seed=3, hot_frac=0.7):
    rng = np.random.default_rng(seed)
    ids = np.array([f"f{i}" for i in range(n)], dtype=object)
    n_hot = int(n * hot_frac)
    x = np.concatenate([rng.uniform(100, 112, n_hot),
                        rng.uniform(-180, 180, n - n_hot)])
    y = np.concatenate([rng.uniform(40, 46, n_hot),
                        rng.uniform(-90, 90, n - n_hot)])
    return ids, {
        "geom": (x, y),
        "dtg": (np.int64(1704067200000)
                + np.arange(n, dtype=np.int64) * 3_600_000),
        "name": np.array([f"n{i % 7}" for i in range(n)], dtype=object)}


def make_cluster(P, k, n=600, names=None, groups=None, **kw):
    sft = P.parse_spec("pts", SPEC)
    groups = groups or [P.store() for _ in range(k)]
    cluster = cl(P).ClusterDataStore(groups, names=names, **kw)
    cluster.create_schema(sft)
    oracle = P.store()
    oracle.create_schema(sft)
    ids, cols = hot_seeded(n)
    cluster.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    oracle.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    return cluster, oracle, sft


def durable_groups(P, root, k=3):
    DurableStore = m(P, "wal").DurableStore
    return [DurableStore(P.store(), root / P.name / f"g{i}", fsync="never")
            for i in range(k)]


def hottest_group(cluster):
    topo = cluster.topology()
    return max(topo["groups"], key=lambda g: g["rows"])["name"]


def cluster_ids(store, ecql="INCLUDE"):
    res = store.query(ecql, "pts")
    return set() if res.batch is None else set(res.ids.astype(str))


def assert_exact(cluster, oracle):
    for ecql in ("INCLUDE", "BBOX(geom, 100, 40, 112, 46)",
                 "BBOX(geom, -60, -30, 60, 30)", "name = 'n3'"):
        assert cluster_ids(cluster, ecql) == cluster_ids(oracle, ecql), ecql
    assert cluster.count("pts") == oracle.count("pts")
    per_group = [g.count("pts") for g in cluster._groups]
    assert sum(per_group) == oracle.count("pts")
    return per_group


@pytest.fixture
def reset_knobs():
    """The knobs back to their defaults after the test, and the global
    SLO engines cleared around it: a fast burn recorded by an earlier
    test in the process would waive the autoscaler's sustain window."""
    for P in (J, T):
        m(P, "obs").slo_engine.clear()
    yield
    for P in (J, T):
        m(P, "obs").slo_engine.clear()
        m(P, "cluster.reshard").RESHARD_ENABLED.set(None)
        auto = m(P, "cluster.autoscale")
        auto.RESHARD_AUTO.set(None)
        auto.RESHARD_HOT_SUSTAIN_S.set(None)


# -- the splitter's key-density functions --------------------------------------

@pytest.mark.parametrize("kind", ["points", "extents", "geometryless"])
def test_batch_prefixes_equal_reference(kind):
    def run(P):
        split = m(P, "index.splitter")
        rng = np.random.default_rng(17)
        n = 300
        if kind == "points":
            sft = P.parse_spec("b", "*geom:Point:srid=4326,v:Integer")
            cols = {"geom": (rng.uniform(-180, 180, n),
                             rng.uniform(-90, 90, n)), "v": np.arange(n)}
        elif kind == "extents":
            sft = P.parse_spec("b", "*geom:Polygon:srid=4326,v:Integer")
            x, y = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
            polys = [f"POLYGON (({a} {b}, {a + 2} {b}, {a + 2} {b + 1}, "
                     f"{a} {b + 1}, {a} {b}))" for a, b in zip(x, y)]
            polys[5] = None
            cols = {"geom": polys, "v": np.arange(n)}
        else:
            sft = P.parse_spec("b", "v:Integer,name:String")
            cols = {"v": np.arange(n), "name": [f"n{i}" for i in range(n)]}
        batch = P.FeatureBatch.from_dict(sft, [f"x{i}" for i in range(n)],
                                         cols)
        out = []
        for bits in (8, 16):
            p = split._batch_prefixes(sft, batch, bits)
            out.append(None if p is None else p.tolist())
        ds = P.store()
        ds.create_schema(sft)
        ds.write("b", batch)
        for lo, hi in ((0, 1 << 16), (1000, 30000), (5, 5)):
            h = split.prefix_histogram(ds, "b", lo, hi)
            out.append((h.dtype.str, int(h.sum()), np.flatnonzero(h).tolist(),
                        split.pick_split_prefix(h, lo, hi)))
        return out
    j, t = both(run)
    assert t == j


def test_pick_split_prefix_equals_reference():
    def run(P):
        pick = m(P, "index.splitter").pick_split_prefix
        rng = np.random.default_rng(2)
        out = [pick(None, 0, 100), pick(np.zeros(100, np.int64), 0, 100),
               pick(np.ones(3, np.int64), 0, 100),
               pick(np.ones(100, np.int64), 0, 100)]
        skew = np.zeros(100, np.int64)
        skew[90:] = 50
        out.append(pick(skew, 0, 100))
        edge = np.zeros(10, np.int64)
        edge[0] = 99
        out += [pick(edge, 20, 30), pick(edge[::-1].copy(), 20, 30)]
        for _ in range(30):
            lo = int(rng.integers(0, 1000))
            w = int(rng.integers(2, 200))
            c = rng.integers(0, 5, w) * (rng.random(w) < 0.3)
            out.append(pick(c, lo, lo + w))
        return out
    j, t = both(run)
    assert t == j
    assert t[:4] == [50, 50, 50, 50]


# -- TestSegmentTopology -------------------------------------------------------

def test_segment_topology():
    def run(P):
        part_cls = cl(P).ZPrefixPartitioner
        rng = np.random.default_rng(0)
        x, y = rng.uniform(-180, 180, 1000), rng.uniform(-90, 90, 1000)
        out = [part_cls(5).segments(), part_cls(5).owners_xy(x, y).tolist()]
        p1 = part_cls(3).with_move(100, 2000, 2)
        p2 = p1.with_move(50000, 60000, 0)
        assert (p1.epoch, p2.epoch) == (1, 2)
        for p in (p1, p2):
            segs = p.segments()
            assert segs[0]["prefix_lo"] == 0
            for a, b in zip(segs, segs[1:]):
                assert a["prefix_hi"] == b["prefix_lo"]
            out.append((segs, p.owners_xy(x, y).tolist(),
                        [p.owned_prefix_ranges(g) for g in range(3)]))
        ids = [f"i{k}" for k in range(50)]
        assert (p2.owners_ids(ids) == part_cls(3).owners_ids(ids)).all()
        ranges = p2.covering_ranges([(10, 10, 30, 30)])
        out.append((np.asarray(ranges).tolist(),
                    p2.groups_for_ranges(ranges)))
        with pytest.raises(ValueError) as e:
            part_cls(3, starts=[0, 5, 3], owners=[0, 1, 2])
        out.append(str(e.value))
        return out
    j, t = both(run)
    assert t == j


# -- TestSplitPoint ------------------------------------------------------------

def test_histogram_counts_rows():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 1, n=200)
        h = m(P, "index.splitter").prefix_histogram(
            oracle, "pts", 0, m(P, "cluster.partition")._N_PREFIXES)
        assert int(h.sum()) == 200
        cluster.close()
        return np.flatnonzero(h).tolist(), h[h > 0].tolist()
    j, t = both(run)
    assert t == j


# -- TestMigrateOnline ---------------------------------------------------------

def test_split_hot_group_exact():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"])
        hot = hottest_group(cluster)
        pre = {g["name"]: g["rows"] for g in cluster.topology()["groups"]}
        entry = cluster.resharder.split(hot)
        assert entry["op"] == "migrate" and entry["src"] == hot
        assert entry["rows_moved"] > 0 and cluster._part.epoch == 1
        per = assert_exact(cluster, oracle)
        post = {g["name"]: g["rows"] for g in cluster.topology()["groups"]}
        assert post[hot] < pre[hot]
        assert post[entry["dst"]] == pre[entry["dst"]] + entry["rows_moved"]
        out = steady(entry), per, steady(cluster.topology())
        cluster.close()
        return out
    j, t = both(run)
    assert t == j


def test_migrate_validates_range_and_groups():
    def run(P):
        cluster, _, _ = make_cluster(P, 2, names=["a", "b"])
        r = cluster.resharder
        n = m(P, "cluster.partition")._N_PREFIXES
        errs = []
        for call in (lambda: r.migrate(0, 10, "a", "a"),
                     lambda: r.migrate(10, 5, "a", "b"),
                     lambda: r.migrate(0, 10, "nope", "b"),
                     lambda: r.migrate(n - 10, n, "a", "b"),
                     r.resume, r.abort):
            with pytest.raises(cl(P).ReshardError) as e:
                call()
            errs.append(str(e.value))
        cluster.close()
        return errs
    j, t = both(run)
    assert t == j


def test_topology_surface_and_post_flip_writes():
    def run(P):
        cluster, oracle, sft = make_cluster(P, 2, names=["east", "west"])
        topo0 = cluster.topology()
        assert topo0["epoch"] == 0 and topo0["n_groups"] == 2
        cluster.resharder.split("east")
        topo1 = cluster.topology()
        hist = cluster.resharder.status()["history"]
        assert topo1["epoch"] == 1 and len(hist) == 1
        batch = P.FeatureBatch.from_dict(
            sft, np.array(["post-1", "post-2"], dtype=object),
            {"geom": (np.array([105.0, 107.0]), np.array([42.0, 43.0])),
             "dtg": np.int64([1704067200000, 1704067200001]),
             "name": np.array(["nx", "nx"], dtype=object)})
        cluster.write("pts", batch)
        oracle.write("pts", batch)
        assert cluster_ids(cluster, "name = 'nx'") == {"post-1", "post-2"}
        per = assert_exact(cluster, oracle)
        out = steady(topo0), steady(topo1), steady(hist), per
        cluster.close()
        return out
    j, t = both(run)
    assert t == j


# -- TestDurableMigration ------------------------------------------------------

def test_wal_tail_migration_exact(tmp_path):
    def run(P):
        cluster, oracle, _ = make_cluster(
            P, 3, names=["g0", "g1", "g2"],
            groups=durable_groups(P, tmp_path))
        drop = [f"f{i}" for i in range(0, 60)]
        cluster.delete("pts", drop)
        oracle.delete("pts", drop)
        entry = cluster.resharder.split(hottest_group(cluster))
        assert entry["barrier_lsn"] is not None
        per = assert_exact(cluster, oracle)
        res = cluster.query("INCLUDE", "pts")
        assert res.topology_epoch == 1
        cluster.close()
        return steady(entry), per, cluster.lsn_vector()
    j, t = both(run)
    assert t == j


def test_stale_epoch_write_fenced(tmp_path):
    def run(P):
        cluster, _, sft = make_cluster(P, 3, names=["g0", "g1", "g2"],
                                       groups=durable_groups(P, tmp_path))
        cluster.resharder.split(hottest_group(cluster))
        batch = P.FeatureBatch.from_dict(
            sft, np.array(["z1"], dtype=object),
            {"geom": (np.array([105.0]), np.array([42.0])),
             "dtg": np.int64([1704067200000]),
             "name": np.array(["zz"], dtype=object)})
        with pytest.raises(cl(P).StaleTopologyError) as ei:
            cluster.write("pts", batch, topology_epoch=0)
        assert ei.value.current == 1
        assert cluster_ids(cluster, "name = 'zz'") == set()
        cluster.write("pts", batch, topology_epoch=1)
        assert cluster_ids(cluster, "name = 'zz'") == {"z1"}
        cluster.close()
        return str(ei.value), ei.value.epoch, ei.value.current
    j, t = both(run)
    assert t == j


# -- TestKillSwitch / TestPlanInvalidation -------------------------------------

def test_disabled_refuses_and_stays_bit_identical(reset_knobs):
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"])
        m(P, "cluster.reshard").RESHARD_ENABLED.set("false")
        errs = []
        for call in (lambda: cluster.resharder.split("a"),
                     lambda: cluster.resharder.migrate(0, 10, "a", "b")):
            with pytest.raises(cl(P).ReshardError) as e:
                call()
            errs.append(str(e.value))
        assert cluster._part.epoch == 0
        rng = np.random.default_rng(5)
        x, y = rng.uniform(-180, 180, 500), rng.uniform(-90, 90, 500)
        assert (cluster._part.owners_xy(x, y)
                == cl(P).ZPrefixPartitioner(3).owners_xy(x, y)).all()
        per = assert_exact(cluster, oracle)
        dec = cl(P).Autoscaler(cluster).run_once(now=0.0)
        assert dec["action"] == "none" and "enabled=false" in dec["blocked"]
        cluster.close()
        return errs, per, steady(dec)
    j, t = both(run)
    assert t == j


def test_prune_plan_tracks_epoch():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"])
        hot_bbox = "BBOX(geom, 100, 40, 112, 46)"
        assert cluster_ids(cluster, hot_bbox) == cluster_ids(oracle,
                                                             hot_bbox)
        plan0 = cluster.last_plan()
        entry = cluster.resharder.split(hottest_group(cluster))
        assert cluster_ids(cluster, hot_bbox) == cluster_ids(oracle,
                                                             hot_bbox)
        plan1 = cluster.last_plan()
        assert (plan0["topology_epoch"], plan1["topology_epoch"]) == (0, 1)
        assert entry["dst"] in plan1["contacted"]
        cluster.close()
        return plan0, plan1
    j, t = both(run)
    assert t == j


# -- TestCrashSafety -----------------------------------------------------------

def crash_at(resharder, tag):
    def hook(t):
        if t == tag:
            raise RuntimeError(f"injected crash @ {t}")
    resharder.fault_hook = hook


PHASES = ("snapshot.start", "snapshot.done", "catchup.done", "flip.enter",
          "flip.barrier", "flip.copy", "flip.copied", "flip.delete_src",
          "flip.swap")


def test_phases_equal_reference():
    assert (m(J, "cluster").Resharder.PHASES
            == m(T, "cluster").Resharder.PHASES == PHASES)


@pytest.mark.parametrize("tag", PHASES)
def test_kill_point_then_resume(tag):
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"], n=300)
        r = cluster.resharder
        crash_at(r, tag)
        with pytest.raises(RuntimeError, match="injected crash"):
            r.split(hottest_group(cluster))
        mig = r._active
        assert mig is not None
        state = (mig.phase, mig.blocking, steady(mig.describe()))
        if mig.blocking:
            with pytest.raises(cl(P).ReshardError) as e:
                cluster.count("pts")
            state += (str(e.value),)
        else:
            state += (assert_exact(cluster, oracle),)
        r.fault_hook = None
        entry = r.resume()
        assert entry["epoch"] == 1 and r._active is None
        per = assert_exact(cluster, oracle)
        cluster.close()
        return state, steady(entry), per
    j, t = both(run)
    assert t == j


@pytest.mark.parametrize("tag", ["flip.copied", "flip.delete_src"])
def test_kill_point_then_abort(tag):
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"], n=300)
        r = cluster.resharder
        crash_at(r, tag)
        with pytest.raises(RuntimeError, match="injected crash"):
            r.split(hottest_group(cluster))
        r.fault_hook = None
        entry = r.abort()
        assert entry["op"] == "abort" and cluster._part.epoch == 0
        assert r._active is None
        per = assert_exact(cluster, oracle)
        cluster.close()
        return steady(entry), per
    j, t = both(run)
    assert t == j


def test_durable_kill_points(tmp_path):
    def run(P):
        out = []
        DurableStore = m(P, "wal").DurableStore
        for i, tag in enumerate(("snapshot.done", "flip.barrier",
                                 "flip.delete_src")):
            groups = [DurableStore(P.store(),
                                   tmp_path / P.name / f"r{i}g{k}",
                                   fsync="never") for k in range(3)]
            cluster, oracle, _ = make_cluster(
                P, 3, names=["a", "b", "c"], groups=groups, n=300)
            r = cluster.resharder
            crash_at(r, tag)
            with pytest.raises(RuntimeError, match="injected crash"):
                r.split(hottest_group(cluster))
            r.fault_hook = None
            entry = r.resume()
            assert cluster._part.epoch == 1
            out.append((steady(entry), assert_exact(cluster, oracle)))
            cluster.close()
        return out
    j, t = both(run)
    assert t == j


# -- TestConcurrentQueries -----------------------------------------------------

def test_queries_exact_or_typed_during_migration():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"], n=400)
        want = cluster_ids(oracle)
        r = cluster.resharder

        def slow_hook(tag):
            import time as _t
            _t.sleep(0.02)
        r.fault_hook = slow_hook
        errors, wrong = [], []
        done = threading.Event()

        def reader():
            while not done.is_set():
                try:
                    got = cluster_ids(cluster)
                except cl(P).ReshardError:
                    continue
                except Exception as e:  # noqa: BLE001 - collected
                    errors.append(e)
                    return
                if got != want:
                    wrong.append(got)
                    return

        threads = [threading.Thread(target=reader, daemon=True)
                   for _ in range(3)]
        for th in threads:
            th.start()
        try:
            entry = r.split(hottest_group(cluster))
        finally:
            done.set()
            for th in threads:
                th.join(5.0)
        assert not errors and not wrong and cluster._part.epoch == 1
        per = assert_exact(cluster, oracle)
        cluster.close()
        # the destination is the group with the lowest observed leg
        # p99, which the concurrent readers make a race
        return ({k: entry[k] for k in ("epoch", "op", "src", "prefix_lo",
                                       "prefix_hi", "rows_moved")},
                sum(per))
    j, t = both(run)
    assert t == j


# -- TestAutoscaler ------------------------------------------------------------

def scaler_of(P, cluster, lat, **kw):
    scaler = cl(P).Autoscaler(cluster, **kw)
    scaler.observe = lambda: dict(lat)
    return scaler


def hot_lat(cluster):
    hot = hottest_group(cluster)
    return {n: (0.5 if n == hot else 0.01) for n in ("a", "b", "c")}


def test_sustain_then_propose(reset_knobs):
    def run(P):
        cluster, _, _ = make_cluster(P, 3, names=["a", "b", "c"])
        scaler = scaler_of(P, cluster, hot_lat(cluster))
        d0 = scaler.run_once(now=0.0)
        assert d0["action"] == "split" and "sustain" in d0["blocked"]
        d1 = scaler.run_once(now=11.0)
        assert d1["blocked"] == "geomesa.reshard.auto=false (propose-only)"
        assert not d1["executed"] and cluster._part.epoch == 0
        cluster.close()
        return d0, d1
    j, t = both(run)
    assert t == j


def test_auto_fires_and_cooldown_guards(reset_knobs):
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, names=["a", "b", "c"])
        m(P, "cluster.autoscale").RESHARD_AUTO.set("true")
        scaler = scaler_of(P, cluster, hot_lat(cluster))
        scaler.run_once(now=0.0)
        d = scaler.run_once(now=12.0)
        assert d["executed"] is True and d["result"]["epoch"] == 1
        per = assert_exact(cluster, oracle)
        scaler.run_once(now=13.0)
        d2 = scaler.run_once(now=25.0)
        assert d2["action"] == "split" and not d2["executed"]
        assert "cooldown" in d2["blocked"]
        cluster.close()
        d2 = dict(d2, blocked=d2["blocked"].split(":")[0])
        return steady(d), per, steady(d2)
    j, t = both(run)
    assert t == j


def test_slo_fast_burn_and_uniform_slowness(reset_knobs):
    class Burning:
        def evaluate(self, now=None):
            return {"query": {"fast_firing": True}}

    def run(P):
        cluster, _, _ = make_cluster(P, 3, names=["a", "b", "c"])
        d = scaler_of(P, cluster, hot_lat(cluster),
                      slo=Burning()).run_once(now=0.0)
        assert d["action"] == "split" and d["slo_fast_burning"] is True
        assert d["blocked"] == "geomesa.reshard.auto=false (propose-only)"
        flat = scaler_of(P, cluster, {"a": 0.5, "b": 0.49, "c": 0.51})
        decisions = [flat.run_once(now=now) for now in (0.0, 20.0, 40.0)]
        assert all(x["action"] == "none" for x in decisions)
        noise = scaler_of(P, cluster, {"a": 0.004, "b": 0.0001,
                                       "c": 0.0001}).run_once(now=0.0)
        assert noise["action"] == "none"
        cluster.close()
        return d, decisions, noise
    j, t = both(run)
    assert t == j


# -- the device rules ----------------------------------------------------------

def test_migration_stages_on_the_source_device():
    cluster, _, _ = make_cluster(T, 2, names=["a", "b"])
    r = cluster.resharder
    crash_at(r, "snapshot.done")
    with pytest.raises(RuntimeError, match="injected crash"):
        r.split("a")
    assert r._active.pending.device == torch.device("cpu")
    r.fault_hook = None
    r.abort()
    cluster.close()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_split_stages_on_the_card():
    """A split of a CUDA cluster stages on the groups' card and stays
    id-exact against one CUDA store across the flip."""
    P = T
    sft = P.parse_spec("pts", SPEC)
    groups = [P.Store() for _ in range(3)]
    cluster = cl(P).ClusterDataStore(groups, names=["a", "b", "c"])
    oracle = P.Store()
    ids, cols = hot_seeded(60_000)
    for st in (cluster, oracle):
        st.create_schema(sft)
        st.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    seen = []
    r = cluster.resharder
    r.fault_hook = lambda tag: seen.append(
        r._active.pending.device.type) if tag == "flip.enter" else None
    try:
        entry = r.split(hottest_group(cluster))
        assert seen == ["cuda"] and entry["rows_moved"] > 0
        assert_exact(cluster, oracle)
    finally:
        cluster.close()


@needs_jax
def test_reshard_error_reaches_the_server():
    """The server imports ``ReshardError`` from the port's cluster tier
    (no fallback): a refused split maps to 409 as in the reference."""
    server = importlib.import_module("geomesa_tpu_torch.web.server")
    src = open(server.__file__).read()
    assert "from ..cluster.reshard import ReshardError" in src
    assert "ImportError" not in src.split("def _reshard")[1].split(
        "def ")[0]
