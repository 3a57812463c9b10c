"""The port's replication tier (``geomesa_tpu_torch.replication``)
against the JAX package's on the CPU.

Every scenario of ``tests/test_replication.py``, the anti-entropy cases
of ``tests/test_integrity.py`` and the replicated staleness case of
``tests/test_result_cache.py`` runs in both packages (``both(fn)``) on
stores built from the same rows (the port's on ``device="cpu"``): each
run keeps the reference test's own assertions, and the outcomes (ids,
counts, LSNs, statuses with times left out, error types) must be equal.
Timing-driven outcomes use the reference's deadlines and are asserted
as outcomes: promoted, no acked write lost, the most caught-up replica
chosen. The wire runs across packages both ways: a JAX shipper feeds a
port replica and a port shipper feeds a JAX replica.

The ``gpu`` test at the end bootstraps and streams a replica on CUDA
from a CUDA primary (``python -m pytest --noconftest -m gpu
tests/test_torch_replication.py``).

Every shipper binds port 0, every replica, router, shipper and server
stops in a ``finally`` and every wait is bounded."""

import importlib
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"
VOLATILE = {"last_error", "read_latency", "failover_seconds", "lsn", "seconds",
            "healthy", "type"}


def _ns(pkg, cpu):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    repl = m("replication")
    store = m("store.memory").InMemoryDataStore

    def make_store(**kw):
        if cpu:
            kw.setdefault("device", "cpu")
        return store(**kw)

    def replica(host, port, **kw):
        if cpu and kw.get("store") is None:
            kw.setdefault("device", "cpu")
        return repl.Replica(host, port, **kw)

    return types.SimpleNamespace(
        name=pkg, pkg=pkg, m=m, store=make_store, Store=store,
        Replica=replica, ReplicaClass=repl.Replica,
        WalShipper=repl.WalShipper,
        ReplicatedDataStore=repl.ReplicatedDataStore,
        ReadOnlyReplicaError=repl.ReadOnlyReplicaError,
        ReplicationAckTimeout=repl.ReplicationAckTimeout,
        ReplicationAckLost=m("replication.router").ReplicationAckLost,
        FeatureBatch=m("features").FeatureBatch,
        parse_spec=m("features").parse_spec,
        metrics=m("metrics").metrics)


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


def steady(obj):
    if isinstance(obj, dict):
        return {k: steady(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [steady(v) for v in obj]
    return obj


def primary_of(P, root, **kw):
    kw.setdefault("wal_fsync", "never")
    ds = P.store(durable_dir=str(root), **kw)
    ds.create_schema(P.parse_spec("pts", SPEC))
    return ds


def write(P, ds, ids):
    """One batch keyed by ``ids`` through any DataStore (the reference
    suite's ``_write``)."""
    sft = P.parse_spec("pts", SPEC)
    n = len(ids)
    return ds.write("pts", P.FeatureBatch.from_dict(
        sft, list(ids),
        {"name": [f"n{i % 7}" for i in range(n)],
         "age": np.arange(n),
         "dtg": np.full(n, 10 ** 11),
         "geom": (np.linspace(-99.0, -61.0, n),
                  np.linspace(26.0, 49.0, n))}))


def ids_of(ds, tn="pts"):
    res = ds.query("INCLUDE", tn)
    return sorted([] if res.batch is None else map(str, res.ids))


def wait(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def caught_up(primary, *replicas):
    tail = primary.journal.wal.last_lsn
    return lambda: all(r.applied_lsn >= tail for r in replicas)


def counter(P, name):
    return P.metrics.snapshot()["counters"].get(name, 0)


def test_exports_equal_reference():
    j = importlib.import_module("geomesa_tpu.replication")
    t = importlib.import_module("geomesa_tpu_torch.replication")
    assert j.__all__ == t.__all__
    for mod in ("sync", "shipper", "replica", "router"):
        jm = importlib.import_module(f"geomesa_tpu.replication.{mod}")
        tm = importlib.import_module(f"geomesa_tpu_torch.replication.{mod}")
        assert jm.__all__ == tm.__all__, mod


# -- TestReplicaCatchUp --------------------------------------------------------

def test_id_for_id_equivalence_streaming(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        write(P, primary, [f"a{i}" for i in range(60)])
        ship = P.WalShipper(primary.journal)
        r = P.Replica(ship.host, ship.port, name="r1")
        try:
            write(P, primary, [f"b{i}" for i in range(40)])
            primary.delete("pts", ["a0", "a1", "b39"])
            wait(caught_up(primary, r), what="replica catch-up")
            got = ids_of(r)
            assert got == ids_of(primary)
            counts = (r.count("pts"), r.query_count("age < 10", "pts"))
            assert counts == (primary.count("pts"),
                              primary.query_count("age < 10", "pts"))
            write(P, primary, ["late1", "late2"])
            wait(caught_up(primary, r), what="tail catch-up")
            assert ids_of(r) == ids_of(primary)
            return got, counts, ids_of(r), r.applied_lsn
        finally:
            r.stop()
            ship.stop()
    j, t = both(run)
    assert t == j


def test_replica_refuses_writes_until_promoted(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        ship = P.WalShipper(primary.journal)
        r = P.Replica(ship.host, ship.port, name="ro")
        try:
            with pytest.raises(P.ReadOnlyReplicaError):
                write(P, r, ["x"])
            with pytest.raises(P.ReadOnlyReplicaError) as e:
                r.delete("pts", ["x"])
            wait(caught_up(primary, r), what="schema record")
            r.promote()
            write(P, r, ["x"])
            return str(e.value), r.count("pts"), r.promoted, r.attached
        finally:
            r.stop()
            ship.stop()
    j, t = both(run)
    assert t == j == (j[0], 1, True, False)


def test_bootstrap_from_checkpoint(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        write(P, primary, [f"a{i}" for i in range(50)])
        primary.delete("pts", ["a7", "a8"])
        info = primary.journal.checkpoint(primary, keep=1)
        assert info["lsn"] > 0
        primary.journal.wal.truncate_below(info["lsn"])
        write(P, primary, [f"post{i}" for i in range(10)])
        ship = P.WalShipper(primary.journal)
        r = P.Replica(ship.host, ship.port, name="boot")
        try:
            wait(caught_up(primary, r), what="bootstrap catch-up")
            assert r.bootstraps == 1
            assert "a7" not in set(ids_of(r))
            return info["lsn"], ids_of(r), r.applied_lsn, r.bootstraps
        finally:
            r.stop()
            ship.stop()
    j, t = both(run)
    assert t == j


# -- TestRouter ----------------------------------------------------------------

def test_reads_fan_to_replicas_writes_ack(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        ship = P.WalShipper(primary.journal)
        replicas = [P.Replica(ship.host, ship.port, name=f"r{i}")
                    for i in range(2)]
        router = P.ReplicatedDataStore(primary, replicas, ack_replicas=1,
                                       max_lag_lsn=10_000, max_lag_s=60)
        try:
            before = counter(P, "replication.reads.replica")
            write(P, router, [f"f{i}" for i in range(30)])
            lsn = primary.journal.wal.last_lsn
            assert max(r.applied_lsn for r in replicas) >= lsn
            wait(caught_up(primary, *replicas), what="both replicas")
            counts = [router.count("pts") for _ in range(4)]
            got = sorted(router.query("INCLUDE", "pts").ids)
            assert got == ids_of(primary)
            assert counter(P, "replication.reads.replica") - before >= 5
            st = router.replication_status()
            assert all(e["eligible"] for e in st["replicas"])
            return counts, got, steady(st)
        finally:
            router.close()
            ship.stop()
    j, t = both(run)
    assert t == j
    assert t[0] == [30] * 4


def test_staleness_bound_falls_back_to_primary(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        write(P, primary, [f"f{i}" for i in range(20)])
        stale = P.Replica("127.0.0.1", 1, name="stale", start=False)
        router = P.ReplicatedDataStore(primary, [stale], ack_replicas=0)
        try:
            before = counter(P, "replication.reads.fallback")
            out = (router.query_count("INCLUDE", "pts", max_lag_lsn=0),
                   router.count("pts"))
            assert counter(P, "replication.reads.fallback") - before == 2
            st = router.replication_status()
            assert st["replicas"][0]["eligible"] is False
            return out, steady(st)
        finally:
            router.close()
    j, t = both(run)
    assert t == j
    assert t[0] == (20, 20)


def test_unreplicated_write_times_out_ack(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        mute = P.Replica("127.0.0.1", 1, name="mute", start=False)
        router = P.ReplicatedDataStore(primary, [mute], ack_replicas=1)
        router.ack_timeout_s = 0.3
        try:
            with pytest.raises(P.ReplicationAckTimeout) as e:
                write(P, router, ["w1"])
            return str(e.value), primary.count("pts")
        finally:
            router.close()
    j, t = both(run)
    assert t == j
    assert t[1] == 1


def test_ack_skipped_with_no_attached_replicas(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        router = P.ReplicatedDataStore(primary, [], ack_replicas=2)
        try:
            write(P, router, ["solo"])
            return router.count("pts"), steady(router.replication_status())
        finally:
            router.close()
    j, t = both(run)
    assert t == j
    assert t[0] == 1


# -- TestFailover --------------------------------------------------------------

def test_manual_promote_keeps_acked_writes(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        ship = P.WalShipper(primary.journal)
        replicas = [P.Replica(ship.host, ship.port, name=f"r{i}")
                    for i in range(2)]
        router = P.ReplicatedDataStore(primary, replicas, ack_replicas=1,
                                       auto_promote=False)
        acked = []
        try:
            for batch in range(5):
                ids = [f"b{batch}_{i}" for i in range(10)]
                write(P, router, ids)
                acked.extend(ids)
            ship.stop()
            info = router.promote()
            assert info["promoted"] in {"r0", "r1"}
            assert set(acked) <= set(ids_of(router))
            write(P, router, ["after1", "after2"])
            n = router.count("pts")
            assert n == len(acked) + 2
            st = router.replication_status()
            assert st["promoted_to"] == info["promoted"]
            # which replica won is a race; the prefix it holds is not
            return (info["applied_lsn"], sorted(
                [info["promoted"]] + info["detached"]), ids_of(router), n)
        finally:
            router.close()
    j, t = both(run)
    assert t == j


def test_promote_picks_most_caught_up(tmp_path):
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        ship = P.WalShipper(primary.journal)
        ahead = P.Replica(ship.host, ship.port, name="ahead")
        behind = P.Replica("127.0.0.1", 1, name="behind", start=False)
        router = P.ReplicatedDataStore(primary, [ahead, behind],
                                       ack_replicas=1, auto_promote=False)
        try:
            write(P, router, [f"f{i}" for i in range(10)])
            ship.stop()
            return router.promote()
        finally:
            router.close()
    j, t = both(run)
    assert t == j
    assert t["promoted"] == "ahead" and t["detached"] == ["behind"]


def test_auto_promote_zero_acked_write_loss(tmp_path):
    """Kill the primary mid-ingest (web server, shipper and proxy down):
    the probe promotes a replica by itself, every acknowledged write
    survives and reads and writes go on, in both packages."""
    def run(P):
        primary = primary_of(P, tmp_path / P.name)
        srv = P.m("web").GeoMesaWebServer(primary).start()
        res = P.m("resilience")
        proxy = res.ChaosProxy("127.0.0.1", srv.port).start()
        remote = P.m("store.remote").RemoteDataStore(
            "127.0.0.1", proxy.port, timeout_s=2.0,
            retry_policy=res.RetryPolicy(max_attempts=2, base_s=0.02,
                                         cap_s=0.05, total_deadline_s=1.0))
        ship = P.WalShipper(primary.journal)
        replicas = [P.Replica(ship.host, ship.port, name=f"r{i}")
                    for i in range(2)]
        router = P.ReplicatedDataStore(primary=remote, replicas=replicas,
                                       ack_replicas=1, auto_promote=True,
                                       probe_ms=50, probe_failures=2,
                                       max_lag_lsn=10_000, max_lag_s=60)
        acked = []
        try:
            for batch in range(4):
                ids = [f"b{batch}_{i}" for i in range(8)]
                write(P, router, ids)
                acked.extend(ids)
            srv.stop()
            ship.stop()
            proxy.stop()
            try:
                write(P, router, ["lost_in_flight"])
            except Exception:   # noqa: BLE001 - unacked: may vanish
                pass
            wait(lambda: isinstance(router.primary, P.ReplicaClass),
                 timeout_s=10.0, what="auto-promotion")
            st = router.replication_status()
            assert st["promoted_to"] in {"r0", "r1"}
            assert st.get("failover_seconds", 0) >= 0
            survived = set(ids_of(router))
            assert not set(acked) - survived
            assert router.count("pts") >= len(acked)
            write(P, router, ["post_failover"])
            assert "post_failover" in set(ids_of(router))
            return sorted(set(acked)), type(router.primary).__name__
        finally:
            router.close()
            proxy.stop()
    j, t = both(run)
    assert t == j


# -- cross-package wire --------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_wire_across_packages(tmp_path, direction):
    """One package's shipper feeds the other's replica: bootstrap from a
    checkpoint, stream the tail (a delete included), a router acks over
    it, the digest op agrees and the promoted replica takes writes."""
    src, dst = (J, T) if direction == "jax_to_torch" else (T, J)
    primary = primary_of(src, tmp_path / "p")
    write(src, primary, [f"a{i}" for i in range(40)])
    primary.journal.checkpoint(primary, keep=1)
    write(src, primary, [f"b{i}" for i in range(25)])
    primary.delete("pts", ["a3", "b24"])
    ship = src.WalShipper(primary.journal, store=primary)
    r = dst.Replica(ship.host, ship.port, name="x")
    router = src.ReplicatedDataStore(primary, [r], ack_replicas=1,
                                     auto_promote=False)
    try:
        wait(caught_up(primary, r), what="cross-package catch-up")
        assert r.bootstraps == 1
        write(src, router, ["acked1", "acked2"])
        assert r.applied_lsn >= primary.journal.wal.last_lsn
        assert ids_of(r) == ids_of(primary)
        assert r.query_count("age < 10", "pts") == \
            primary.query_count("age < 10", "pts")
        out = dst.m("integrity.scrub").Scrubber(
            replica=r, interval_s=999).run_once()
        assert out["ok"] and out["anti_entropy"]["checked"]
        ship.stop()
        info = router.promote()
        assert info["promoted"] == "x"
        write(dst, r, ["after"])
        assert "after" in ids_of(r) and "acked2" in ids_of(r)
    finally:
        router.close()
        ship.stop()


# -- anti-entropy (tests/test_integrity.py TestAntiEntropy) -------------------

AE_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


def ae_batch(P, sft, ids, seed=7):
    rng = np.random.default_rng(seed)
    n = len(ids)
    return P.FeatureBatch.from_dict(sft, ids, {
        "name": [f"n{i % 5}" for i in range(n)],
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


def test_digest_mismatch_triggers_rebootstrap(tmp_path):
    def run(P):
        Scrubber = P.m("integrity.scrub").Scrubber
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        sft = P.parse_spec("t", AE_SPEC)
        primary.create_schema(sft)
        primary.write("t", ae_batch(P, sft, [f"f{i}" for i in range(25)]))
        ship = P.WalShipper(primary.journal, store=primary)
        r = P.Replica(ship.host, ship.port, name="ae")
        try:
            tail = primary.journal.wal.last_lsn
            wait(lambda: r.applied_lsn >= tail, what="catch-up")
            boots = r.bootstraps
            r._store.write("t", ae_batch(P, sft, ["evil"], seed=99))
            assert ids_of(r, "t") != ids_of(primary, "t")
            out = Scrubber(replica=r, interval_s=999).run_once()
            assert not out["ok"]
            anti = out["anti_entropy"]
            assert anti["checked"] and anti["mismatch"] == ["t"]
            assert anti["rebootstrap"]
            wait(lambda: r.bootstraps > boots and r.applied_lsn >= tail
                 and ids_of(r, "t") == ids_of(primary, "t"),
                 what="re-bootstrap convergence")
            again = Scrubber(replica=r, interval_s=999).run_once()
            assert again["ok"]
            return steady(out), steady(again), ids_of(r, "t")
        finally:
            r.stop()
            ship.stop()
            primary.close()
    j, t = both(run)
    assert t == j


def test_lagging_replica_not_condemned(tmp_path):
    def run(P):
        Scrubber = P.m("integrity.scrub").Scrubber
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        sft = P.parse_spec("t", AE_SPEC)
        primary.create_schema(sft)
        primary.write("t", ae_batch(P, sft, ["a", "b"]))
        ship = P.WalShipper(primary.journal, store=primary)
        r = P.Replica(ship.host, ship.port, name="lag", start=False)
        try:
            out = Scrubber(replica=r, interval_s=999).run_once()
            assert out["ok"]
            assert not out["anti_entropy"]["checked"]
            return steady(out)
        finally:
            r.stop()
            ship.stop()
            primary.close()
    j, t = both(run)
    assert t == j


def test_bootstrap_rejects_tampered_checkpoint(tmp_path):
    def run(P):
        sync = P.m("replication.sync")
        root = str(tmp_path / P.name)
        primary = P.store(durable_dir=root, wal_fsync="never")
        sft = P.parse_spec("t", AE_SPEC)
        primary.create_schema(sft)
        primary.write("t", ae_batch(P, sft, [f"f{i}" for i in range(25)]))
        primary.checkpoint()
        path = os.path.join(P.m("wal.snapshot").checkpoint_dirs(root)[-1][1],
                            "t.bin")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x01]))
        ship = P.WalShipper(primary.journal, store=primary)
        target = P.store()
        client = sync.ReplClient(ship.host, ship.port)
        try:
            with pytest.raises(sync.BootstrapError,
                               match="sha256 mismatch") as e:
                sync.bootstrap_from_checkpoint(client, target)
            return str(e.value).split(": ", 1)[1], target.get_type_names()
        finally:
            client.close()
            ship.stop()
            primary.close()
    j, t = both(run)
    assert t == j


def test_scrubber_needs_a_journal_or_a_replica():
    def run(P):
        with pytest.raises(ValueError) as e:
            P.m("integrity.scrub").Scrubber()
        return str(e.value)
    j, t = both(run)
    assert t == j


# -- the replicated staleness bound (tests/test_result_cache.py) --------------

def test_replicated_density_honours_staleness(tmp_path):
    """A replicated density read never implies an applied prefix older
    than the lag bound, while a writer keeps appending."""
    def run(P):
        sft = P.parse_spec("rpts", "*geom:Point:srid=4326")
        prim = P.store(durable_dir=str(tmp_path / P.name),
                       wal_fsync="never")
        prim.create_schema(sft)
        base = 20
        prim.write("rpts", P.FeatureBatch.from_dict(
            sft, [f"b{i}" for i in range(base)],
            {"geom": (np.full(base, 0.5), np.full(base, 0.5))}))
        base_lsn = prim.journal.wal.last_lsn
        lag = 25
        ship = P.WalShipper(prim.journal)
        replica = P.Replica(ship.host, ship.port, name="r0")
        router = P.ReplicatedDataStore(prim, [replica], ack_replicas=0,
                                       max_lag_lsn=lag, max_lag_s=600)
        try:
            wait(lambda: replica.applied_lsn >= base_lsn, 15.0)
            violations = []

            def writer():
                for j in range(60):
                    prim.write("rpts", P.FeatureBatch.from_dict(
                        sft, [f"x{j}"], {"geom": (np.full(1, 0.5),
                                                  np.full(1, 0.5))}))
                    time.sleep(0.002)

            w = threading.Thread(target=writer)
            w.start()
            reads = 0
            while w.is_alive() or reads < 10:
                lsn_pre = prim.journal.wal.last_lsn
                g = router.density("rpts", "INCLUDE",
                                   (0.0, 0.0, 1.0, 1.0), 4, 4)
                implied = (base_lsn - base
                           + int(round(float(np.sum(np.asarray(g))))))
                reads += 1
                if implied < lsn_pre - lag:
                    violations.append((lsn_pre, implied))
                if reads > 400:
                    break
            w.join()
            assert not violations, violations[:3]
            assert reads >= 10
            wait(caught_up(prim, replica))
            return (float(np.sum(router.density(
                "rpts", "INCLUDE", (0.0, 0.0, 1.0, 1.0), 4, 4))),
                replica.applied_lsn)
        finally:
            router.close()
            ship.stop()
    j, t = both(run)
    assert t == j == (80.0, j[1])


# -- the device rules ----------------------------------------------------------

def test_replica_without_store_is_on_the_card():
    """``Replica`` without a store builds ``InMemoryDataStore`` on
    ``device`` (None: CUDA), which raises without a card."""
    r = T.ReplicaClass("127.0.0.1", 1, start=False, device="cpu")
    assert r.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.ReplicaClass("127.0.0.1", 1, start=False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.Store()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_replica_bootstraps_and_streams(tmp_path):
    """A replica on CUDA bootstraps from a CUDA primary's checkpoint,
    streams the tail and answers a box count through the scan kernel."""
    kernels = importlib.import_module("geomesa_tpu_torch.scan.kernels")
    primary = T.Store(durable_dir=str(tmp_path / "p"), wal_fsync="never")
    sft = T.parse_spec("pts", SPEC)
    primary.create_schema(sft)
    rng = np.random.default_rng(9)
    n = 200_000

    def batch(i0, m):
        return T.FeatureBatch.from_dict(
            sft, [f"f{i}" for i in range(i0, i0 + m)],
            {"name": [f"n{i % 7}" for i in range(m)],
             "age": np.arange(m), "dtg": np.full(m, 10 ** 11),
             "geom": (rng.uniform(-180, 180, m), rng.uniform(-90, 90, m))})

    primary.write("pts", batch(0, n))
    primary.checkpoint()
    ship = T.WalShipper(primary.journal, store=primary)
    r = T.ReplicaClass(ship.host, ship.port, name="cuda")
    try:
        assert r.device.type == "cuda"
        primary.write("pts", batch(n, 1000))
        primary.delete("pts", ["f0", "f1"])
        wait(caught_up(primary, r), 60.0, "cuda replica catch-up")
        assert r.bootstraps == 1
        assert r.count("pts") == primary.count("pts") == n + 998
        kernels.reset_launches()
        ecql = "BBOX(geom, -180, -90, 0, 90)"
        assert r.query_count(ecql, "pts") == primary.query_count(ecql, "pts")
        assert kernels.launches["scan_mask"] + \
            kernels.launches["scan_mask_gather"] >= 1
    finally:
        r.stop()
        ship.stop()
        primary.close()
