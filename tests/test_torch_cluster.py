"""The port's cluster tier (``geomesa_tpu_torch.cluster``) against the
JAX package's on the CPU.

Every class of ``tests/test_cluster.py`` but ``TestCli`` (the tools CLI
is queue 1 item 10), the pruning classes of ``tests/test_planner.py``,
the cluster streams of ``tests/test_streaming.py``, the cluster cases of
``tests/test_result_cache.py``, ``tests/test_qos.py`` and
``tests/test_obs.py`` run in both packages (``both(fn)``) on shard
groups built from the same rows (the port's on ``device="cpu"``). Each
run keeps the reference test's own assertions and the outcomes must be
equal: ids in order, counts, plans, partial flags with their missing
groups and z-ranges, LSN vectors, statuses with latencies left out and
error types. Density grids are held exactly where the weights are
integral (unweighted here); the port sums group grids in group order
(the reference in thread-completion order), so a weighted grid is held
at ``rtol=1e-6``. ``from_uri`` runs over either package's web server.

The ``gpu`` test at the end holds a 4-group CUDA cluster to one CUDA
store (``python -m pytest --noconftest -m gpu
tests/test_torch_cluster.py``).

Every server binds port 0 and stops in a ``finally``; every wait is
bounded."""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_replication import (J, PKGS, T, both, ids_of, needs_jax,
                                    wait)

SPEC = "*geom:Point:srid=4326,dtg:Date,name:String"
LATENCY = {"leg_latency", "read_latency", "p99_s", "ewma_s", "p99",
           "failover_seconds", "last_error", "type"}


def m(P, name):
    return importlib.import_module(f"{P.pkg}.{name}")


def cl(P):
    return m(P, "cluster")


def n_prefixes(P):
    return m(P, "cluster.partition")._N_PREFIXES


def seeded(n=400, seed=7):
    rng = np.random.default_rng(seed)
    ids = np.array([f"f{i}" for i in range(n)], dtype=object)
    cols = {
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
        "dtg": (np.int64(1704067200000)
                + np.arange(n, dtype=np.int64) * 3_600_000),
        "name": np.array([f"n{i % 13}" for i in range(n)], dtype=object),
    }
    return ids, cols


def make_cluster(P, k, n=400, names=None, **kw):
    """k in-memory shard groups + a single-store oracle, same rows."""
    sft = P.parse_spec("pts", SPEC)
    groups = [P.store() for _ in range(k)]
    cluster = cl(P).ClusterDataStore(groups, names=names, **kw)
    cluster.create_schema(sft)
    oracle = P.store()
    oracle.create_schema(sft)
    ids, cols = seeded(n)
    cluster.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    oracle.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    return cluster, oracle, sft


class DownGroup:
    """A shard group with every node gone: all calls fail fast."""

    def close(self):
        pass

    def __getattr__(self, name):
        def boom(*a, **kw):
            raise ConnectionError("shard group down")
        return boom


def strip(obj, drop=LATENCY):
    if isinstance(obj, dict):
        return {k: strip(v, drop) for k, v in obj.items() if k not in drop}
    if isinstance(obj, list):
        return [strip(v, drop) for v in obj]
    return obj


def qids(store, ecql, tn="pts"):
    res = store.query(ecql, tn)
    return [] if res.batch is None else [str(i) for i in res.ids]


def test_exports_equal_reference():
    for mod in ("cluster", "cluster.partition", "cluster.reshard",
                "cluster.coordinator", "cluster.autoscale"):
        assert (m(J, mod).__all__ == m(T, mod).__all__), mod


# -- TestPartitioner -----------------------------------------------------------

def test_partitioner_ranges_owners_and_hash():
    def run(P):
        part_cls = cl(P).ZPrefixPartitioner
        out = {}
        for n in (1, 2, 3, 4, 7, 16):
            ranges = [part_cls(n).prefix_range(g) for g in range(n)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n_prefixes(P)
            for (_, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert hi == lo2
            out[n] = ranges
        rng = np.random.default_rng(0)
        x, y = rng.uniform(-180, 180, 500), rng.uniform(-90, 90, 500)
        owners = part_cls(3).owners_xy(x, y)
        z = np.asarray(m(P, "curves.sfc").Z2SFC().index(
            x, y, lenient=True)).astype(np.uint64)
        prefix = (z >> np.uint64(62 - m(P, "cluster").PREFIX_BITS)
                  ).astype(int)
        for g in range(3):
            lo, hi = part_cls(3).prefix_range(g)
            sel = (prefix >= lo) & (prefix < hi)
            assert (owners[sel] == g).all()
        a = part_cls(4).owners_xy(x[:200], y[:200])
        assert (a == part_cls(4).owners_xy(x[:200], y[:200])).all()
        ids = [f"feat-{i}" for i in range(100)]
        h = part_cls(5).owners_ids(ids)
        assert (h == part_cls(5).owners_ids(ids)).all()
        r = part_cls(2).z_range(1)
        assert r["prefix_lo"] == n_prefixes(P) // 2
        return out, owners.tolist(), a.tolist(), h.tolist(), r
    j, t = both(run)
    assert t == j


# -- TestScatterExactness ------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_query_ids_exact(k):
    def run(P):
        cluster, oracle, _ = make_cluster(P, k)
        out = []
        for ecql in ("INCLUDE", "BBOX(geom, -60, -30, 60, 30)",
                     "name = 'n3'"):
            got = qids(cluster, ecql)
            assert set(got) == set(qids(oracle, ecql)), ecql
            out.append((got, strip(cluster.last_plan())))
        cluster.close()
        return out
    j, t = both(run)
    assert t == j


def test_counts_exact():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3)
        out = [cluster.count("pts")]
        assert out[0] == oracle.count("pts")
        for ecql in ("INCLUDE", "BBOX(geom, 0, 0, 90, 45)"):
            c = cluster.query_count(ecql, "pts")
            assert c == oracle.query_count(ecql, "pts")
            out.append(c)
        cluster.close()
        return out
    j, t = both(run)
    assert t == j


def test_sort_and_max_features():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3)
        q = m(P, "index.api").Query("pts", "INCLUDE", sort_by="name",
                                    max_features=37)
        got = cluster.query(q)
        assert got.n == oracle.query(q).n == 37
        names = [got.batch.col("name").value(i) for i in range(got.n)]
        assert names == sorted(names)
        cluster.close()
        return [str(i) for i in got.ids], names
    j, t = both(run)
    assert t == j


def test_stats_merge_exact():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3)
        spec = "MinMax(dtg);Count()"
        got = cluster.stats_query("pts", spec)
        assert got.to_json_object() == \
            oracle.stats_query("pts", spec).to_json_object()
        assert got.complete is True
        cluster.close()
        return got.to_json_object()
    j, t = both(run)
    assert t == j


@pytest.mark.parametrize("weighted", [False, True])
def test_density_sums(weighted):
    """Unweighted grids are exact; a weighted float32 grid is held at
    rtol=1e-6 (the reference sums group grids in thread-completion
    order, the port in group order)."""
    def run(P):
        sft = P.parse_spec("wpts", "*geom:Point:srid=4326,w:Double")
        groups = [P.store() for _ in range(4)]
        cluster = cl(P).ClusterDataStore(groups)
        oracle = P.store()
        rng = np.random.default_rng(12)
        n = 600
        batch = P.FeatureBatch.from_dict(
            sft, [f"w{i}" for i in range(n)],
            {"geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
             "w": rng.uniform(0.1, 3.3, n)})
        for st in (cluster, oracle):
            st.create_schema(sft)
            st.write("wpts", batch)
        bbox = (-180.0, -90.0, 180.0, 90.0)
        kw = {"weight_attr": "w"} if weighted else {}
        got = np.asarray(cluster.density("wpts", "INCLUDE", bbox, 32, 16,
                                          **kw))
        want = np.asarray(oracle.density("wpts", "INCLUDE", bbox, 32, 16,
                                         **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got.sum() > 0
        again = np.asarray(cluster.density("wpts", "INCLUDE", bbox, 32, 16,
                                           **kw))
        cluster.close()
        return got, again
    (jg, _), (tg, ta) = both(run)
    assert tg.tobytes() == ta.tobytes()     # group order: the same bits
    if weighted:
        np.testing.assert_allclose(tg, jg, rtol=1e-6)
    else:
        assert tg.tobytes() == jg.tobytes()


def test_bin_merge_exact():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3)
        got = cluster.bin_query("pts", "INCLUDE", sort=True)
        want = oracle.bin_query("pts", "INCLUDE", sort=True)
        rec = 16
        assert ({got[i:i + rec] for i in range(0, len(got), rec)}
                == {want[i:i + rec] for i in range(0, len(want), rec)})
        t = np.frombuffer(got, dtype="<i4").reshape(-1, 4)[:, 1]
        assert (np.diff(t) >= 0).all()
        cluster.close()
        return bytes(got)
    j, t = both(run)
    assert t == j


def test_arrow_ipc_merge_exact():
    def run(P):
        read = m(P, "arrow.io").read_ipc_batches
        cluster, oracle, sft = make_cluster(P, 3)
        ecql = "BBOX(geom, -90, -45, 90, 45)"
        _, gb = read(cluster.arrow_ipc("pts", ecql), sft)
        _, wb = read(oracle.arrow_ipc("pts", ecql), sft)
        assert set(gb.ids.astype(str)) == set(wb.ids.astype(str))
        sorted_ids = read(cluster.arrow_ipc("pts", ecql, sort_by="dtg"),
                          sft)[1].ids.astype(str).tolist()
        cluster.close()
        return gb.ids.astype(str).tolist(), sorted_ids
    j, t = both(run)
    assert t == j


def test_write_routes_disjoint_and_delete_broadcasts():
    def run(P):
        cluster, oracle, _ = make_cluster(P, 3, n=600)
        per_group = [g.count("pts") for g in cluster._groups]
        assert sum(per_group) == 600
        all_ids = [i for g in cluster._groups for i in qids(g, "INCLUDE")]
        assert len(all_ids) == len(set(all_ids)) == 600
        victims = [f"f{i}" for i in range(0, 50)]
        vec = cluster.delete("pts", victims)
        oracle.delete("pts", victims)
        assert set(qids(cluster, "INCLUDE")) == set(qids(oracle, "INCLUDE"))
        out = per_group, qids(cluster, "INCLUDE"), vec
        cluster.close()
        return out
    j, t = both(run)
    assert t == j


# -- TestPartialResults --------------------------------------------------------

def half_down(P, allow_partial, n=200):
    sft = P.parse_spec("pts", SPEC)
    live = P.store()
    live.create_schema(sft)
    ids, cols = seeded(n)
    live.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
    cluster = cl(P).ClusterDataStore([live, DownGroup()],
                                     names=["up", "down"],
                                     leg_deadline_s=2, hedge_ms=10,
                                     allow_partial=allow_partial)
    cluster._sfts["pts"] = sft
    return cluster, live


def test_down_group_raises_typed():
    def run(P):
        cluster, _ = half_down(P, allow_partial=False)
        errs = []
        for call in (lambda: cluster.query("INCLUDE", "pts"),
                     lambda: cluster.query_count("INCLUDE", "pts"),
                     lambda: cluster.stats_query("pts", "Count()")):
            with pytest.raises(cl(P).ShardUnavailableError) as ei:
                call()
            err = ei.value
            assert err.groups == ["down"]
            assert err.z_ranges[0]["prefix_lo"] == n_prefixes(P) // 2
            assert err.retryable is False
            errs.append((err.groups, err.z_ranges, str(err)))
        return errs
    j, t = both(run)
    assert t == j


def test_partial_mode_flags_never_silent():
    def run(P):
        cluster, live = half_down(P, allow_partial=True)
        res = cluster.query("INCLUDE", "pts")
        assert res.complete is False and res.missing_groups == ["down"]
        assert set(res.ids.astype(str)) == set(qids(live, "INCLUDE"))
        c = cluster.query_count("INCLUDE", "pts")
        assert isinstance(c, cl(P).PartialCount) and c.complete is False
        grid = cluster.density("pts", "INCLUDE",
                               (-180.0, -90.0, 180.0, 90.0), 16, 8)
        assert getattr(grid, "complete", True) is False
        b = cluster.bin_query("pts", "INCLUDE")
        return (qids(cluster, "INCLUDE"), res.missing_z_ranges, int(c),
                c.missing_groups, c.missing_z_ranges, grid.missing_groups,
                np.asarray(grid).tobytes(), b.complete, b.missing_groups)
    j, t = both(run)
    assert t == j


def test_knob_flips_live_and_healthy_is_complete():
    def run(P):
        knob = cl(P).CLUSTER_ALLOW_PARTIAL
        cluster, _ = half_down(P, allow_partial=None)
        old = knob.get()
        try:
            knob.set("false")
            with pytest.raises(cl(P).ShardUnavailableError):
                cluster.query_count("INCLUDE", "pts")
            knob.set("true")
            c = cluster.query_count("INCLUDE", "pts")
            assert c.complete is False
        finally:
            knob.set(old)
        healthy, _, _ = make_cluster(P, 2)
        res = healthy.query("INCLUDE", "pts")
        assert res.complete is True and res.missing_groups == []
        healthy.close()
        return int(c), res.n
    j, t = both(run)
    assert t == j


# -- TestLsnVector -------------------------------------------------------------

def test_write_returns_vector(tmp_path):
    def run(P):
        sft = P.parse_spec("pts", SPEC)
        g0 = P.store(durable_dir=str(tmp_path / P.name / "g0"),
                     wal_fsync="never")
        cluster = cl(P).ClusterDataStore([g0, P.store()], names=["a", "b"])
        cluster.create_schema(sft)
        ids, cols = seeded(100)
        vec = cluster.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
        assert vec.get("a", 0) > 0 and cluster.lsn_vector() == vec
        st = cluster.cluster_status()
        assert st["lsn_vector"] == vec
        cluster.close()
        return vec, strip(st)
    j, t = both(run)
    assert t == j


def test_read_your_writes_through_replicas(tmp_path):
    def run(P):
        sft = P.parse_spec("pts", SPEC)
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        primary.create_schema(sft)
        ship = P.WalShipper(primary.journal)
        replica = P.Replica(ship.host, ship.port, name="r0")
        group = P.ReplicatedDataStore(primary=primary, replicas=[replica],
                                      ack_replicas=0, auto_promote=False,
                                      max_lag_lsn=10**9, max_lag_s=3600)
        cluster = cl(P).ClusterDataStore([group], names=["g"],
                                         leg_deadline_s=10)
        cluster._sfts["pts"] = sft
        _, cols = seeded(50)
        counts = []
        try:
            for i in range(20):
                cluster.write("pts", P.FeatureBatch.from_dict(
                    sft, np.array([f"rw{i}_{j}" for j in range(50)],
                                  dtype=object), cols))
                n = cluster.query_count("INCLUDE", "pts")
                assert n == (i + 1) * 50, f"write {i} invisible"
                counts.append(n)
            return counts, cluster.lsn_vector()
        finally:
            cluster.close()
            ship.stop()
    j, t = both(run)
    assert t == j


def test_staged_batches_coalesce_to_one_write_many_per_group():
    def run(P):
        class Spy(P.Store):
            def __init__(self):
                if P is T:
                    super().__init__(device="cpu")
                else:
                    super().__init__()
                self.wm_calls = 0

            def write_many(self, type_name, pairs):
                self.wm_calls += 1
                return super().write_many(type_name, pairs)

        sft = P.parse_spec("pts", SPEC)
        groups = [Spy() for _ in range(4)]
        cluster = cl(P).ClusterDataStore(groups)
        cluster.create_schema(sft)
        oracle = P.store()
        oracle.create_schema(sft)
        rng = np.random.default_rng(3)
        pairs, total = [], 0
        for k in range(8):
            mm = 50
            b = P.FeatureBatch.from_dict(
                sft, np.array([f"b{k}_{i}" for i in range(mm)], object), {
                    "geom": (rng.uniform(-170, 170, mm),
                             rng.uniform(-80, 80, mm)),
                    "dtg": np.full(mm, 1_600_000_000_000, np.int64),
                    "name": np.array([f"n{i % 5}" for i in range(mm)],
                                     dtype=object)})
            pairs.append((b, None))
            oracle.write("pts", b)
            total += mm
        cluster.write_many("pts", pairs)
        assert [g.wm_calls for g in groups] == [1, 1, 1, 1]
        assert cluster.query_count("INCLUDE", "pts") == total
        assert set(qids(cluster, "INCLUDE")) == set(qids(oracle, "INCLUDE"))
        per = [g.count("pts") for g in groups]
        cluster.close()
        return per, qids(cluster, "INCLUDE")
    j, t = both(run)
    assert t == j


# -- TestFederation: from_uri over either package's server ---------------------

@needs_jax
@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_two_server_scatter_matches_single_store(server_pkg):
    """A ``cluster://`` client of each package over two web servers of
    one package, against one store."""
    S = J if server_pkg == "jax" else T
    backends = [S.store(), S.store()]
    servers = [m(S, "web").GeoMesaWebServer(b).start() for b in backends]
    try:
        uri = "cluster://" + ",".join(f"127.0.0.1:{s.port}"
                                      for s in servers)

        def run(P):
            for b in backends:
                for tn in b.get_type_names():
                    b.remove_schema(tn)
            sft = P.parse_spec("pts", SPEC)
            cluster = cl(P).ClusterDataStore.from_uri(uri, leg_deadline_s=30)
            cluster.create_schema(sft)
            oracle = P.store()
            oracle.create_schema(sft)
            ids, cols = seeded(300)
            cluster.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
            oracle.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
            per = [b.count("pts") for b in backends]
            assert sum(per) == 300 and all(p > 0 for p in per)
            out = [per]
            for ecql in ("INCLUDE", "BBOX(geom, -120, -60, 120, 60)"):
                got = qids(cluster, ecql)
                assert set(got) == set(qids(oracle, ecql)), ecql
                out.append(got)
            c = cluster.query_count("INCLUDE", "pts")
            assert c == oracle.query_count("INCLUDE", "pts")
            out.append(c)
            cluster.close()
            return out
        j, t = both(run)
        assert t == j
    finally:
        for s in servers:
            s.stop()


# -- TestChaosFailover ---------------------------------------------------------

def test_kill_primary_mid_scatter_zero_acked_loss(tmp_path):
    """ChaosProxy kills group 0's primary mid-run: the group promotes
    inside the cluster, no acked write is lost and every concurrent
    query is exact or typed, in both packages."""
    def run(P):
        res_mod = m(P, "resilience")
        sft = P.parse_spec("pts", "*geom:Point:srid=4326")
        rng = np.random.default_rng(5)
        n_static = 800
        sx, sy = rng.uniform(-180, 180, n_static), rng.uniform(-90, 90,
                                                              n_static)
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        primary.create_schema(sft)
        srv = m(P, "web").GeoMesaWebServer(primary).start()
        proxy = res_mod.ChaosProxy("127.0.0.1", srv.port).start()
        remote = m(P, "store.remote").RemoteDataStore(
            "127.0.0.1", proxy.port, timeout_s=2.0,
            retry_policy=res_mod.RetryPolicy(max_attempts=2, base_s=0.02,
                                             cap_s=0.05,
                                             total_deadline_s=1.0))
        ship = P.WalShipper(primary.journal)
        replicas = [P.Replica(ship.host, ship.port, name=f"r{i}")
                    for i in range(2)]
        group0 = P.ReplicatedDataStore(primary=remote, replicas=replicas,
                                       ack_replicas=1, auto_promote=True,
                                       probe_ms=50, probe_failures=2,
                                       max_lag_lsn=100_000, max_lag_s=600)
        group1 = P.store()
        group1.create_schema(sft)
        cluster = cl(P).ClusterDataStore([group0, group1],
                                         names=["g0", "g1"],
                                         leg_deadline_s=5, hedge_ms=50)
        cluster._sfts["pts"] = sft
        cluster.write("pts", P.FeatureBatch.from_dict(
            sft, np.array([f"s{i}" for i in range(n_static)], object),
            {"geom": (sx, sy)}))
        acked, wrong, typed = [], [0], [0]
        stop = threading.Event()

        def ingest():
            bno = 0
            w = np.random.default_rng(6)
            while not stop.is_set():
                wids = [f"w{bno}_{j}" for j in range(20)]
                b = P.FeatureBatch.from_dict(
                    sft, np.array(wids, dtype=object),
                    {"geom": (w.uniform(-180, 180, 20),
                              w.uniform(-90, 90, 20))})
                try:
                    cluster.write("pts", b)
                    acked.extend(wids)
                except Exception:   # noqa: BLE001 - typed, unacked
                    pass
                bno += 1

        def query_loop():
            q = np.random.default_rng(8)
            while not stop.is_set():
                x0, y0 = float(q.uniform(-170, 130)), float(q.uniform(-80,
                                                                      55))
                try:
                    res = cluster.query(
                        f"BBOX(geom, {x0:.4f}, {y0:.4f}, "
                        f"{x0+25:.4f}, {y0+25:.4f})", "pts")
                except Exception:   # noqa: BLE001 - typed: never wrong
                    typed[0] += 1
                    continue
                got = set(res.ids.astype(str))
                want = {f"s{i}" for i in range(n_static)
                        if x0 <= sx[i] <= x0 + 25 and y0 <= sy[i] <= y0 + 25}
                if want - got or any(not g.startswith(("s", "w"))
                                     for g in got - want):
                    wrong[0] += 1

        threads = [threading.Thread(target=ingest, daemon=True),
                   threading.Thread(target=query_loop, daemon=True)]
        for th in threads:
            th.start()
        try:
            time.sleep(0.6)
            srv.stop()
            ship.stop()
            proxy.stop()
            wait(lambda: isinstance(group0.primary, P.ReplicaClass), 15.0,
                 "auto-promote")
            time.sleep(0.4)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=10)
        try:
            assert len(acked) > 0
            survived = set(qids(cluster, "INCLUDE"))
            lost = [i for i in acked if i not in survived]
            assert lost == [] and wrong[0] == 0
            st = group0.replication_status()
            assert st.get("promoted_to") in ("r0", "r1")
            return lost, wrong[0], type(group0.primary).__name__
        finally:
            cluster.close()
            proxy.stop()
    j, t = both(run)
    assert t == j


def test_ack_rejected_past_promotion_cutoff(tmp_path):
    def run(P):
        sft = P.parse_spec("pts", "*geom:Point:srid=4326")
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        primary.create_schema(sft)
        ship = P.WalShipper(primary.journal)
        replica = P.Replica(ship.host, ship.port, name="r0")
        router = P.ReplicatedDataStore(primary=primary, replicas=[replica],
                                       ack_replicas=1, auto_promote=False)
        try:
            _, cols = seeded(30)
            router.write("pts", P.FeatureBatch.from_dict(
                sft, np.array([f"a{i}" for i in range(30)], object),
                {"geom": cols["geom"]}))
            ship.stop()
            router.promote()
            cutoff = router._promote_cutoff
            assert cutoff is not None and cutoff >= 1
            router._await_ack(cutoff)
            with pytest.raises(P.ReplicationAckLost) as e:
                router._await_ack(cutoff + 5)
            return cutoff, str(e.value)
        finally:
            router.close()
    j, t = both(run)
    assert t == j


# -- tests/test_planner.py: pruning exactness -----------------------------------

PTS_SPEC = ("*geom:Point:srid=4326,dtg:Date,"
            "name:String:index=true,val:Integer")


def planner_batch(P, sft, n, seed=7):
    rng = np.random.default_rng(seed)
    names = np.array(["alpha", "bravo", "charlie"], dtype=object)
    return P.FeatureBatch.from_dict(
        sft, np.array([f"f{i:05d}" for i in range(n)], dtype=object), {
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)),
            "dtg": np.int64(1_600_000_000_000)
            + rng.integers(0, 10_000_000_000, n),
            "name": names[rng.integers(0, 3, n)],
            "val": rng.permutation(n).astype(np.int64)})


def planner_cluster(P, k=4, n=4000, **kw):
    sft = P.parse_spec("pts", PTS_SPEC)
    groups = [P.store() for _ in range(k)]
    cluster = cl(P).ClusterDataStore(groups, **kw)
    cluster.create_schema(sft)
    cluster.write("pts", planner_batch(P, sft, n))
    return cluster


@pytest.fixture(scope="module")
def clusters4():
    made = {P.name: planner_cluster(P) for P in PKGS}
    yield made
    for c in made.values():
        c.close()


def bbox_cql(x0, y0, x1, y1):
    return f"BBOX(geom, {x0}, {y0}, {x1}, {y1})"


def analytic_legs(cluster, boxes):
    ranges = cluster._part.covering_ranges(boxes)
    keep = cluster._part.groups_for_ranges(ranges)
    return sorted(cluster._names[g] for g in keep)


def unpruned(P, fn):
    knob = m(P, "cluster.coordinator").CLUSTER_PRUNE
    knob.set("false")
    try:
        return fn()
    finally:
        knob.set(None)


def test_randomized_bboxes_exact_and_analytic(clusters4):
    def run(P):
        c = clusters4[P.name]
        Query = m(P, "index.api").Query
        rng = np.random.default_rng(42)
        out, saw_pruned = [], 0
        for _ in range(25):
            w, h = rng.uniform(0.5, 60), rng.uniform(0.5, 40)
            x0, y0 = rng.uniform(-170, 170 - w), rng.uniform(-80, 80 - h)
            box = (x0, y0, x0 + w, y0 + h)
            q = Query("pts", bbox_cql(*box))
            got = sorted(c.query(q).ids.astype(str))
            plan = c.last_plan()
            assert plan["pruning"] == "z-range"
            assert sorted(plan["contacted"]) == analytic_legs(c, [box])
            assert got == unpruned(P, lambda: sorted(
                c.query(q).ids.astype(str)))
            saw_pruned += bool(plan["pruned"])
            out.append((got, plan))
        assert saw_pruned > 5
        return out
    j, t = both(run)
    assert t == j


def test_randomized_bbox_and_time_window(clusters4):
    from datetime import datetime, timezone

    def iso(ms):
        return datetime.fromtimestamp(ms / 1000, tz=timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")

    def run(P):
        c = clusters4[P.name]
        Query = m(P, "index.api").Query
        rng = np.random.default_rng(43)
        out = []
        for _ in range(8):
            x0, y0 = rng.uniform(-170, 100), rng.uniform(-80, 40)
            box = (x0, y0, x0 + rng.uniform(1, 50), y0 + rng.uniform(1, 30))
            t0 = 1_600_000_000_000 + int(rng.integers(0, 5_000_000_000))
            q = Query("pts", f"{bbox_cql(*box)} AND dtg DURING "
                             f"{iso(t0)}/{iso(t0 + 2_000_000_000)}")
            got = sorted(c.query(q).ids.astype(str))
            assert sorted(c.last_plan()["contacted"]) == \
                analytic_legs(c, [box])
            assert got == unpruned(P, lambda: sorted(
                c.query(q).ids.astype(str)))
            out.append(got)
        return out
    j, t = both(run)
    assert t == j


def test_single_group_bbox_and_plan_surface(clusters4):
    import json

    def run(P):
        c = clusters4[P.name]
        Query = m(P, "index.api").Query
        rng = np.random.default_rng(44)
        for _ in range(200):
            x0, y0 = rng.uniform(-170, 167), rng.uniform(-80, 77)
            box = (x0, y0, x0 + 3, y0 + 3)
            if len(analytic_legs(c, [box])) == 1:
                break
        q = Query("pts", bbox_cql(*box))
        got = sorted(c.query(q).ids.astype(str))
        plan = c.last_plan()
        assert len(plan["contacted"]) == 1 and len(plan["pruned"]) == 3
        assert got == unpruned(P, lambda: sorted(c.query(q).ids.astype(str)))
        cnt = c.query_count(Query("pts", bbox_cql(10, 10, 40, 40)))
        assert cnt == unpruned(P, lambda: c.query_count(
            Query("pts", bbox_cql(10, 10, 40, 40))))
        c.query(Query("pts", "name = 'alpha'"))
        p2 = c.last_plan()
        assert p2["pruning"] == "no-spatial-bound" and p2["pruned"] == []
        c.query(Query("pts", bbox_cql(20, 20, 23, 23)))
        p3 = c.last_plan()
        json.dumps(p3)
        status = c.cluster_status()
        assert status["prune"] is True and status["last_plan"] == p3
        return got, plan, cnt, p2, p3, strip(status)
    j, t = both(run)
    assert t == j


def test_prune_cache_and_kill_switch(clusters4):
    def run(P):
        c = clusters4[P.name]
        c._prune_cache.clear()
        q = m(P, "index.api").Query("pts", bbox_cql(30, 30, 33, 33))
        c.query(q)
        c.query(q)
        sizes = [len(c._prune_cache)]
        c.create_schema(P.parse_spec("pts_tmp", PTS_SPEC))
        try:
            sizes.append(len(c._prune_cache))
        finally:
            c.remove_schema("pts_tmp")
        flt = m(P, "filters").parse_ecql(bbox_cql(0, 0, 1, 1))
        off = unpruned(P, lambda: c.prune_for("pts", flt))
        return sizes, off
    j, t = both(run)
    assert t == j == ([1, 0], (None, None))


def selective_box(cluster):
    rng = np.random.default_rng(3)
    for _ in range(200):
        x0, y0 = rng.uniform(-170, 167), rng.uniform(-80, 77)
        box = (x0, y0, x0 + 3, y0 + 3)
        keep = cluster._part.groups_for_ranges(
            cluster._part.covering_ranges([box]))
        if len(keep) == 1:
            return box, keep[0]
    raise AssertionError("no single-group box found")


@pytest.mark.parametrize("allow_partial", [True, False])
def test_dead_pruned_leg_is_not_missing(allow_partial):
    def run(P):
        c = planner_cluster(P, 4, n=2000, allow_partial=allow_partial)
        try:
            box, owner = selective_box(c)
            dead = (owner + 1) % 4
            c._groups[dead] = DownGroup()
            res = c.query(m(P, "index.api").Query("pts", bbox_cql(*box)))
            plan = c.last_plan()
            assert plan["contacted"] == [c._names[owner]]
            assert c._names[dead] in plan["pruned"]
            out = [sorted(res.ids.astype(str)), plan, res.complete]
            if not allow_partial:
                with pytest.raises(cl(P).ShardUnavailableError) as ei:
                    c.query(m(P, "index.api").Query("pts", "INCLUDE"))
                assert c._names[dead] in ei.value.groups
                out.append(ei.value.groups)
            return out
        finally:
            c.close()
    j, t = both(run)
    assert t == j


def test_contacted_leg_fails_pruned_leg_still_absent():
    def run(P):
        c = planner_cluster(P, 4, n=2000, allow_partial=True)
        try:
            box, owner = selective_box(c)
            c._groups[owner] = DownGroup()
            x0, y0, x1, y1 = box
            res = m(P, "sql").SqlEngine(c).query(
                "SELECT COUNT(*) FROM pts WHERE ST_Contains("
                f"ST_MakeBBOX({x0}, {y0}, {x1}, {y1}), geom)")
            assert res.complete is False
            assert res.missing_groups == [c._names[owner]]
            pruned = set(res.plan["prune"]["pruned"])
            assert pruned and not (pruned & set(res.missing_groups))
            return list(res.rows()), res.plan, res.missing_z_ranges
        finally:
            c.close()
    j, t = both(run)
    assert t == j


# -- tests/test_streaming.py: cluster streams ------------------------------------

STREAM_SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"


def stream_cluster(P, k=3, n=600, **kw):
    sft = P.parse_spec("pts", STREAM_SPEC)
    cluster = cl(P).ClusterDataStore([P.store() for _ in range(k)], **kw)
    oracle = P.store()
    rng = np.random.default_rng(11)
    batch = P.FeatureBatch.from_dict(
        sft, np.array([f"s{i}" for i in range(n)], dtype=object),
        {"name": np.array([f"n{i % 9}" for i in range(n)], dtype=object),
         "age": rng.permutation(n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))})
    for st in (cluster, oracle):
        st.create_schema(sft)
        st.write("pts", batch)
    return cluster, oracle


def drain(stream):
    return [str(i) for b in stream for i in b.ids]


def test_stream_matches_eager_sorted_and_truncates():
    def run(P):
        Query = m(P, "index.api").Query
        cluster, oracle = stream_cluster(P)
        try:
            q = Query("pts", "age < 500", sort_by="age")
            stream = cluster.query_stream(q, batch_rows=64)
            pieces = list(stream)
            assert all(p.n <= 64 for p in pieces)
            got = drain(pieces)
            assert got == [str(i) for i in oracle.query(q).ids]
            assert stream.complete is True and stream.missing_groups == []
            names = [b.col("name").value(i)
                     for b in cluster.query_stream(
                         Query("pts", sort_by="name"), batch_rows=64)
                     for i in range(b.n)]
            assert names == sorted(names) and len(names) == 600
            q37 = Query("pts", sort_by="age", max_features=37)
            top = drain(cluster.query_stream(q37, batch_rows=16))
            assert top == [str(i) for i in oracle.query(q37).ids]
            return got, names, top
        finally:
            cluster.close()
    j, t = both(run)
    assert t == j


@pytest.mark.parametrize("allow_partial", [False, True])
def test_down_leg_stream(allow_partial):
    def run(P):
        sft = P.parse_spec("pts", SPEC)
        live = P.store()
        live.create_schema(sft)
        ids, cols = seeded(200)
        live.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
        cluster = cl(P).ClusterDataStore([live, DownGroup()],
                                         names=["up", "down"],
                                         leg_deadline_s=2, hedge_ms=10,
                                         allow_partial=allow_partial)
        cluster._sfts["pts"] = sft
        q = m(P, "index.api").Query("pts", "INCLUDE")
        stream = cluster.query_stream(q, batch_rows=32)
        if not allow_partial:
            with pytest.raises(cl(P).ShardUnavailableError) as ei:
                drain(stream)
            return ei.value.groups, ei.value.z_ranges
        got = drain(stream)
        assert stream.complete is False
        return (sorted(got), stream.missing_groups,
                stream.missing_z_ranges)
    j, t = both(run)
    assert t == j


# -- tests/test_result_cache.py: per-leg caches --------------------------------

def test_cluster_per_leg_caches_are_independent():
    def run(P):
        sft = P.parse_spec("cpts", "*geom:Point:srid=4326")
        groups = [P.store(), P.store()]
        cluster = cl(P).ClusterDataStore(groups, names=["g0", "g1"])
        cluster.create_schema(sft)
        rng = np.random.default_rng(3)
        n = 400
        cluster.write("cpts", P.FeatureBatch.from_dict(
            sft, [f"p{i}" for i in range(n)],
            {"geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}))
        bb = (-170.0, -80.0, 170.0, 80.0)
        g1 = cluster.density("cpts", "INCLUDE", bb, 16, 16)
        hits0 = [g.result_cache.hits for g in groups]
        g2 = cluster.density("cpts", "INCLUDE", bb, 16, 16)
        assert [g.result_cache.hits for g in groups] == [h + 1
                                                        for h in hits0]
        assert np.asarray(g1).tobytes() == np.asarray(g2).tobytes()
        cluster.write("cpts", P.FeatureBatch.from_dict(
            sft, ["solo"], {"geom": (np.full(1, 12.3), np.full(1, 45.6))}))
        touched = [g.result_cache.misses for g in groups]
        g3 = cluster.density("cpts", "INCLUDE", bb, 16, 16)
        assert sum(g.result_cache.misses - t
                   for g, t in zip(groups, touched)) == 1
        st = cluster.cache_status()
        assert st["role"] == "cluster" and set(st["groups"]) == {"g0", "g1"}
        assert cluster.invalidate_cache("cpts") >= 1
        return np.asarray(g1).tobytes(), np.asarray(g3).tobytes()
    j, t = both(run)
    assert t == j


# -- tests/test_qos.py and tests/test_obs.py: tenants and traces ---------------

def test_cluster_query_one_event_tenant_attributed():
    """One logical query through the coordinator is ONE audit event
    carrying the caller's tenant (the delegated legs stay quiet)."""
    def run(P):
        tenants, hook = m(P, "tenants"), m(P, "audit.hook")
        tenants.QOS_ENABLED.set("true")
        tenants.tenant_registry.reset()
        hook._reset_global()
        sft = P.parse_spec("qclu", "dtg:Date,*geom:Point:srid=4326")
        cluster = cl(P).ClusterDataStore([P.store(), P.store()],
                                         names=["g0", "g1"])
        try:
            cluster.create_schema(sft)
            rng = np.random.default_rng(7)
            n = 64
            cluster.write("qclu", P.FeatureBatch.from_dict(
                sft, np.array([f"f{i}" for i in range(n)], dtype=object),
                {"dtg": rng.integers(0, 10**12, n).astype(np.int64),
                 "geom": (rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n))}))
            audit = m(P, "audit").global_audit()
            ev0 = len(audit.query())
            with tenants.tenant_scope("clu-t"):
                res = cluster.query("INCLUDE", "qclu")
            events = audit.query()[ev0:]
            cev = [e for e in events if e.surface == "cluster"]
            assert res.n == n and len(cev) == 1
            assert cev[0].tenant == "clu-t"
            assert not [e for e in events if e.surface == "remote"]
            return sorted(e.surface for e in events), cev[0].tenant, \
                cev[0].hits
        finally:
            cluster.close()
            tenants.QOS_ENABLED.set(None)
            tenants.tenant_registry.reset()
            hook._reset_global()
    j, t = both(run)
    assert t == j


def test_one_trace_spans_coordinator_and_shards():
    """A cluster:// query under one root span: the coordinator's legs,
    both shard servers' web spans and their store scans share the trace
    id; one cluster audit event, one per shard store."""
    def run(P):
        obs, hook = m(P, "obs"), m(P, "audit.hook")
        hedge = m(P, "resilience.hedge")
        trace_mod = m(P, "obs.trace")
        m(P, "scan.registry").batcher_registry.clear()
        hook._reset_global()
        hedge.HEDGE_MIN_DELAY_MS.set("60000")
        trace_mod.TRACE_SAMPLE.set("1.0")
        obs.tracer.clear()
        sft = P.parse_spec("pts", SPEC)
        backends = [P.store(), P.store()]
        servers = [m(P, "web").GeoMesaWebServer(b).start()
                   for b in backends]
        cluster = None
        try:
            uri = "cluster://" + ",".join(f"127.0.0.1:{s.port}"
                                          for s in servers)
            cluster = cl(P).ClusterDataStore.from_uri(
                uri, leg_deadline_s=30, hedge_ms=60_000)
            cluster.create_schema(sft)
            ids, cols = seeded(120, seed=3)
            cluster.write("pts", P.FeatureBatch.from_dict(sft, ids, cols))
            obs.tracer.clear()
            audit = m(P, "audit").global_audit()
            ev0 = len(audit.query())
            with obs.tracer.span("client", "fed-query", root=True) as root:
                res = cluster.query("INCLUDE", "pts")
            spans = obs.tracer.get(root.trace_id)
            kinds = sorted(d["kind"] for d in spans)
            assert {"client", "scatter-leg", "web", "store-scan"} <= \
                set(kinds)
            assert all(d["trace_id"] == root.trace_id for d in spans)
            surfaces = sorted(e.surface for e in audit.query()[ev0:])
            assert surfaces.count("cluster") == 1
            assert surfaces.count("memory") == 2
            return res.n, kinds.count("scatter-leg"), kinds.count("web"), \
                surfaces
        finally:
            if cluster is not None:
                cluster.close()
            for s in servers:
                s.stop()
            hedge.HEDGE_MIN_DELAY_MS.set(None)
            trace_mod.TRACE_SAMPLE.set(None)
            obs.tracer.clear()
            hook._reset_global()
    j, t = both(run)
    assert t == j
    assert t[:3] == (120, 2, 2)


# -- the device rules ----------------------------------------------------------

def test_cluster_device_follows_its_groups():
    groups = [T.store(), T.store()]
    c = T.m("cluster").ClusterDataStore(groups)
    assert c.device == torch.device("cpu")
    assert c._cuda == {"shard0": None, "shard1": None}
    mixed = T.m("cluster").ClusterDataStore([T.store(), DownGroup()])
    assert mixed.device is None


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_cluster_matches_one_cuda_store():
    """A 4-group CUDA cluster against one CUDA store: the north-star
    box's ids, a density grid and ``query_count``; the scan kernels
    launch on the groups."""
    kernels = importlib.import_module("geomesa_tpu_torch.scan.kernels")
    sft = T.parse_spec("pts", SPEC)
    rng = np.random.default_rng(21)
    n = 400_000
    ids = np.array([f"c{i}" for i in range(n)], dtype=object)
    cols = {"geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)),
            "dtg": np.int64(1704067200000) + rng.integers(0, 10**10, n),
            "name": np.array([f"n{i % 13}" for i in range(n)], object)}
    groups = [T.Store() for _ in range(4)]
    cluster = T.m("cluster").ClusterDataStore(groups)
    one = T.Store()
    for st in (cluster, one):
        st.create_schema(sft)
        st.write("pts", T.FeatureBatch.from_dict(sft, ids, cols))
    try:
        assert cluster.device.type == "cuda"
        ecql = ("BBOX(geom, -80, 30, -70, 45) AND dtg DURING "
                "2024-01-01T00:00:00Z/2024-03-01T00:00:00Z")
        kernels.reset_launches()
        got = sorted(cluster.query(ecql, "pts").ids.astype(str))
        assert got == sorted(one.query(ecql, "pts").ids.astype(str))
        half = "BBOX(geom, -180, -90, 0, 90)"
        assert cluster.query_count(half, "pts") == \
            one.query_count(half, "pts")
        assert kernels.launches["scan_mask"] + \
            kernels.launches["scan_mask_gather"] >= 1
        bbox = (-180.0, -90.0, 180.0, 90.0)
        g = np.asarray(cluster.density("pts", "INCLUDE", bbox, 64, 32))
        w = np.asarray(one.density("pts", "INCLUDE", bbox, 64, 32))
        assert g.tobytes() == w.tobytes()
    finally:
        cluster.close()
