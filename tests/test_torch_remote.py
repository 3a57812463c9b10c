"""The port's ``RemoteDataStore`` (``store/remote.py``) against the JAX
package's on the CPU.

Each scenario runs the port's client against the port's server and the
JAX client against the JAX server, over stores built from the same
numpy seed, and holds the answers equal: ids in order, counts, stats,
grids, BIN and Arrow bytes, the admin calls' documents (times left
out), and the error each call raises. Two cross tests drive the JAX
client against the port's server and the port's client against the JAX
server. The chaos cases (the JAX suite's ``TestRemoteChaos``) run the
port alone through its ``ChaosProxy``, held to the fault-free answers;
the hedge gates (``TestRemoteHedgeGating``) run in both packages.

Every socket binds port 0, every server and proxy stops in a
``finally`` and every wait is bounded."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from test_torch_web import (BB, PKGS, SPEC, T, _hygiene, both,  # noqa: F401
                            call, make_batch, mod, needs_jax, seeded_store,
                            served, steady, stream_store)

pytestmark = needs_jax


def _ids(res):
    return [str(i) for i in res.ids]


def drain_ids(batches):
    return [str(i) for b in batches for i in b.ids]


# -- TestRemoteCountPushdown (test_web_surfaces.py) ---------------------------

class TestRemoteCountPushdown:
    def test_hinted_count_server_side_and_bounded(self):
        def run(P):
            QueryHints = mod(P, "index.api").QueryHints
            backing = seeded_store(P, n=500)
            with served(P, backing) as srv:
                ds = P.Remote("127.0.0.1", srv.port)
                sizes = []
                orig = ds._do_request

                def spy(method, path, params, body, idempotent):
                    ct, data = orig(method, path, params, body, idempotent)
                    sizes.append((path, len(data)))
                    return ct, data
                ds._do_request = spy

                def no_rows(*a, **kw):
                    raise AssertionError("count pulled the rows client-side")
                ds.query = no_rows
                queries = [
                    P.Query("people", "age < 400"),
                    P.Query("people", "INCLUDE", max_features=123),
                    P.Query("people", "INCLUDE",
                            hints={QueryHints.SAMPLING: 0.1}),
                    P.Query("people", "age >= 0",
                            hints={QueryHints.SAMPLING: 0.2,
                                   QueryHints.SAMPLE_BY: "name"})]
                counts = [ds.query_count(qq) for qq in queries]
                assert counts == [backing.query_count(qq) for qq in queries]
            wire = [s for p, s in sizes if "/rest/count/" in p]
            assert len(wire) == len(queries) and all(s < 256 for s in wire)
            return counts
        j, t = both(run)
        assert t == j

    def test_unmapped_hint_falls_back_to_query(self):
        def run(P):
            with served(P, seeded_store(P, n=50)) as srv:
                ds = P.Remote("127.0.0.1", srv.port)
                return ds.query_count(P.Query("people", "age < 10",
                                              hints={"BIN_TRACK": "name"}))
        assert both(run) == (10, 10)


# -- TestRemoteStoreSemantics (test_web_surfaces.py) --------------------------

class TestRemoteStoreSemantics:
    def test_count_is_total_not_filtered(self):
        def run(P):
            backing = P.store()
            with served(P, backing) as srv:
                ds = P.Remote("127.0.0.1", srv.port)
                ds.create_schema(P.parse_spec("t", "name:String,*geom:Point"))
                ds.write_dict("t", ["a", "b", "c"],
                              {"name": ["x", "y", "z"],
                               "geom": ([0.0, 1.0, 2.0], [0.0, 1.0, 2.0])},
                              visibilities=[None, "admin", None])
                return (ds.count("t"), backing.count("t"),
                        _ids(ds.query("INCLUDE", "t")),
                        _ids(ds.query(P.Query("t", "INCLUDE",
                                              auths=["admin"]))))
        j, t = both(run)
        assert t == j and t[:3] == (3, 3, ["a", "c"])

    def test_unknown_type_keyerror(self):
        def run(P):
            with served(P, P.store()) as srv:
                ds = P.Remote("127.0.0.1", srv.port)
                out = []
                for fn in (lambda: ds.get_schema("nope"),
                           lambda: ds.query("INCLUDE", "nope"),
                           lambda: ds.count("nope"),
                           lambda: ds.stats_query("nope", "Count()"),
                           lambda: ds.bin_query("nope")):
                    with pytest.raises(KeyError) as ei:
                        fn()
                    out.append(str(ei.value))
                return out
        j, t = both(run)
        assert t == j


# -- the client's read surface on the same rows -------------------------------

READS = {
    "query_bbox": lambda P, ds: _ids(ds.query(
        "BBOX(geom, -90, 30, -70, 45)", "people")),
    "query_sorted_limited": lambda P, ds: _ids(ds.query(P.Query(
        "people", "age < 60", sort_by="name", sort_desc=True,
        max_features=17))),
    "query_projected": lambda P, ds: [
        (f["id"], f["age"]) for f in ds.query(P.Query(
            "people", "age < 5", properties=["age"])).features()],
    "query_sampled": lambda P, ds: _ids(ds.query(P.Query(
        "people", "INCLUDE", hints={"SAMPLING": 0.25}))),
    "count": lambda P, ds: ds.count("people"),
    "query_count": lambda P, ds: ds.query_count("age > 33", "people"),
    "estimate": lambda P, ds: ds.estimate_count("people", "age < 40"),
    "stats": lambda P, ds: ds.stats_query("people", "MinMax(age)",
                                          "age > 10"),
    "density": lambda P, ds: ds.density("people", "INCLUDE", BB, 8,
                                        8).tolist(),
    "bin": lambda P, ds: ds.bin_query("people", "age < 50", track="name",
                                      sort=True),
    "arrow_ipc": lambda P, ds: ds.arrow_ipc("people", "age < 30",
                                            sort_by="age"),
    "query_stream": lambda P, ds: [
        _ids(b) for b in ds.query_stream(
            P.Query("people", "age < 70", sort_by="age"), batch_rows=16)],
    "bin_stream": lambda P, ds: b"".join(ds.bin_stream(
        P.Query("people", "age < 70"), track="name")),
    "sql_partial": lambda P, ds: ds.sql_partial(
        "SELECT name, COUNT(*), MAX(age) FROM people GROUP BY name"),
    "schema": lambda P, ds: (ds.get_type_names(),
                             ds.get_schema("people").to_spec()),
}


@pytest.mark.parametrize("read", sorted(READS))
def test_reads_equal_reference(read):
    def run(P):
        with served(P, seeded_store(P)) as srv:
            return READS[read](P, P.Remote("127.0.0.1", srv.port,
                                           hedge=False))
    j, t = both(run)
    assert t == j


def test_sql_join_partial_equal_reference():
    sql = ("SELECT COUNT(*) FROM people a JOIN people b "
           "ON ST_DWithin(a.geom, b.geom, 2.0)")

    def run(P):
        ds = seeded_store(P)
        dist = mod(P, "sql.distributed")
        payload = dist._encode_batch("people", ds.get_schema("people"),
                                     ds.query("age < 20", "people"))
        spec = {"sql": sql, "broadcast": "b", "mode": "count",
                "payload": payload}
        with served(P, ds) as srv:
            got = P.Remote("127.0.0.1", srv.port).sql_join_partial(spec)
        assert got == json.loads(json.dumps(dist.join_partial_leg(ds, spec)))
        return got
    j, t = both(run)
    assert t == j


# -- writes and deletes -------------------------------------------------------

def test_writes_and_deletes_equal_reference():
    def run(P):
        backing = seeded_store(P)
        with served(P, backing) as srv:
            ds = P.Remote("127.0.0.1", srv.port)
            sft = ds.get_schema("people")
            rng = np.random.default_rng(21)
            lsn_w = ds.write("people", make_batch(P, sft, 100, 50, rng),
                             visibilities=["a" if i % 3 else None
                                           for i in range(50)])
            lsn_d = ds.delete("people", [f"p{i}" for i in range(0, 150, 7)])
            ds.write_many("people", [(make_batch(P, sft, 200, 5, rng), None),
                                     (make_batch(P, sft, 205, 5, rng), None)])
            return (lsn_w, lsn_d, ds.count("people"),
                    _ids(ds.query(P.Query("people", "INCLUDE", auths=["a"],
                                          sort_by="age"))),
                    _ids(ds.query("INCLUDE", "people")))
    j, t = both(run)
    assert t == j and t[2] == 160 - len(range(0, 150, 7))


# -- the admin calls ----------------------------------------------------------

ADMIN_404 = {
    "replication_status": lambda ds: ds.replication_status(),
    "promote": lambda ds: ds.promote(),
    "cluster_status": lambda ds: ds.cluster_status(),
    "promote_group": lambda ds: ds.promote_group("g"),
    "topology": lambda ds: ds.topology(),
    "reshard_status": lambda ds: ds.reshard_status(),
    "reshard": lambda ds: ds.reshard("split", src="g"),
}


@pytest.mark.parametrize("call_name", sorted(ADMIN_404))
def test_admin_without_role_raises_keyerror(call_name):
    """The server fronts a plain store: each role-less admin call is a
    404, which the client raises as KeyError with the server's message,
    in both packages alike."""
    def run(P):
        with served(P, seeded_store(P)) as srv:
            ds = P.Remote("127.0.0.1", srv.port)
            with pytest.raises(KeyError) as ei:
                ADMIN_404[call_name](ds)
            return str(ei.value)
    j, t = both(run)
    assert t == j


def test_admin_cache_reindex_audit_and_traces():
    def run(P):
        backing = seeded_store(P)
        with served(P, backing, audit=mod(P, "audit").AuditLogger()) as srv:
            ds = P.Remote("127.0.0.1", srv.port)
            ds.density("people", "INCLUDE", BB, 8, 8)
            status = ds.cache_status()
            dropped = ds.invalidate_cache("people")
            reindexed = ds.reindex("people", 1)
            events = ds.audit_events("people")
            traces = ds.traces(5)
        return (steady(status), dropped, reindexed,
                [(e["type_name"], e["filter"], e["hits"]) for e in events],
                traces)
    j, t = both(run)
    assert t == j and t[1] >= 1


def test_admin_cq_round_trip():
    def run(P):
        store = mod(P, "store.live").LiveDataStore
        live = store() if P.name == "jax" else store(device="cpu")
        live.create_schema(P.parse_spec("pts", SPEC))
        with served(P, live, auth_token="tok") as srv:
            ds = P.Remote("127.0.0.1", srv.port, auth_token="tok")
            reg = ds.cq_register("near", "pts", "BBOX(geom, -80, 30, -70, 40)")
            live.write("pts", make_batch(P, live.get_schema("pts"), 0, 200,
                                         np.random.default_rng(4)))
            status = ds.cq_status()
            gone = ds.cq_unregister("near")
            after = ds.cq_status()
        return reg, steady(status), gone, after
    j, t = both(run)
    assert t == j and t[1]["queries"][0]["matched"] > 0


def test_probe_health():
    def run(P):
        with served(P, seeded_store(P)) as srv:
            up = P.Remote("127.0.0.1", srv.port).probe_health()
            port = srv.port
        return up, P.Remote("127.0.0.1", port).probe_health(timeout_s=0.5)
    assert both(run) == ((True, False), (True, False))


# -- cross: each client against the other package's server --------------------

CROSS_READS = ("query_bbox", "query_sorted_limited", "query_projected",
               "count", "query_count", "stats", "density", "bin",
               "arrow_ipc", "query_stream", "bin_stream", "sql_partial",
               "schema")


@pytest.mark.parametrize("client,server", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cross_client_and_server(client, server):
    """The JAX client against the port's server and the port's client
    against the JAX server: writes through the wire, then every read
    equal to the same client against its own package's server."""
    J, T_ = PKGS
    C = J if client == "jax" else T_
    S = J if server == "jax" else T_

    def session(Cp, Sp):
        with served(Sp, Sp.store()) as srv:
            ds = Cp.Remote("127.0.0.1", srv.port)
            ds.create_schema(Cp.parse_spec("people", SPEC))
            rng = np.random.default_rng(5)
            ds.write("people", make_batch(Cp, ds.get_schema("people"), 0,
                                          100, rng))
            ds.delete("people", ["p3", "p4"])
            out = {r: READS[r](Cp, ds) for r in CROSS_READS}
            out["status"] = srv.store.count("people")
            return out
    crossed = session(C, S)
    own = session(C, C)
    assert crossed == own and crossed["status"] == 98


# -- TestRemoteStreaming (test_streaming.py) ----------------------------------

class TestRemoteStreaming:
    def test_query_stream_matches_eager(self):
        def run(P):
            ds = stream_store(P)
            with served(P, ds) as srv:
                client = P.Remote("127.0.0.1", srv.port)
                qq = P.Query("pts", "age < 700", sort_by="name")
                pieces = list(client.query_stream(qq, batch_rows=64))
            assert all(p.n <= 64 for p in pieces)
            assert drain_ids(pieces) == _ids(ds.query(qq))
            return drain_ids(pieces)
        j, t = both(run)
        assert t == j

    def test_reassembled_stream_is_byte_exact(self):
        def run(P):
            reassemble = mod(P, "arrow.delta").reassemble_ipc
            with served(P, stream_store(P)) as srv:
                client = P.Remote("127.0.0.1", srv.port)
                materialized = client.arrow_ipc("pts")
                rebuilt = reassemble(client.get_schema("pts"),
                                     client.query_stream(P.Query("pts"),
                                                         batch_rows=128))
            assert rebuilt == materialized
            return rebuilt
        j, t = both(run)
        assert t == j

    def test_bin_stream_matches_bin_query(self):
        def run(P):
            with served(P, stream_store(P)) as srv:
                client = P.Remote("127.0.0.1", srv.port)
                chunks = b"".join(client.bin_stream(P.Query("pts",
                                                            "age < 500")))
                assert chunks == client.bin_query("pts", "age < 500")
            return chunks
        j, t = both(run)
        assert t == j


def test_midstream_reset_raises_typed_error():
    """A connection cut mid-stream surfaces as a typed RemoteError, never
    a silently short result (the port's client, server and proxy)."""
    from geomesa_tpu_torch.resilience import ChaosProxy
    from geomesa_tpu_torch.store.remote import RemoteError
    with served(T, stream_store(T, n=60_000)) as srv:
        proxy = ChaosProxy("127.0.0.1", srv.port).start()
        try:
            ds = T.Remote("127.0.0.1", proxy.port, timeout_s=10.0,
                          hedge=False)
            stream = ds.query_stream(T.Query("pts"), batch_rows=512)
            assert next(stream).n == 512
            proxy.drop_all()
            with pytest.raises(RemoteError, match="stream interrupted"):
                for _ in stream:
                    pass
        finally:
            proxy.stop()


# -- TestRemoteChaos (test_resilience.py) -------------------------------------

def _chaos_store(n=800):
    rng = np.random.default_rng(42)
    sft = T.parse_spec("pts", SPEC)
    ds = T.store()
    ds.create_schema(sft)
    ds.write("pts", T.FeatureBatch.from_dict(
        sft, [f"p{i}" for i in range(n)],
        {"name": [f"n{i % 13}" for i in range(n)], "age": np.arange(n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))}))
    return ds


def _fast_policy(**kw):
    from geomesa_tpu_torch.resilience import RetryPolicy
    kw.setdefault("max_attempts", 40)
    kw.setdefault("base_s", 0.02)
    kw.setdefault("cap_s", 0.25)
    kw.setdefault("total_deadline_s", 30.0)
    return RetryPolicy(**kw)


class TestRemoteChaos:
    def test_query_equivalence_under_resets_and_jitter(self):
        """1,000 queries through 1 % resets and jitter: zero client
        errors and ids identical to the fault-free path."""
        from geomesa_tpu_torch.resilience import ChaosProxy
        with served(T, _chaos_store()) as srv:
            proxy = ChaosProxy("127.0.0.1", srv.port, reset_rate=0.01,
                               jitter_s=0.002, seed=7).start()
            try:
                direct = T.Remote("127.0.0.1", srv.port)
                faulty = T.Remote("127.0.0.1", proxy.port, timeout_s=10.0,
                                  retry_policy=_fast_policy())
                rng = np.random.default_rng(3)
                for _ in range(1000):
                    x0, y0 = rng.uniform(-100, -65), rng.uniform(25, 46)
                    cql = (f"BBOX(geom, {x0}, {y0}, "
                           f"{x0 + rng.uniform(1, 10)}, "
                           f"{y0 + rng.uniform(1, 6)})")
                    assert sorted(_ids(faulty.query(cql, "pts"))) == \
                        sorted(_ids(direct.query(cql, "pts")))
                assert proxy.stats["resets"] > 0
            finally:
                proxy.stop()

    def test_breaker_fast_fails_without_burning_timeout(self):
        from geomesa_tpu_torch.metrics import MetricsRegistry
        from geomesa_tpu_torch.resilience import (BreakerBoard, ChaosProxy,
                                                  CircuitOpenError,
                                                  RetryPolicy)
        with served(T, _chaos_store(10)) as srv:
            proxy = ChaosProxy("127.0.0.1", srv.port, blackhole=True).start()
            try:
                ds = T.Remote("127.0.0.1", proxy.port, timeout_s=0.4,
                              retry_policy=RetryPolicy(
                                  max_attempts=1,
                                  registry=MetricsRegistry()),
                              breakers=BreakerBoard(failure_threshold=2,
                                                    reset_timeout_s=30.0))
                for _ in range(2):
                    with pytest.raises(OSError):
                        ds.get_type_names()
                t0 = time.perf_counter()
                with pytest.raises(CircuitOpenError):
                    ds.get_type_names()
                assert time.perf_counter() - t0 < 0.1
            finally:
                proxy.stop()

    def test_write_retries_connect_phase_only(self):
        from geomesa_tpu_torch.resilience import BreakerBoard
        store = _chaos_store(10)
        sink = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sink.bind(("127.0.0.1", 0))
        port = sink.getsockname()[1]
        sink.close()
        ds = T.Remote("127.0.0.1", port, retry_policy=_fast_policy(),
                      breakers=BreakerBoard(failure_threshold=100))
        box = {}

        def bring_up():
            time.sleep(0.4)
            box["srv"] = T.Server(store, port=port).start()
        th = threading.Thread(target=bring_up)
        th.start()
        try:
            sft = store.get_schema("pts")
            ds.write("pts", T.FeatureBatch.from_dict(
                sft, ["w0"], {"name": ["late"], "age": np.array([1]),
                              "dtg": np.array([5]),
                              "geom": (np.array([-70.0]),
                                       np.array([30.0]))}))
            assert store.count("pts") == 11
        finally:
            th.join()
            box["srv"].stop()


# -- TestRemoteHedgeGating (test_tail_latency.py) -----------------------------

def _gates(P, case):
    remote = P.Remote("127.0.0.1", 1, hedge=(case != "hedge_false"))
    attempt = lambda: "x"  # noqa: E731
    ep = "write" if case == "non_idempotent" else "query"
    breaker = remote._breakers.get(ep)
    out = [remote._maybe_hedged(attempt, breaker, ep, True) is attempt]
    remote._breakers.observe(ep, 0.02)
    if case == "open_breaker":
        for _ in range(breaker.failure_threshold):
            breaker.failure()
        assert breaker.state == "open"
    hedge = mod(P, "resilience.hedge").HEDGE_ENABLED
    if case == "kill_switch":
        hedge.set("false")
    try:
        idem = case != "non_idempotent"
        wrapped = remote._maybe_hedged(attempt, breaker, ep, idem)
        out.append(wrapped is attempt)
        out.append(remote._maybe_hedged(attempt, breaker, ep, idem,
                                        streaming=True) is attempt)
        if wrapped is not attempt:
            out.append(wrapped())
    finally:
        hedge.set(None)
    return out


@pytest.mark.parametrize("case", ["estimate_and_closed", "non_idempotent",
                                  "open_breaker", "kill_switch",
                                  "hedge_false"])
def test_hedge_gates_equal_reference(case):
    j, t = both(lambda P: _gates(P, case))
    assert t == j
    if case == "estimate_and_closed":
        assert t == [True, False, True, "x"]
    else:
        assert t[1:] == [True, True]


def test_remote_identity_is_host_port():
    from geomesa_tpu_torch.scan.registry import store_identity
    a = T.Remote("10.0.0.1", 8080)
    b = T.Remote("10.0.0.1", 8080)
    c = T.Remote("10.0.0.1", 8081)
    assert store_identity(a) == store_identity(b) == ("remote", "10.0.0.1",
                                                      8080)
    assert store_identity(a) != store_identity(c)


def test_remote_result_is_host_arrays():
    """The client holds no device: ids and rows are numpy, rows the
    positions of the result."""
    with served(T, seeded_store(T)) as srv:
        res = T.Remote("127.0.0.1", srv.port).query("age < 7", "people")
    assert isinstance(res.ids, np.ndarray) and isinstance(res.rows,
                                                          np.ndarray)
    assert res.rows.tolist() == list(range(7)) and res.n == 7
    assert type(res).__module__ == "geomesa_tpu_torch.store.memory"


# -- the lifecycle calls: views and schema evolution --------------------------

def test_remote_views_and_evolve_over_writes_equal_reference():
    """The views and evolve calls through each package's client and
    server while rows are written and deleted through the same client:
    the view's rows at each fold and the evolver's documents (times left
    out) equal the reference's; each view read carries the rows the
    store's own SQL engine gives."""
    from test_torch_web import lifecycle_steady, lifecycle_switches
    sql = ("SELECT name, count(*) AS c, sum(age) AS s FROM people "
           "GROUP BY name")

    def run(P):
        rng = np.random.default_rng(11)
        with lifecycle_switches("true"), \
                served(P, seeded_store(P), auth_token="tok") as srv:
            ds = P.Remote("127.0.0.1", srv.port, hedge=False,
                          auth_token="tok")
            sft = srv.store.get_schema("people")
            out = [lifecycle_steady(ds.views_register("v", sql))]
            for step in range(3):
                ds.write("people", make_batch(P, sft, 100 + 10 * step, 10,
                                              rng))
                ds.delete("people", [f"p{step * 7}", f"p{step * 7 + 1}"])
                got = ds.views_get("v")
                engine = mod(P, "sql").SqlEngine(srv.store).query(sql)
                assert got["rows"] == json.loads(json.dumps(
                    [[x.item() if isinstance(x, np.generic) else x
                      for x in r] for r in engine.rows()]))
                out.append(got)
            out.append(lifecycle_steady(ds.evolve(
                "update", type="people", changes=[
                    {"op": "widen", "name": "age", "type": "Long"}])))
            out.append(lifecycle_steady(ds.evolve_status()))
            out.append(lifecycle_steady(ds.views_status()))
            return out
    j, t = both(run)
    assert t == j
