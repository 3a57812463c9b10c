"""The port's REST surface (``geomesa_tpu_torch.web``) against the JAX
package's on the CPU.

Both servers bind ports the OS picks and serve stores built from the
same numpy seed (the port's on ``device="cpu"``). The wire cases send
the same requests, in the same order, to both and hold the replies
equal: status, content type, ETag and the other GeoMesa headers, and the
body byte for byte (JSON compared parsed, with the fields that are
times, trace ids or uptime left out). The JAX suites' web classes
(``test_web_surfaces.py`` and the web classes of the cache, WAL,
integrity, CQ, KNN, streaming, ingest, health, QoS and tracing suites)
each have a counterpart here that runs its scenario in both packages
and holds the answers equal. The scrubber runs on a journal beside the
JAX one. The lifecycle routes (``/rest/views``, ``/rest/evolve``)
answer as the reference's do with the kill switches off and on, through
either package's client. The admin routes of the
replicated and sharded tiers (``/rest/replication``, ``/rest/cluster``,
``/rest/topology``, ``/rest/reshard``) answer over a replicated store
and a cluster as the reference's do (``TestRestSurface`` of
``tests/test_cluster.py`` and ``tests/test_reshard.py``).

The ``gpu`` tests at the end import no JAX (the module's JAX imports are
skipped with ``--noconftest``): a server over a CUDA store answers
``/rest/query``, ``/rest/density`` and ``/rest/knn`` as direct calls
do, and the kernels' launch counts move. Run them with ``python -m
pytest --noconftest -m gpu tests/test_torch_web.py``.

Every socket binds port 0, every server stops in a ``finally``, every
wait is bounded and the process-wide singletons of both packages are
reset around each test."""

import contextlib
import http.client
import io
import json
import os
import threading
import time
import types
import urllib.parse

import numpy as np
import pytest

import geomesa_tpu_torch.metrics as t_metrics
import geomesa_tpu_torch.obs as t_obs
import geomesa_tpu_torch.scan.registry as t_scanreg
import geomesa_tpu_torch.tenants as t_tenants
from geomesa_tpu_torch.features import FeatureBatch as TFeatureBatch
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.index.api import Query as TQuery
from geomesa_tpu_torch.store.memory import InMemoryDataStore as TStore
from geomesa_tpu_torch.store.remote import RemoteDataStore as TRemote
from geomesa_tpu_torch.utils.properties import SystemProperty as TProperty
from geomesa_tpu_torch.web import GeoMesaWebServer as TServer

try:        # the CPU tests hold the port to the JAX package
    import geomesa_tpu.metrics as j_metrics
    import geomesa_tpu.obs as j_obs
    import geomesa_tpu.scan.registry as j_scanreg
    import geomesa_tpu.tenants as j_tenants
    from geomesa_tpu.features import FeatureBatch as JFeatureBatch
    from geomesa_tpu.features import parse_spec as j_parse_spec
    from geomesa_tpu.index.api import Query as JQuery
    from geomesa_tpu.store.memory import InMemoryDataStore as JStore
    from geomesa_tpu.store.remote import RemoteDataStore as JRemote
    from geomesa_tpu.utils.properties import SystemProperty as JProperty
    from geomesa_tpu.web import GeoMesaWebServer as JServer
except ImportError:     # the card's machine has no JAX: gpu tests only
    JServer = None

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"
BB = (-100.0, 25.0, -60.0, 50.0)


def _ns(name, pkg, server, store, remote, batch, parse, query, prop,
        metrics, obs, scanreg, tenants):
    return types.SimpleNamespace(
        name=name, pkg=pkg, Server=server, Store=store, Remote=remote,
        FeatureBatch=batch, parse_spec=parse, Query=query, Property=prop,
        metrics=metrics.metrics, obs=obs, scanreg=scanreg, tenants=tenants,
        store=((lambda **kw: store(**kw)) if name == "jax"
               else (lambda **kw: store(device="cpu", **kw))))


T = _ns("torch", "geomesa_tpu_torch", TServer, TStore, TRemote,
        TFeatureBatch, t_parse_spec, TQuery, TProperty, t_metrics, t_obs,
        t_scanreg, t_tenants)
if JServer is not None:
    J = _ns("jax", "geomesa_tpu", JServer, JStore, JRemote, JFeatureBatch,
            j_parse_spec, JQuery, JProperty, j_metrics, j_obs, j_scanreg,
            j_tenants)
    PKGS = (J, T)
else:
    PKGS = (T,)

needs_jax = pytest.mark.skipif(JServer is None, reason="needs JAX")


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


def mod(P, name):
    """A submodule of P's package (``mod(P, "web.server")``)."""
    import importlib
    return importlib.import_module(f"{P.pkg}.{name}")


@pytest.fixture(autouse=True)
def _hygiene():
    """Reset the process-wide singletons of both packages around each
    test; no test may leave the profiler running."""
    def reset():
        for P in PKGS:
            P.obs.tracer.clear()
            P.obs.slo_engine.clear()
            P.obs.runtime.clear()
            P.obs.watchdog.clear()
            P.scanreg.batcher_registry.clear()
            P.tenants.tenant_registry.reset()
    reset()
    yield
    for P in PKGS:
        assert not P.obs.profiler.running, "a test left the profiler on"
    reset()


def seeded_store(P, n=100, name="people", **kw):
    """The JAX web suite's store: n people in BB, ages 0..n-1."""
    rng = np.random.default_rng(5)
    sft = P.parse_spec(name, SPEC)
    ds = P.store(**kw)
    ds.create_schema(sft)
    ds.write(name, make_batch(P, sft, 0, n, rng))
    return ds


def make_batch(P, sft, i0, n, rng):
    return P.FeatureBatch.from_dict(
        sft, [f"p{i}" for i in range(i0, i0 + n)],
        {"name": [f"n{i % 7}" for i in range(i0, i0 + n)],
         "age": np.arange(i0, i0 + n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(BB[0], BB[2], n), rng.uniform(BB[1], BB[3], n))})


@contextlib.contextmanager
def served(P, store, **kw):
    srv = P.Server(store, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


def call(srv, method, path, body=None, headers=None):
    """One request -> (status, {header: value}, body bytes); a chunked
    body is read to its end."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def jbody(reply):
    return json.loads(reply[2] or b"null")


# fields that are times, trace ids or uptime: left out of the comparison
VOLATILE = {"uptime_s", "seconds", "trace_id", "span_id", "parent_id",
            "duration_ms", "start_ms", "end_ms", "ts", "ts_ms", "time_ms",
            "last_run_s", "since_s", "age_s"}
# headers compared between the two servers (Date and Server are not)
WIRE_HEADERS = ("Content-Type", "ETag", "Transfer-Encoding",
                "X-GeoMesa-Complete", "X-GeoMesa-Missing-Groups",
                "X-GeoMesa-Topology-Epoch")


def steady(obj, volatile=VOLATILE):
    if isinstance(obj, dict):
        return {k: steady(v, volatile) for k, v in obj.items()
                if k not in volatile}
    if isinstance(obj, list):
        return [steady(v, volatile) for v in obj]
    return obj


def same_reply(got, want):
    """The port's reply equals the reference's: status, the wire headers,
    and the body (JSON parsed and steadied, anything else byte equal)."""
    assert got[0] == want[0], (got, want)
    for h in WIRE_HEADERS:
        assert got[1].get(h) == want[1].get(h), h
    if want[1].get("Content-Type") == "application/json" and want[2]:
        assert steady(json.loads(got[2])) == steady(json.loads(want[2]))
    else:
        assert got[2] == want[2]


@pytest.fixture
def pair():
    """(JAX server, port server) over seeded stores of the same rows."""
    with served(J, seeded_store(J)) as js, served(T, seeded_store(T)) as ts:
        yield js, ts


def q(s):
    return urllib.parse.quote(s)


SQL_SELECT = ("SELECT name, age FROM people WHERE "
              "ST_Contains(ST_MakeBBOX(-100, 25, -60, 50), geom) "
              "AND age < 3 ORDER BY age")
WIRE_CASES = [
    ("GET", "/rest/version", None),
    ("GET", "/rest/schemas", None),
    ("GET", "/rest/schemas/people", None),
    ("GET", f"/rest/query/people?cql={q('age < 5')}", None),
    ("GET", f"/rest/query/people?cql={q('age = 3')}&format=geojson", None),
    ("GET", f"/rest/query/people?cql={q('age < 10')}&format=arrow", None),
    ("GET", f"/rest/query/people?cql={q('age < 10')}&format=arrow-stream"
            "&batchRows=4", None),
    ("GET", f"/rest/query/people?cql={q('age < 10')}&format=bin&track=name",
     None),
    ("GET", f"/rest/query/people?cql={q('age < 10')}&sortBy=age"
            "&sortOrder=desc&maxFeatures=4", None),
    ("GET", "/rest/query/people?cql=INCLUDE&properties=name,geom"
            "&maxFeatures=3&sortBy=name", None),
    ("GET", "/rest/query/people?cql=INCLUDE&sampling=0.1", None),
    ("GET", f"/rest/query/people?cql={q('BBOX(geom, -90, 30, -70, 45)')}"
            "&auths=a&index=z2", None),
    ("GET", "/rest/count/people", None),
    ("GET", f"/rest/count/people?cql={q('age < 40')}", None),
    ("GET", "/rest/count/people?cql=INCLUDE&sampling=0.2&sampleBy=name",
     None),
    ("GET", "/rest/count/people?cql=INCLUDE&maxFeatures=7", None),
    ("GET", f"/rest/estimate/people?cql={q('age < 40')}", None),
    ("GET", "/rest/knn/people?x=-80&y=30&k=5", None),
    ("GET", "/rest/knn/people?x=nope", None),
    ("GET", "/rest/stats/people?stat=MinMax(age)", None),
    ("GET", f"/rest/stats/people?stat=Count()&cql={q('age < 10')}", None),
    ("GET", "/rest/stats/people?stat=Enumeration(name)", None),
    ("GET", "/rest/density/people?bbox=-100,25,-60,50&width=16&height=8",
     None),
    ("GET", f"/rest/density/people?bbox=-100,25,-60,50&width=4&height=4"
            f"&cql={q('age > 50')}", None),
    ("GET", f"/rest/bin/people?cql={q('age < 50')}&track=name", None),
    ("GET", "/rest/bin/people?sort=true", None),
    ("GET", f"/rest/sql?q={q(SQL_SELECT)}", None),
    ("POST", "/rest/sql", b"SELECT COUNT(*) FROM people"),
    ("POST", "/rest/sql?mode=partial",
     b"SELECT name, COUNT(*) FROM people GROUP BY name"),
    ("GET", "/rest/sql", None),
    ("GET", "/rest/query/people?cql=%3C%3C%3C", None),
    ("GET", "/rest/query/nope?cql=INCLUDE", None),
    ("GET", "/rest/schemas/nope", None),
    ("GET", "/rest/count/nope", None),
    ("GET", "/rest/nope", None),
    ("GET", "/other", None),
    ("GET", "/rest/wal", None),
    ("POST", "/rest/wal/checkpoint", b""),
    ("GET", "/rest/integrity", None),
    ("POST", "/rest/integrity/scrub", b""),
    ("GET", "/rest/replication", None),
    ("POST", "/rest/replication/promote", b""),
    ("GET", "/rest/cluster", None),
    ("POST", "/rest/cluster/promote?group=g", b""),
    ("GET", "/rest/topology", None),
    ("GET", "/rest/reshard", None),
    ("POST", "/rest/reshard/split?src=g", b""),
    ("GET", "/rest/cq", None),
    ("POST", "/rest/cq/register?name=x&type=people", b""),
    ("GET", "/rest/cq/nope", None),
    ("POST", "/rest/cache/invalidate?type=people", b""),
    ("POST", "/rest/reindex/people", b""),
    ("GET", "/rest/qos", None),
    ("GET", "/rest/ready", None),
    ("GET", "/rest/trace/deadbeef", None),
    ("GET", "/rest/audit?type=nope", None),
    ("POST", "/rest/delete/people", b'["p1", "p2", "nope"]'),
    ("DELETE", "/rest/schemas/people", None),
    ("POST", "/rest/schemas/fresh", b"a:Integer,*geom:Point"),
]


@needs_jax
@pytest.mark.parametrize("method,path,body", WIRE_CASES,
                         ids=[f"{m} {p[:60]}" for m, p, _ in WIRE_CASES])
def test_same_wire(pair, method, path, body):
    """The same request on the same writes: the same reply."""
    js, ts = pair
    same_reply(call(ts, method, path, body), call(js, method, path, body))
    # and the state it left behind answers the same
    after = "/rest/schemas"
    same_reply(call(ts, "GET", after), call(js, "GET", after))


@needs_jax
def test_same_wire_sequence(pair):
    """A whole session on one pair of servers: each reply equal, the
    conditional requests included (ETags computed from equal versions)."""
    js, ts = pair
    steps = [c for c in WIRE_CASES if c[0] == "GET"
             and "trace" not in c[1]] + [
        ("POST", "/rest/delete/people", b'["p7"]'),
        ("GET", f"/rest/query/people?cql={q('age < 10')}", None),
        ("GET", "/rest/density/people?bbox=-100,25,-60,50&width=16&height=8",
         None),
        ("GET", "/rest/cache", None),
        ("GET", "/rest/health", None)]
    for method, path, body in steps:
        got, want = call(ts, method, path, body), call(js, method, path, body)
        if path == "/rest/health":
            # the latency estimates are each package's process history
            got, want = ([r[0], r[1], json.dumps(
                {k: v for k, v in json.loads(r[2]).items()
                 if k not in ("resilience", "uptime_s")}).encode()]
                for r in (got, want))
        same_reply(got, want)
        etag = want[1].get("ETag")
        if etag:
            hdr = {"If-None-Match": etag}
            g304, w304 = (call(ts, method, path, body, hdr),
                          call(js, method, path, body, hdr))
            same_reply(g304, w304)
            assert w304[0] == 304 and w304[2] == b""


# -- TestRest (test_web_surfaces.py) ------------------------------------------

@needs_jax
class TestRest:
    def test_version_and_schemas(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                out = [jbody(call(srv, "GET", p)) for p in
                       ("/rest/version", "/rest/schemas",
                        "/rest/schemas/people")]
            assert out[1] == ["people"]
            assert out[2]["attributes"][0] == {"name": "name",
                                               "type": "String"}
            return out
        j, t = both(run)
        assert t == j

    def test_query_formats(self):
        def run(P):
            from_ipc = mod(P, "arrow").read_ipc_batches
            with served(P, seeded_store(P)) as srv:
                js = jbody(call(srv, "GET",
                                f"/rest/query/people?cql={q('age < 5')}"))
                st, hdrs, body = call(
                    srv, "GET", "/rest/query/people?cql=age%3D3"
                                "&format=geojson")
                assert hdrs["Content-Type"] == "application/geo+json"
                gj = json.loads(body)
                st, hdrs, body = call(
                    srv, "GET", f"/rest/query/people?cql={q('age < 10')}"
                                "&format=arrow")
                assert hdrs["Content-Type"] == \
                    "application/vnd.apache.arrow.file"
                _, batch = from_ipc(body)
            assert js["count"] == 5 and batch.n == 10
            f = gj["features"][0]
            assert f["properties"]["age"] == 3
            assert f["geometry"]["type"] == "Point"
            return js, gj, list(batch.ids)
        j, t = both(run)
        assert t == j

    def test_stats_and_density(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                st = jbody(call(srv, "GET",
                                "/rest/stats/people?stat=MinMax(age)"))
                d = jbody(call(srv, "GET", "/rest/density/people?"
                                           "bbox=-100,25,-60,50&width=16"
                                           "&height=8"))
            assert st["min"] == 0 and st["max"] == 99
            assert sum(sum(r) for r in d["grid"]) == 100
            return st, d
        j, t = both(run)
        assert t == j

    def test_create_and_delete_schema(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                a = call(srv, "POST", "/rest/schemas/tmp",
                         b"a:Integer,*geom:Point")
                b = jbody(call(srv, "GET", "/rest/schemas"))
                c = call(srv, "DELETE", "/rest/schemas/tmp")
                d = jbody(call(srv, "GET", "/rest/schemas"))
            assert a[0] == 201 and "tmp" in b and c[0] == 200
            return a[0], jbody(a), b, c[0], d
        j, t = both(run)
        assert t == j

    def test_viewparams_hints(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                desc = jbody(call(srv, "GET", f"/rest/query/people?cql="
                                  f"{q('age < 10')}&sortBy=age"
                                  f"&sortOrder=desc"))
                sampled = jbody(call(srv, "GET", "/rest/query/people"
                                     "?cql=INCLUDE&sampling=0.1"))
            ages = [f["age"] for f in desc["features"]]
            assert ages == sorted(ages, reverse=True) and len(ages) == 10
            assert 0 < sampled["count"] < 100
            return ages, sampled
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("how", ["get", "post"])
    def test_sql_endpoint(self, how):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                if how == "get":
                    out = jbody(call(srv, "GET",
                                     f"/rest/sql?q={q(SQL_SELECT)}"))
                    assert out["columns"] == ["name", "age"]
                    assert [r[1] for r in out["rows"]] == [0, 1, 2]
                else:
                    out = jbody(call(srv, "POST", "/rest/sql",
                                     b"SELECT COUNT(*) FROM people"))
                    assert out["rows"][0][0] == 100
            return out
        j, t = both(run)
        assert t == j

    def test_bad_cql_is_400(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                return call(srv, "GET", "/rest/query/people?cql=%3C%3C%3C")[0]
        assert both(run) == (400, 400)


# -- the lifecycle routes: /rest/views and /rest/evolve -----------------------

ITEM8_ROUTES = [("GET", "/rest/views"), ("GET", "/rest/views/v1"),
                ("POST", "/rest/views/register?name=v&sql=SELECT%201"),
                ("POST", "/rest/views/unregister?name=v"),
                ("POST", "/rest/views/refresh?name=v"),
                ("GET", "/rest/evolve"),
                ("POST", "/rest/evolve/reindex?type=people"),
                ("POST", "/rest/evolve/update?type=people"),
                ("POST", "/rest/evolve/resume"),
                ("POST", "/rest/evolve/abort")]
LIFECYCLE_SWITCHES = ("geomesa.views.enabled", "geomesa.evolve.enabled")
# the evolver's times: left out of the lifecycle documents' comparison
LIFECYCLE_VOLATILE = VOLATILE | {"flip_ms", "started_ms"}


def lifecycle_steady(obj):
    return steady(obj, LIFECYCLE_VOLATILE)


@contextlib.contextmanager
def lifecycle_switches(value):
    """Both packages' views and evolve switches set to ``value`` (None:
    the default, off) for the block."""
    props = [P.Property(name, "false") for P in PKGS
             for name in LIFECYCLE_SWITCHES]
    for prop in props:
        prop.set(value)
    try:
        yield
    finally:
        for prop in props:
            prop.set(None)


@needs_jax
@pytest.mark.parametrize("switch", [None, "true"])
@pytest.mark.parametrize("method,path", ITEM8_ROUTES)
def test_item8_routes_equal_reference(method, path, switch):
    """Every route of /rest/views and /rest/evolve answers with the
    reference server's status, headers and body, with the features' kill
    switches off and on; the bearer gate comes first on a POST."""
    def run(P):
        with lifecycle_switches(switch), \
                served(P, seeded_store(P), auth_token="tok") as srv:
            out = []
            if method == "POST":
                out.append(call(srv, method, path, b""))
            out.append(call(srv, method, path, b"" if method == "POST"
                            else None, {"Authorization": "Bearer tok"}))
            return out
    j, t = both(run)
    for got, want in zip(t, j):
        for h in WIRE_HEADERS:
            assert got[1].get(h) == want[1].get(h), h
        assert (got[0], lifecycle_steady(json.loads(got[2]))) \
            == (want[0], lifecycle_steady(json.loads(want[2])))
    if method == "POST":
        assert t[0][0] == 403
    assert t[-1][0] != 500


LIFECYCLE_CALLS = [
    ("views_status", ()), ("views_get", ("v",)),
    ("views_register", ("v", "SELECT name, count(*) AS c FROM people "
                             "GROUP BY name")),
    ("views_register", ("w", "SELECT count(*) FROM people")),
    ("views_status", ()), ("views_get", ("v",)), ("views_refresh", ("v",)),
    ("views_unregister", ("v",)), ("views_get", ("v",)),
    ("evolve_status", ()), ("evolve", ("reindex",), {"type": "people",
                                                     "version": 1}),
    ("evolve", ("update",), {"type": "people", "changes": [
        {"op": "add", "name": "score", "type": "Double", "default": 2.5}]}),
    ("evolve", ("update",), {"type": "people", "changes": [
        {"op": "drop", "name": "geom"}]}),
    ("evolve", ("resume",)), ("evolve", ("abort",)), ("evolve_status", ()),
    ("reindex", ("people", 2)),
]


def lifecycle_session(client, calls=LIFECYCLE_CALLS):
    """Each call's answer (times left out) or its error type and text."""
    out = []
    for c in calls:
        name, args, kw = c if len(c) == 3 else (*c, {})
        try:
            out.append(("ok", lifecycle_steady(
                getattr(client, name)(*args, **kw))))
        except Exception as e:   # noqa: BLE001 - the error is the answer
            out.append((type(e).__name__, str(e)))
    return out


@needs_jax
@pytest.mark.parametrize("switch", [None, "true"])
def test_remote_item8_calls_equal_reference(switch):
    """The port's client against the port's server answers every views
    and evolve call as the JAX client against the JAX server does (the
    same documents, the same error types and texts), with no retry."""
    def run(P):
        with lifecycle_switches(switch), \
                served(P, seeded_store(P), auth_token="tok") as srv:
            ds = P.Remote("127.0.0.1", srv.port, hedge=False,
                          auth_token="tok")
            r0 = P.metrics.snapshot()["counters"].get(
                "resilience.retries", 0)
            out = lifecycle_session(ds)
            assert P.metrics.snapshot()["counters"].get(
                "resilience.retries", 0) == r0
            return out, srv.store.get_schema("people").to_spec()
    j, t = both(run)
    assert t == j
    if switch:
        assert [k for k, _ in t[0]].count("ok") >= 10


@needs_jax
@pytest.mark.parametrize("client_pkg", ["jax", "torch"])
def test_lifecycle_session_across_packages(client_pkg):
    """One package's client drives a views and evolve session through
    the other package's server: the answers equal the same session
    within one package (the wire is the reference's both ways)."""
    C = J if client_pkg == "jax" else T
    S = T if client_pkg == "jax" else J

    def session(server_pkg, client):
        with lifecycle_switches("true"), \
                served(server_pkg, seeded_store(server_pkg),
                       auth_token="tok") as srv:
            ds = client.Remote("127.0.0.1", srv.port, hedge=False,
                               auth_token="tok")
            return (lifecycle_session(ds),
                    srv.store.get_schema("people").to_spec(),
                    sorted(map(str, srv.store.query("INCLUDE",
                                                    "people").ids)))
    assert session(S, C) == session(C, C)


@needs_jax
def test_no_route_carries_an_unknown_hint():
    """The port's store raises NotImplementedError for a hint it does not
    know, where the JAX store ignores it. No route can hand it one: the
    URL maps only onto SAMPLING, SAMPLE_BY and QUERY_INDEX (each read by
    the store), and the client's query and count send only those, so an
    unknown hint never crosses the wire (the count falls back to the
    query surface, as in the reference)."""
    from geomesa_tpu_torch.index.api import QueryHints
    from geomesa_tpu_torch.store import memory
    seen = []
    with served(T, seeded_store(T)) as srv:
        parsed = srv._parse_query("people", {
            "cql": ["INCLUDE"], "sampling": ["0.5"], "sampleBy": ["name"],
            "index": ["z2"], "maxFeatures": ["3"], "sortBy": ["age"],
            "properties": ["age"], "auths": ["a"], "bogus": ["1"]})
        assert set(parsed.hints) == {QueryHints.SAMPLING,
                                     QueryHints.SAMPLE_BY,
                                     QueryHints.QUERY_INDEX}
        assert set(parsed.hints) <= memory._READ_HINTS
        real = srv.store.query

        def spy(qq, *a, **kw):
            if not isinstance(qq, str):
                seen.append(dict(qq.hints))
            return real(qq, *a, **kw)
        srv.store.query = spy
        srv.batcher = None          # every query reaches store.query
        ds = T.Remote("127.0.0.1", srv.port, hedge=False)
        hinted = T.Query("people", "age < 10",
                         hints={"NOT_A_HINT": 1, QueryHints.BIN_TRACK: "x"})
        assert ds.query(hinted).n == 10
        assert ds.query_count(hinted) == 10
        e500 = T.metrics.snapshot()["counters"].get("resilience.web.errors", 0)
    assert seen and all(set(h) <= memory._READ_HINTS for h in seen)
    assert e500 == T.metrics.snapshot()["counters"].get(
        "resilience.web.errors", 0)
    with pytest.raises(NotImplementedError):
        seeded_store(T).query(hinted)       # the store itself refuses it


# -- TestWebAuthGate (test_web_surfaces.py) -----------------------------------

TOKEN = "s3kr1t"
GATED = [("POST", "/rest/write/people", b"x"),
         ("POST", "/rest/delete/people", b'["p0"]'),
         ("DELETE", "/rest/schemas/people", None)]


@needs_jax
class TestWebAuthGate:
    def test_gated_endpoints_403_without_token(self):
        def run(P):
            out = []
            with served(P, seeded_store(P), auth_token=TOKEN) as srv:
                for method, path, data in GATED:
                    st, _, body = call(srv, method, path, data)
                    assert st == 403 and json.loads(body) == {
                        "error": "forbidden"}
                    st2 = call(srv, method, path, data,
                               {"Authorization": "Bearer wrong"})[0]
                    assert st2 == 403
                    out.append((st, st2))
                st, _, body = call(srv, "GET",
                                   f"/rest/query/people?cql={q('age < 5')}")
                assert st == 200 and json.loads(body)["count"] == 5
                assert srv.store.count("people") == 100
            return out
        j, t = both(run)
        assert t == j

    def test_bearer_token_authorizes_mutations(self):
        def run(P):
            auth = {"Authorization": f"Bearer {TOKEN}"}
            with served(P, seeded_store(P), auth_token=TOKEN) as srv:
                a = call(srv, "POST", "/rest/delete/people",
                         b'["p0", "p1"]', auth)
                n = srv.store.count("people")
                b = call(srv, "DELETE", "/rest/schemas/people", None, auth)
                names = srv.store.get_type_names()
            assert a[0] == 200 and jbody(a)["deleted"] == 2 and n == 98
            assert b[0] == 200 and names == []
            return jbody(a), n, jbody(b), names
        j, t = both(run)
        assert t == j

    def test_remote_store_client_sends_token(self):
        def run(P):
            with served(P, P.store(), auth_token=TOKEN) as srv:
                ds = P.Remote("127.0.0.1", srv.port, auth_token=TOKEN)
                ds.create_schema(P.parse_spec("t", "name:String,*geom:Point"))
                ds.write_dict("t", ["a", "b"],
                              {"name": ["x", "y"],
                               "geom": ([0.0, 1.0], [0.0, 1.0])})
                assert ds.count("t") == 2
                bare = P.Remote("127.0.0.1", srv.port)
                with pytest.raises(Exception, match="forbidden"):
                    bare.delete("t", ["a"])
                return ds.count("t")
        assert both(run) == (2, 2)

    def test_unset_token_leaves_endpoints_open(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                return jbody(call(srv, "POST", "/rest/delete/people",
                                  b'["p0"]'))
        j, t = both(run)
        assert t == j and t["deleted"] == 1


# -- TestWebResilience (test_web_surfaces.py) ---------------------------------

class _SlowStore:
    """Wraps a store so query() blocks until released, and hides
    query_batched (no batcher: the blocking query() is what a request
    thread sits in)."""

    def __init__(self, inner, entered, release):
        self._inner, self._entered, self._release = inner, entered, release

    def __getattr__(self, name):
        if name == "query_batched":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def query(self, *a, **k):
        self._entered.set()
        self._release.wait(10.0)
        return self._inner.query(*a, **k)


class _Exploding:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "query_batched":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def stats_query(self, *a, **k):
        raise RuntimeError("disk on fire")


@needs_jax
class TestWebResilience:
    def test_health_and_ready(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                h = call(srv, "GET", "/rest/health")
                r = call(srv, "GET", "/rest/ready")
            d = json.loads(h[2])
            assert h[0] == 200 and d["status"] == "ok" and d["uptime_s"] >= 0
            assert r[0] == 200 and jbody(r)["ready"] and jbody(r)["store_ok"]
            return sorted(d), jbody(r)
        j, t = both(run)
        assert t == j

    def test_unexpected_fault_is_500_not_400(self):
        def run(P):
            e0 = P.metrics.snapshot()["counters"].get(
                "resilience.web.errors", 0)
            with served(P, _Exploding(seeded_store(P))) as srv:
                a = call(srv, "GET", "/rest/query/people?cql=%3C%3C%3C")[0]
                st, _, body = call(srv, "GET",
                                   "/rest/stats/people?stat=MinMax(age)")
            assert "disk on fire" in json.loads(body)["error"]
            return a, st, P.metrics.snapshot()["counters"][
                "resilience.web.errors"] - e0
        assert both(run) == ((400, 500, 1), (400, 500, 1))

    def test_shed_503_with_retry_after(self):
        def run(P):
            entered, release = threading.Event(), threading.Event()
            results = {}
            with served(P, _SlowStore(seeded_store(P), entered, release),
                        max_inflight=1) as srv:
                t = threading.Thread(target=lambda: results.update(
                    slow=call(srv, "GET", "/rest/query/people?cql=INCLUDE")),
                    daemon=True)
                t.start()
                try:
                    assert entered.wait(5.0)
                    st, hdrs, body = call(srv, "GET", "/rest/version")
                    assert st == 503 and float(hdrs["Retry-After"]) > 0
                    assert json.loads(body)["retryable"] is True
                    ready = call(srv, "GET", "/rest/ready")[0]
                    health = call(srv, "GET", "/rest/health")[0]
                finally:
                    release.set()
                    t.join(5.0)
                after = call(srv, "GET", "/rest/ready")[0]
            return st, ready, health, results["slow"][0], after
        assert both(run) == ((503, 503, 200, 200, 200),) * 2

    def test_remote_client_absorbs_shed(self):
        def run(P):
            entered, release = threading.Event(), threading.Event()
            retry_after = mod(P, "web.server").WEB_RETRY_AFTER
            with served(P, _SlowStore(seeded_store(P), entered, release),
                        max_inflight=1) as srv:
                retry_after.set("0.05")
                t = threading.Thread(target=lambda: call(
                    srv, "GET", "/rest/query/people?cql=INCLUDE"),
                    daemon=True)
                t.start()

                def release_after_two_sheds():
                    # the client has been shed twice: free the slot
                    deadline = time.monotonic() + 10.0
                    while sheds() < shed0 + 2 and \
                            time.monotonic() < deadline:
                        time.sleep(0.002)
                    release.set()

                def sheds():
                    return P.metrics.snapshot()["counters"].get(
                        "resilience.web.sheds", 0)
                shed0 = sheds()
                releaser = threading.Thread(target=release_after_two_sheds,
                                            daemon=True)
                try:
                    assert entered.wait(5.0)
                    releaser.start()
                    return P.Remote("127.0.0.1", srv.port).count("people")
                finally:
                    retry_after.set(None)
                    release.set()
                    releaser.join(10.0)
                    t.join(5.0)
        assert both(run) == (100, 100)


# -- TestWebSurface (test_result_cache.py) ------------------------------------

DENSITY = {"bbox": [",".join(str(v) for v in BB)], "width": ["16"],
           "height": ["16"]}


@needs_jax
class TestWebSurface:
    def test_density_etag_roundtrip(self):
        def run(P):
            ds = seeded_store(P, n=200)
            with served(P, ds) as srv:
                out = srv.handle("GET", "/rest/density/people", DENSITY, b"")
                etag = out[3]["ETag"]
                out2 = srv.handle("GET", "/rest/density/people", DENSITY,
                                  b"", headers={"If-None-Match": etag})
                assert out2[0] == 304 and out2[2] == b""
                assert out2[3]["ETag"] == etag
                ds.write("people", make_batch(
                    P, ds.get_schema("people"), 4000, 1,
                    np.random.default_rng(1)))
                out3 = srv.handle("GET", "/rest/density/people", DENSITY,
                                  b"", headers={"If-None-Match": etag})
            assert out3[0] == 200 and out3[3]["ETag"] != etag
            return etag, out[2], out3[3]["ETag"], out3[2]
        j, t = both(run)
        assert t == j

    def test_stats_and_bin_etags(self):
        def run(P):
            with served(P, seeded_store(P, n=200)) as srv:
                out = srv.handle("GET", "/rest/stats/people",
                                 {"stat": ["Count()"]}, b"")
                out2 = srv.handle("GET", "/rest/stats/people",
                                  {"stat": ["Count()"]}, b"",
                                  headers={"If-None-Match": out[3]["ETag"]})
                out3 = srv.handle("GET", "/rest/bin/people",
                                  {"track": ["name"]}, b"")
                out4 = srv.handle("GET", "/rest/bin/people",
                                  {"track": ["name"]}, b"",
                                  headers={"If-None-Match": out3[3]["ETag"]})
            assert json.loads(out[2])["count"] == 200 and out2[0] == 304
            assert out3[1] == "application/octet-stream" and len(out3[2])
            assert out4[0] == 304
            return out, out2, out3, out4
        j, t = both(run)
        assert t == j

    def test_metrics_endpoint(self):
        def run(P):
            ds = seeded_store(P, n=200)
            with served(P, ds) as srv:
                ds.density("people", "INCLUDE", BB, 16, 16)
                st, _, body = srv.handle("GET", "/rest/metrics", {}, b"")[:3]
            snap = json.loads(body)
            assert st == 200 and {"counters", "gauges"} <= set(snap)
            assert "cache.misses" in snap["counters"]
            return sorted(snap)
        j, t = both(run)
        assert t == j

    def test_cache_status_and_gated_invalidate(self):
        def run(P):
            ds = seeded_store(P, n=200)
            with served(P, ds) as srv:
                ds.density("people", "INCLUDE", BB, 16, 16)
                cs = json.loads(srv.handle("GET", "/rest/cache", {}, b"")[2])
                inv = srv.handle("POST", "/rest/cache/invalidate",
                                 {"type": ["people"]}, b"")
                srv.auth_token = "sekret"
                a = srv.handle("POST", "/rest/cache/invalidate", {}, b"")[0]
                b = srv.handle("POST", "/rest/cache/invalidate", {}, b"",
                               headers={"Authorization": "Bearer sekret"})[0]
            assert cs["entries"] >= 1 and cs["versions"]["people"] >= 1
            assert inv[0] == 200 and json.loads(inv[2])["invalidated"] >= 1
            return cs["versions"], json.loads(inv[2]), a, b
        j, t = both(run)
        assert t == j and t[2:] == (403, 200)

    def test_no_etag_without_exact_version(self):
        class NoVersion:
            def __init__(self, inner):
                self._inner = inner

            def get_type_names(self):
                return self._inner.get_type_names()

            def density(self, *a, **k):
                return self._inner.density(*a, **k)

        def run(P):
            with served(P, NoVersion(seeded_store(P))) as srv:
                out = srv.handle("GET", "/rest/density/people",
                                 {"bbox": [",".join(str(v) for v in BB)],
                                  "width": ["8"], "height": ["8"]}, b"")
            assert out[0] == 200 and "ETag" not in out[3]
            return out[:3]
        j, t = both(run)
        assert t == j

    def test_refresher_wired_by_knob(self):
        def run(P):
            knob = mod(P, "cache").CACHE_REFRESH_INTERVAL_S
            knob.thread_local_set("0.05")
            try:
                srv = P.Server(seeded_store(P)).start()
            finally:
                knob.thread_local_set(None)
            try:
                assert srv.refresher.status()["running"] is True
                interval = json.loads(srv.handle(
                    "GET", "/rest/cache", {}, b"")[2])["refresher"][
                    "interval_s"]
            finally:
                srv.stop()
            return interval, srv.refresher.status()["running"]
        assert both(run) == ((0.05, False), (0.05, False))


# -- TestWalRest (test_wal.py) and TestIntegrityRest (test_integrity.py) ------

WAL_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


def wal_batch(P, sft, ids, seed=7):
    rng = np.random.default_rng(seed)
    n = len(ids)
    return P.FeatureBatch.from_dict(sft, ids, {
        "name": [f"n{i % 5}" for i in range(n)],
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


def durable(P, root, **kw):
    kw.setdefault("wal_fsync", "never")
    return P.store(durable_dir=str(root), **kw)


@needs_jax
class TestWalRest:
    def test_non_durable_store_404s(self):
        def run(P):
            with served(P, P.store()) as srv:
                return [call(srv, "GET", p)[0]
                        for p in ("/rest/wal", "/rest/integrity")]
        assert both(run) == ([404, 404], [404, 404])

    def test_wal_routes_and_gating(self, tmp_path):
        def run(P):
            ds = durable(P, tmp_path / P.name)
            sft = P.parse_spec("t", WAL_SPEC)
            ds.create_schema(sft)
            ds.write("t", wal_batch(P, sft, ["a", "b"]))
            auth = {"Authorization": "Bearer tok"}
            try:
                with served(P, ds, auth_token="tok") as srv:
                    st = call(srv, "GET", "/rest/wal")
                    gate = call(srv, "POST", "/rest/wal/checkpoint", b"")[0]
                    ck = call(srv, "POST", "/rest/wal/checkpoint", b"", auth)
                    tr = call(srv, "POST", "/rest/wal/truncate", b"", auth)
                    w = call(srv, "POST", "/rest/write/t", b"", auth)
            finally:
                ds.close()
            assert st[0] == 200 and jbody(st)["last_lsn"] >= 2
            assert gate == 403 and ck[0] == 200 and jbody(ck)["lsn"] >= 2
            assert tr[0] == 200 and "segments_dropped" in jbody(tr)
            return (jbody(st)["last_lsn"], gate, jbody(ck)["lsn"],
                    jbody(tr), w[0])
        j, t = both(run)
        assert t == j


@needs_jax
class TestIntegrityRest:
    def test_report_and_gated_scrub(self, tmp_path):
        def run(P):
            flip_bit = mod(P, "integrity").flip_bit
            checkpoint_dirs = mod(P, "wal.snapshot").checkpoint_dirs
            root = tmp_path / P.name
            ds = durable(P, root)
            sft = P.parse_spec("t", WAL_SPEC)
            ds.create_schema(sft)
            ds.write("t", wal_batch(P, sft, ["a", "b"]))
            ds.checkpoint()
            auth = {"Authorization": "Bearer tok"}
            try:
                with served(P, ds, auth_token="tok") as srv:
                    rep = call(srv, "GET", "/rest/integrity")
                    gate = call(srv, "POST", "/rest/integrity/scrub", b"")[0]
                    flip_bit(os.path.join(checkpoint_dirs(str(root))[-1][1],
                                          "t.bin"))
                    scrub = call(srv, "POST", "/rest/integrity/scrub", b"",
                                 auth)
                    healed = call(srv, "GET", "/rest/integrity")
            finally:
                ds.close()
            assert rep[0] == 200 and jbody(rep)["ok"]
            assert not jbody(rep)["poisoned"] and gate == 403
            assert scrub[0] == 200 and not jbody(scrub)["ok"]
            assert len(jbody(scrub)["quarantined"]) == 1
            assert healed[0] == 200 and jbody(healed)["ok"]
            return [_rootless(steady(jbody(r)), str(root))
                    for r in (rep, scrub, healed)] + [gate]
        j, t = both(run)
        assert t == j


def _rootless(doc, root):
    """A report with its root path (each package's own directory) cut."""
    return json.loads(json.dumps(doc).replace(root, "<root>"))


# -- the scrubber on a journal (test_integrity.py TestScrubber) ---------------

def _scrub_seed(P, root):
    ds = durable(P, root)
    sft = P.parse_spec("t", WAL_SPEC)
    ds.create_schema(sft)
    ds.write("t", wal_batch(P, sft, [f"f{i}" for i in range(20)]))
    ds.checkpoint()
    ds.write("t", wal_batch(P, sft, [f"g{i}" for i in range(20)], seed=2))
    ds.checkpoint()
    return ds


def _flip_newest(P, root):
    newest = mod(P, "wal.snapshot").checkpoint_dirs(str(root))[-1][1]
    mod(P, "integrity").flip_bit(os.path.join(newest, "t.bin"))
    return newest


@needs_jax
class TestScrubber:
    def test_clean_root_scrubs_clean(self, tmp_path):
        def run(P):
            ds = _scrub_seed(P, tmp_path / P.name)
            try:
                scr = mod(P, "integrity").Scrubber(journal=ds.journal,
                                                   interval_s=999)
                out = scr.run_once()
                assert scr.status()["last_report"] is out and scr.runs == 1
            finally:
                ds.close()
            assert out["ok"] and out["quarantined"] == []
            assert out["wal"]["ok"] and len(out["checkpoints"]) == 2
            return _rootless(steady(out), str(tmp_path / P.name))
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("quarantine", [True, False])
    def test_corrupt_checkpoint(self, tmp_path, quarantine):
        def run(P):
            root = tmp_path / P.name
            ds = _scrub_seed(P, root)
            try:
                newest = _flip_newest(P, root)
                Scrubber = mod(P, "integrity").Scrubber
                out = Scrubber(journal=ds.journal, interval_s=999,
                               quarantine_corrupt=quarantine).run_once()
                again = Scrubber(journal=ds.journal, interval_s=999,
                                 quarantine_corrupt=quarantine).run_once()
                left = os.path.exists(newest)
                dirs = len(mod(P, "wal.snapshot").checkpoint_dirs(str(root)))
            finally:
                ds.close()
            assert not out["ok"]
            if quarantine:
                assert out["quarantined"] == [os.path.basename(newest)
                                              + ".corrupt"]
                assert not left and dirs == 1 and again["ok"]
            else:
                assert out["quarantined"] == [] and left and not again["ok"]
            return (_rootless(steady(out), str(root)),
                    _rootless(steady(again), str(root)), left, dirs)
        j, t = both(run)
        assert t == j

    def test_flags_unreferenced_and_tmp_debris(self, tmp_path):
        def run(P):
            root = tmp_path / P.name
            ds = _scrub_seed(P, root)
            try:
                newest = mod(P, "wal.snapshot").checkpoint_dirs(
                    str(root))[-1][1]
                with open(os.path.join(newest, "orphan.bin"), "wb") as fh:
                    fh.write(b"x")
                os.makedirs(os.path.join(str(root), "snapshots",
                                         "ckpt-00000000000000000099.tmp"))
                out = mod(P, "integrity").Scrubber(
                    journal=ds.journal, interval_s=999).run_once()
            finally:
                ds.close()
            assert out["ok"]
            assert any(u.endswith("orphan.bin") for u in out["unreferenced"])
            assert any(u.endswith(".tmp") for u in out["unreferenced"])
            return sorted(out["unreferenced"])
        j, t = both(run)
        assert t == j

    def test_never_renames_wal_segments(self, tmp_path):
        def run(P):
            root = str(tmp_path / P.name)
            ds = mod(P, "wal").DurableStore(P.store(), root, fsync="never",
                                            segment_bytes=256)
            sft = P.parse_spec("t", WAL_SPEC)
            ds.create_schema(sft)
            for i in range(30):
                ds.write("t", wal_batch(P, sft, [f"f{i}"], seed=i))
            segs = mod(P, "wal.log").list_segments(os.path.join(root, "log"))
            victim = segs[1][1]
            mod(P, "integrity").flip_bit(victim)
            try:
                out = mod(P, "integrity").Scrubber(
                    journal=ds.journal, interval_s=999).run_once()
            finally:
                ds.close()
            assert not out["ok"] and os.path.exists(victim)
            assert out["wal"]["corrupt_segments"] == [
                os.path.basename(victim)]
            assert out["quarantined"] == []
            return len(segs), out["wal"]["corrupt_segments"]
        j, t = both(run)
        assert t == j

    def test_background_loop_runs(self, tmp_path):
        def run(P):
            ds = _scrub_seed(P, tmp_path / P.name)
            scr = mod(P, "integrity").Scrubber(journal=ds.journal,
                                               interval_s=0.05).start()
            try:
                deadline = time.monotonic() + 5.0
                while scr.runs < 2 and time.monotonic() < deadline:
                    time.sleep(0.02)
                running = scr.status()["running"]
            finally:
                scr.stop()
                ds.close()
            return scr.runs >= 2, running, scr.status()["running"]
        assert both(run) == ((True, True, False),) * 2

    def test_status_and_knobs(self):
        def run(P):
            scrub = mod(P, "integrity.scrub")
            scr = scrub.Scrubber(journal=object())
            with pytest.raises(ValueError):
                scrub.Scrubber()
            return (scrub.SCRUB_INTERVAL_S.default,
                    scrub.INTEGRITY_QUARANTINE.default, scr.interval_s,
                    scr.quarantine_corrupt, scr.status())
        j, t = both(run)
        assert t == j


# -- the replicated and sharded tiers' admin routes ----------------------------
# (TestRestSurface of tests/test_cluster.py and tests/test_reshard.py)

TIER_SPEC = "*geom:Point:srid=4326,dtg:Date,name:String"
# per-leg latencies and breaker clocks differ run to run
TIER_VOLATILE = {"leg_latency", "read_latency", "p99_s", "hot_p99_s",
                 "sustained_s", "flip_ms", "cooldown_remaining_s",
                 "failover_seconds", "last_error", "last_decision"}


def tier_cluster(P, k=2, names=("east", "west"), down=False, n=600):
    """A cluster over k CPU groups holding the reshard suite's skewed
    rows (the last group replaced by a dead one when ``down``)."""
    cl = mod(P, "cluster")
    sft = P.parse_spec("pts", TIER_SPEC)
    rng = np.random.default_rng(3)
    n_hot = int(n * 0.7)
    x = np.concatenate([rng.uniform(100, 112, n_hot),
                        rng.uniform(-180, 180, n - n_hot)])
    y = np.concatenate([rng.uniform(40, 46, n_hot),
                        rng.uniform(-90, 90, n - n_hot)])
    batch = P.FeatureBatch.from_dict(
        sft, np.array([f"f{i}" for i in range(n)], dtype=object),
        {"geom": (x, y),
         "dtg": np.int64(1704067200000) + np.arange(n) * 3_600_000,
         "name": np.array([f"n{i % 7}" for i in range(n)], dtype=object)})
    groups = [P.store() for _ in range(k)]
    if down:
        groups[0].create_schema(sft)
        groups[0].write("pts", batch)
        groups[-1] = _DeadGroup()
        c = cl.ClusterDataStore(groups, names=list(names), leg_deadline_s=2,
                                hedge_ms=10, allow_partial=True)
        c._sfts["pts"] = sft
        return c
    c = cl.ClusterDataStore(groups, names=list(names))
    c.create_schema(sft)
    c.write("pts", batch)
    return c


class _DeadGroup:
    def close(self):
        pass

    def __getattr__(self, name):
        def boom(*a, **kw):
            raise ConnectionError("shard group down")
        return boom


def tier_reply(reply):
    """A reply with the tiers' latency fields left out of its JSON."""
    st, hdrs, body = reply
    if hdrs.get("Content-Type") == "application/json" and body:
        def drop(o):
            if isinstance(o, dict):
                return {k: drop(v) for k, v in o.items()
                        if k not in TIER_VOLATILE}
            if isinstance(o, list):
                return [drop(v) for v in o]
            return o
        body = json.dumps(drop(json.loads(body))).encode()
    return st, hdrs, body


def tier_session(P, store, requests, token=None):
    with served(P, store, **({"auth_token": token} if token else {})) \
            as srv:
        out = []
        for method, path, auth in requests:
            hdrs = {"Authorization": f"Bearer {token}"} if auth else None
            out.append(tier_reply(call(srv, method, path,
                                       b"" if method == "POST" else None,
                                       hdrs)))
        return out


CLUSTER_SESSION = [
    ("GET", "/rest/cluster", False),
    ("GET", "/rest/topology", False),
    ("GET", "/rest/topology?counts=false", False),
    ("GET", "/rest/reshard", False),
    ("POST", "/rest/cluster/promote?group=east", False),
    ("POST", "/rest/cluster/promote?group=east", True),
    ("POST", "/rest/cluster/promote?group=nope", True),
    ("POST", "/rest/reshard/split?src=east", False),
    ("GET", "/rest/query/pts?cql=INCLUDE&maxFeatures=2000", False),
    ("POST", "/rest/reshard/split", True),
    ("POST", "/rest/reshard/split?src=east", True),
    ("GET", "/rest/topology", False),
    ("GET", "/rest/reshard", False),
    ("GET", "/rest/cluster", False),
    ("GET", "/rest/query/pts?cql=BBOX(geom,100,40,112,46)&maxFeatures=2000",
     False),
    ("GET", "/rest/count/pts?cql=INCLUDE", False),
    ("POST", "/rest/reshard/resume", True),
    ("POST", "/rest/reshard/abort", True),
    ("POST", "/rest/reshard/nope", True),
    ("POST", "/rest/reshard/auto?state=on", True),
    ("POST", "/rest/reshard/auto?state=off", True),
]


@needs_jax
def test_cluster_admin_routes_equal_reference():
    """A session over a 2-group cluster on both servers: status,
    topology, the token gate, a split, the epoch header on queries,
    typed refusals (400, 409) and the autoscaler's loop (a single
    tick's decision reads leg latencies, so only its status is held)."""
    def run(P):
        c = tier_cluster(P)
        try:
            return tier_session(P, c, CLUSTER_SESSION + [
                ("POST", "/rest/reshard/auto", True)], token="s3cret")
        finally:
            c.close()
    j, t = both(run)
    assert t.pop()[0] == j.pop()[0] == 200
    assert len(t) == len(j) == len(CLUSTER_SESSION)
    for got, want in zip(t, j):
        same_reply(got, want)
    assert [r[0] for r in t[:12]] == [200, 200, 200, 200, 403, 400, 400,
                                      403, 200, 400, 200, 200]
    assert t[8][1].get("X-GeoMesa-Topology-Epoch") == "0"
    assert t[14][1].get("X-GeoMesa-Topology-Epoch") == "1"


@needs_jax
def test_reshard_refusal_maps_to_409():
    def run(P):
        c = tier_cluster(P, names=("a", "b"))
        knob = mod(P, "cluster.reshard").RESHARD_ENABLED
        knob.set("false")
        try:
            return tier_session(P, c, [
                ("POST", "/rest/reshard/split?src=a", False),
                ("GET", "/rest/reshard", False)])
        finally:
            knob.set(None)
            c.close()
    j, t = both(run)
    for got, want in zip(t, j):
        same_reply(got, want)
    assert t[0][0] == 409 and jbody(t[0])["retryable"] is False


@needs_jax
def test_partial_count_flagged_over_http():
    def run(P):
        c = tier_cluster(P, names=("up", "down"), down=True, n=100)
        return tier_session(P, c, [
            ("GET", "/rest/count/pts?cql=INCLUDE&maxFeatures=1000", False),
            ("GET", "/rest/query/pts?cql=INCLUDE&maxFeatures=1000", False),
            ("GET", "/rest/cluster", False)])
    j, t = both(run)
    for got, want in zip(t, j):
        same_reply(got, want)
    assert t[0][1].get("X-GeoMesa-Complete") == "false"
    assert "down" in t[0][1].get("X-GeoMesa-Missing-Groups", "")
    assert jbody(t[0])["count"] == 100


@needs_jax
def test_replication_admin_routes_equal_reference(tmp_path):
    """/rest/replication over a replicated store, then a bearer-gated
    promote: the same replies from both servers."""
    def run(P):
        repl = mod(P, "replication")
        sft = P.parse_spec("people", SPEC)
        primary = P.store(durable_dir=str(tmp_path / P.name),
                          wal_fsync="never")
        primary.create_schema(sft)
        ship = repl.WalShipper(primary.journal)
        kw = {} if P.name == "jax" else {"device": "cpu"}
        replica = repl.Replica(ship.host, ship.port, name="r0", **kw)
        router = repl.ReplicatedDataStore(primary, [replica],
                                          ack_replicas=1,
                                          auto_promote=False)
        rng = np.random.default_rng(5)
        try:
            router.write("people", make_batch(P, sft, 0, 50, rng))
            deadline = time.monotonic() + 10
            while (replica.applied_lsn < primary.journal.wal.last_lsn
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            return tier_session(P, router, [
                ("GET", "/rest/replication", False),
                ("POST", "/rest/replication/promote", False),
                ("GET", "/rest/count/people?cql=INCLUDE", False),
                ("POST", "/rest/replication/promote", True),
                ("GET", "/rest/replication", False),
                ("GET", "/rest/cluster", False),
                ("GET", "/rest/topology", False),
                ("GET", "/rest/reshard", False)], token="tok")
        finally:
            router.close()
            ship.stop()
    j, t = both(run)
    for got, want in zip(t, j):
        same_reply(got, want)
    assert [r[0] for r in t] == [200, 403, 200, 200, 200, 404, 404, 404]
    assert jbody(t[3])["promoted"] == "r0"


# -- TestCqRest (test_geofence.py) --------------------------------------------

CQ_SPEC = ("name:String,age:Integer,speed:Double,dtg:Date,"
           "*geom:Point:srid=4326")


def messy_batch(P, sft, n, seed=7):
    """The geofence suite's rows: NaN coordinates, null dates and null
    numbers sprinkled in."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[rng.random(n) < 0.05] = np.nan
    age = np.array([None if i % 29 == 0 else i % 100 for i in range(n)],
                   dtype=object)
    speed = rng.uniform(0, 300, n)
    speed[rng.random(n) < 0.05] = np.nan
    t0 = np.int64(1609459200000)
    millis = t0 + rng.integers(0, 300 * 86400000, n).astype(np.int64)
    dtg = np.array([None if i % 31 == 0 else int(m)
                    for i, m in enumerate(millis)], dtype=object)
    return P.FeatureBatch.from_dict(
        sft, [f"d{i}" for i in range(n)],
        {"name": [f"n{i % 7}" for i in range(n)], "age": age,
         "speed": speed, "dtg": dtg, "geom": (x, y)})


def cq_call(srv, method, path, token=None, body=None):
    data = (json.dumps(body).encode() if body is not None
            else (b"" if method == "POST" else None))
    hdrs = {"Authorization": f"Bearer {token}"} if token else {}
    st, _, raw = call(srv, method, path, data, hdrs)
    return st, json.loads(raw or b"null")


def live_store(P):
    live = mod(P, "store.live").LiveDataStore
    return live() if P.name == "jax" else live(device="cpu")


@needs_jax
class TestCqRest:
    def test_routes_gating_and_device_stats(self):
        def run(P):
            store = live_store(P)
            sft = P.parse_spec("pts", CQ_SPEC)
            store.create_schema(sft)
            out = []
            with served(P, store, auth_token="tok") as srv:
                out.append(cq_call(srv, "GET", "/rest/cq"))
                qs = urllib.parse.urlencode(
                    {"name": "young", "type": "pts", "ecql": "age < 10"})
                out.append(cq_call(srv, "POST", f"/rest/cq/register?{qs}"))
                out.append(cq_call(srv, "POST", f"/rest/cq/register?{qs}",
                                   token="tok"))
                out.append(cq_call(srv, "POST", f"/rest/cq/register?{qs}",
                                   token="tok"))
                box = {"name": "box", "type": "pts",
                       "ecql": "BBOX(geom, -10, -10, 10, 10)"}
                out.append(cq_call(srv, "POST", "/rest/cq/register",
                                   token="tok", body=box))
                store.write("pts", messy_batch(P, sft, 100))
                out.append(cq_call(srv, "GET", "/rest/cq"))
                out.append(cq_call(srv, "POST",
                                   "/rest/cq/unregister?name=young",
                                   token="tok"))
                out.append(cq_call(srv, "GET", "/rest/cq"))
            assert [o[0] for o in out] == [200, 403, 200, 409, 200, 200,
                                           200, 200]
            assert out[0][1] == {"queries": [], "device": []}
            assert out[2][1] == {"registered": "young", "type": "pts",
                                 "topic": "cq.young"}
            [dev] = out[5][1]["device"]
            assert dev["type_name"] == "pts" and dev["live"] == 2
            assert [x["name"] for x in out[7][1]["queries"]] == ["box"]
            return [(st, steady(b)) for st, b in out]
        j, t = both(run)
        assert t == j

    def test_bad_requests(self):
        def run(P):
            store = live_store(P)
            store.create_schema(P.parse_spec("pts", CQ_SPEC))
            with served(P, store, auth_token="tok") as srv:
                return [cq_call(srv, "POST", p, token="tok")[0] for p in (
                    "/rest/cq/register?name=x&type=pts&ecql=age+%3C%3C+3",
                    "/rest/cq/register?type=pts", "/rest/cq/register?name=x",
                )] + [cq_call(srv, "GET", "/rest/cq/nope")[0]]
        assert both(run) == ([400, 400, 400, 404],) * 2

    def test_busless_store_404s_on_mutation(self):
        def run(P):
            with served(P, P.store(), auth_token="tok") as srv:
                st, body = cq_call(srv, "POST",
                                   "/rest/cq/register?name=x&type=t",
                                   token="tok")
                assert st == 404 and "bus" in body["error"]
                return (st, body), cq_call(srv, "GET", "/rest/cq")
        j, t = both(run)
        assert t == j


# -- TestWebKnnRoute (test_batched_knn.py) ------------------------------------

@needs_jax
def test_rest_knn_exact_and_param_errors():
    rng = np.random.default_rng(6)
    n = 5_000
    px, py = rng.uniform(-50, 50, n), rng.uniform(-50, 50, n)

    def run(P):
        ds = P.store()
        ds.create_schema(P.parse_spec("pts", "*geom:Point:srid=4326"))
        ds.write_dict("pts", np.arange(n).astype(str).astype(object),
                      {"geom": (px, py)})
        with served(P, ds) as srv:
            d = jbody(call(srv, "GET", "/rest/knn/pts?x=10.0&y=10.0&k=7"))
            bad = call(srv, "GET", "/rest/knn/pts?x=nope")[0]
        d2 = (px - 10.0) ** 2 + (py - 10.0) ** 2
        want = np.lexsort((np.arange(n), d2))[:7]
        assert [int(i) for i in d["ids"]] == list(want)
        assert d["distances"] == sorted(d["distances"]) and bad == 400
        return d, bad
    j, t = both(run)
    assert t == j


# -- TestWebStreaming (test_streaming.py) -------------------------------------

def stream_store(P, n=1000):
    rng = np.random.default_rng(9)
    sft = P.parse_spec("pts", SPEC)
    ds = P.store()
    ds.create_schema(sft)
    ds.write("pts", P.FeatureBatch.from_dict(
        sft, [f"f{i}" for i in range(n)],
        {"name": [f"n{i % 11}" for i in range(n)], "age": np.arange(n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}))
    return ds


@needs_jax
class TestWebStreaming:
    def test_arrow_stream_is_chunked_and_decodes(self):
        def run(P):
            delta = mod(P, "arrow.delta")
            with served(P, stream_store(P)) as srv:
                st, hdrs, body = call(
                    srv, "GET", "/rest/query/pts?format=arrow-stream"
                                "&batchRows=128")
            assert st == 200 and hdrs["Transfer-Encoding"] == "chunked"
            assert hdrs["Content-Type"].startswith(delta.ARROW_STREAM_MIME)
            _, it = delta.iter_ipc(io.BytesIO(body))
            pieces = [p.n for p in it]
            assert sum(pieces) == 1000 and max(pieces) <= 128
            return body, pieces
        j, t = both(run)
        assert t == j

    def test_bin_stream_decodes(self):
        def run(P):
            decode = mod(P, "scan.aggregations").decode_bin_records
            with served(P, stream_store(P)) as srv:
                st, hdrs, data = call(srv, "GET",
                                      "/rest/query/pts?format=bin")
            assert st == 200 and hdrs["Transfer-Encoding"] == "chunked"
            assert len(data) % 16 == 0 and len(decode(data)) == 1000
            return data
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("cql,status", [("no such (", 400),
                                            ("age > 9999", 200)])
    def test_bad_cql_and_empty_result(self, cql, status):
        def run(P):
            delta = mod(P, "arrow.delta")
            with served(P, stream_store(P)) as srv:
                st, hdrs, body = call(
                    srv, "GET", "/rest/query/pts?format=arrow-stream"
                                f"&cql={q(cql)}")
            assert st == status
            if st == 200:
                sft, it = delta.iter_ipc(io.BytesIO(body))
                assert list(it) == [] and sft.type_name == "pts"
            return st, body if st == 200 else None
        j, t = both(run)
        assert t == j

    def test_disconnect_mid_stream_releases_the_slot(self):
        """A client that hangs up mid-stream releases the server's
        in-flight slot and its tenant's count (the slot guard's
        finally runs when the handler closes the generator)."""
        def run(P):
            qos = mod(P, "tenants")
            qos.QOS_ENABLED.set("true")
            qos.WEB_AUTH_TOKENS.set("a-tok:alpha")
            try:
                with served(P, stream_store(P, n=20_000),
                            max_inflight=4) as srv:
                    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                      timeout=30)
                    conn.request("GET", "/rest/query/pts?format=arrow-stream"
                                        "&batchRows=64",
                                 headers={"Authorization": "Bearer a-tok"})
                    resp = conn.getresponse()
                    resp.read(256)
                    conn.sock.shutdown(2)
                    conn.close()
                    deadline = time.monotonic() + 10.0
                    while (srv._inflight or qos.tenant_registry.status()[
                            "tenants"]["alpha"]["inflight"]) \
                            and time.monotonic() < deadline:
                        time.sleep(0.01)
                    return (srv._inflight, qos.tenant_registry.status()[
                        "tenants"]["alpha"]["inflight"],
                        call(srv, "GET", "/rest/ready")[0])
            finally:
                qos.QOS_ENABLED.set(None)
                qos.WEB_AUTH_TOKENS.set(None)
        assert both(run) == ((0, 0, 200),) * 2


# -- TestWebBackpressure (test_ingest.py) -------------------------------------

ING_SPEC = "name:String,speed:Double,dtg:Date,*geom:Point:srid=4326"


def ing_batch(P, n, start=0):
    sft = P.parse_spec("boats", ING_SPEC)
    rng = np.random.default_rng(start + 1)
    return P.FeatureBatch.from_dict(
        sft, [f"b{i}" for i in range(start, start + n)],
        {"name": [f"v{i % 9}" for i in range(n)],
         "speed": rng.uniform(0, 30, n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(-80, -60, n), rng.uniform(30, 45, n))})


def arrow_body(batch):
    import pyarrow as pa
    table = pa.Table.from_batches([batch.to_arrow()])
    sink = io.BytesIO()
    with pa.ipc.new_file(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


@needs_jax
class TestWebBackpressure:
    def test_write_429_with_retry_after_when_bucket_full(self):
        def run(P):
            ds = P.store()
            ds.create_schema("boats", ING_SPEC)
            srv = P.Server(ds).start()
            release = threading.Event()
            real = ds.write_many

            def slow_write_many(type_name, items):
                release.wait(timeout=10.0)
                return real(type_name, items)
            ds.write_many = slow_write_many
            srv._ingest_pipeline = mod(P, "ingest").IngestPipeline(
                ds, max_inflight_rows=64)
            try:
                release.set()
                r1 = srv.handle("POST", "/rest/write/boats", {},
                                arrow_body(ing_batch(P, 64)), {})
                release.clear()
                ack = srv._ingest_pipeline.write(
                    "boats", ing_batch(P, 64, start=128), block=True)
                r2 = srv.handle("POST", "/rest/write/boats", {},
                                arrow_body(ing_batch(P, 64, start=64)), {})
                release.set()
                ack.wait(timeout=10.0)
            finally:
                release.set()
                srv._ingest_pipeline.close()
                srv.stop()
            assert r1[0] == 200 and r2[0] == 429 and r2[3]["Retry-After"]
            return r1[:3], r2[0], json.loads(r2[2]), ds.count("boats")
        j, t = both(run)
        assert t == j

    def test_write_committed_before_200_and_health_detail(self):
        def run(P):
            ds = P.store()
            ds.create_schema("boats", ING_SPEC)
            srv = P.Server(ds).start()
            try:
                out = srv.handle("POST", "/rest/write/boats", {},
                                 arrow_body(ing_batch(P, 50)), {})
                n = ds.count("boats")
                detail = json.loads(srv.handle(
                    "GET", "/rest/health", {}, b"", {})[2])["ingest"]
            finally:
                srv.stop()
            assert out[0] == 200 and json.loads(out[2])["written"] == 50
            assert n == 50 and detail["inflight_rows"] == 0
            # the group cap follows the measured write cost: not compared
            assert detail.pop("group_cap_rows") >= 1
            return json.loads(out[2]), n, detail
        j, t = both(run)
        assert t == j

    def test_pipeline_off_writes_direct(self):
        def run(P):
            knob = mod(P, "web.server").WEB_INGEST_PIPELINE
            ds = P.store()
            ds.create_schema("boats", ING_SPEC)
            srv = P.Server(ds).start()
            knob.set("false")
            try:
                out = srv.handle("POST", "/rest/write/boats", {},
                                 arrow_body(ing_batch(P, 30)), {})
            finally:
                knob.set(None)
                srv.stop()
            return out[0], json.loads(out[2]), srv._ingest_pipeline
        assert both(run) == ((200, {"written": 30, "lsn": None}, None),) * 2


# -- TestHealthEndpoints (test_health.py) -------------------------------------

@needs_jax
class TestHealthEndpoints:
    def test_rest_runtime_slo_profile(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                rt = srv.handle("GET", "/rest/runtime", {}, None)[:3]
                srv.handle("GET", "/rest/schemas", {}, None)
                slo = json.loads(srv.handle("GET", "/rest/slo", {}, None)[2])
                prof = srv.handle("GET", "/rest/profile", {}, None)[:3]
                pj = json.loads(srv.handle("GET", "/rest/profile",
                                           {"format": ["json"]}, None)[2])
            doc = json.loads(rt[2])
            assert rt[0] == 200 and rt[1] == "application/json"
            for key in ("enabled", "compile", "dispatch", "transfer",
                        "device_memory"):
                assert key in doc
            assert slo["enabled"] is True
            assert slo["objectives"]["availability_target"] == 0.999
            assert slo["windows"]["fast"] == [300.0, 3600.0, 14.4]
            assert slo["routes"]["schemas"]["alert"] == "ok"
            assert prof[0] == 200 and prof[1] == "text/plain"
            assert isinstance(prof[2], str)
            assert pj["profiler"]["running"] is True and "watchdog" in pj
            return (sorted(doc), slo["objectives"], slo["windows"],
                    sorted(slo["routes"]), slo["routes"]["schemas"]["alert"],
                    sorted(pj))
        j, t = both(run)
        assert t == j

    def test_server_lifecycle_owns_profiler_ref(self):
        def run(P):
            before = P.obs.profiler._refs
            srv = P.Server(seeded_store(P)).start()
            during = P.obs.profiler._refs - before
            srv.stop()
            return during, P.obs.profiler._refs - before
        assert both(run) == ((1, 0), (1, 0))

    def test_remote_client_health_methods(self):
        def run(P):
            with served(P, seeded_store(P)) as srv:
                client = P.Remote("127.0.0.1", srv.port, hedge=False)
                return ("transfer" in client.runtime_snapshot(),
                        client.slo_status()["enabled"],
                        isinstance(client.profile_collapsed(), str),
                        client.qos_status(), client.probe_health())
        j, t = both(run)
        assert t == j and t[:3] == (True, True, True) and t[4] is True

    def test_shed_503_counts_against_route_slo(self):
        def run(P):
            hold = threading.Event()
            base = type(P.store())

            class Holder(base):
                def get_type_names(self):
                    assert hold.wait(30.0)
                    return super().get_type_names()
            store = Holder() if P.name == "jax" else Holder(device="cpu")
            srv = P.Server(store, max_inflight=1).start()
            t = threading.Thread(
                target=lambda: srv.handle("GET", "/rest/schemas", {}, None),
                daemon=True)
            t.start()
            try:
                deadline = time.monotonic() + 10.0
                while srv._inflight < 1 and time.monotonic() < deadline:
                    time.sleep(0.005)
                status = srv.handle("GET", "/rest/schemas", {}, None)[0]
            finally:
                hold.set()
                t.join(10.0)
                srv.stop()
            return status, "schemas" in P.obs.slo_engine.evaluate()
        assert both(run) == ((503, True),) * 2


# -- TestWebTenantGate (test_qos.py) ------------------------------------------

@contextlib.contextmanager
def qos_server(P):
    qos = mod(P, "tenants")
    cap = P.Property("geomesa.qos.tenant.blocked.max.inflight")
    qos.QOS_ENABLED.set("true")
    qos.tenant_registry.reset()
    qos.WEB_AUTH_TOKENS.set("a-tok:alpha,b-tok:beta,z-tok:blocked")
    cap.set("0")
    try:
        with served(P, seeded_store(P)) as srv:
            yield srv
    finally:
        cap.set(None)
        qos.QOS_ENABLED.set(None)
        qos.WEB_AUTH_TOKENS.set(None)
        qos.tenant_registry.reset()


def tok(t):
    return {"Authorization": f"Bearer {t}"}


@needs_jax
class TestWebTenantGate:
    def test_capped_tenant_sheds_others_proceed(self):
        def run(P):
            with qos_server(P) as srv:
                shed = call(srv, "GET", "/rest/schemas", None, tok("z-tok"))
                ok = call(srv, "GET", "/rest/schemas", None, tok("a-tok"))
                qs = mod(P, "tenants").tenant_registry.status()["tenants"]
            d = jbody(shed)
            assert shed[0] == 503 and d["retryable"] is True
            assert d["tenant"] == "blocked"
            assert float(shed[1]["Retry-After"]) > 0
            assert ok[0] == 200 and jbody(ok) == ["people"]
            assert qs["blocked"]["sheds"] >= 1 and qs["alpha"]["sheds"] == 0
            assert qs["alpha"]["inflight"] == 0
            return d, jbody(ok), steady(qs)
        j, t = both(run)
        assert t == j

    def test_retry_after_is_jittered(self):
        def run(P):
            values = set()
            with qos_server(P) as srv:
                for _ in range(4):
                    st, hdrs, _ = call(srv, "GET", "/rest/schemas", None,
                                       tok("z-tok"))
                    assert st == 503 and 0 < float(hdrs["Retry-After"]) <= 1.5
                    values.add(hdrs["Retry-After"])
            return len(values) > 1
        assert both(run) == (True, True)

    def test_rest_qos_and_health_documents(self):
        def run(P):
            with qos_server(P) as srv:
                call(srv, "GET", "/rest/schemas", None, tok("a-tok"))
                doc = jbody(call(srv, "GET", "/rest/qos"))
                health = jbody(call(srv, "GET", "/rest/health"))["qos"]
            a = doc["tenants"]["alpha"]
            assert doc["enabled"] is True
            assert a["inflight"] == 0 and a["weight"] == 1.0
            assert health["enabled"] is True
            return steady(doc), steady(health)
        j, t = both(run)
        assert t == j

    def test_kill_switch_off_no_gate_no_detail(self):
        def run(P):
            qos = mod(P, "tenants")
            cap = P.Property("geomesa.qos.tenant.blocked.max.inflight")
            qos.QOS_ENABLED.set("false")
            cap.set("0")
            try:
                with served(P, seeded_store(P)) as srv:
                    return (call(srv, "GET", "/rest/schemas", None,
                                 tok("z-tok"))[0],
                            jbody(call(srv, "GET", "/rest/qos")),
                            jbody(call(srv, "GET", "/rest/health"))["qos"])
            finally:
                qos.QOS_ENABLED.set(None)
                cap.set(None)
        assert both(run) == ((200, {"enabled": False, "tenants": {}},
                              None),) * 2


# -- TestWebTracing (test_obs.py) ---------------------------------------------

OBS_SPEC = "*geom:Point:srid=4326,dtg:Date,name:String"


def obs_store(P, audit=None):
    rng = np.random.default_rng(11)
    n = 200
    sft = P.parse_spec("pts", OBS_SPEC)
    ds = P.store(audit=audit)
    ds.create_schema(sft)
    ds.write("pts", P.FeatureBatch.from_dict(
        sft, np.array([f"f{i}" for i in range(n)], dtype=object),
        {"geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)),
         "dtg": rng.integers(0, 10**12, n).astype(np.int64),
         "name": np.array([f"n{i % 5}" for i in range(n)], dtype=object)}))
    return ds


@contextlib.contextmanager
def tracing(P, sample):
    trace = mod(P, "obs.trace")
    trace.TRACE_SAMPLE.set(sample)
    if sample == "0":
        trace.TRACE_SLOW_MS.set("0")
    P.obs.tracer.clear()
    log = mod(P, "audit").AuditLogger()
    try:
        with served(P, obs_store(P, audit=log)) as srv:
            yield srv, log
    finally:
        trace.TRACE_SAMPLE.set(None)
        trace.TRACE_SLOW_MS.set(None)
        P.obs.tracer.clear()


@needs_jax
class TestWebTracing:
    def test_remote_query_builds_full_trace(self):
        def run(P):
            with tracing(P, "1.0") as (srv, log):
                client = P.Remote("127.0.0.1", srv.port, hedge=False)
                with P.obs.tracer.span("client", "e2e", root=True) as root:
                    res = client.query(P.Query(
                        "pts", "BBOX(geom, -90, -60, 90, 60)"))
                spans = P.obs.tracer.get(root.trace_id)
                (e,) = log.query()
            kinds = {d["kind"] for d in spans}
            assert {"client", "remote", "web", "batcher-wait", "dispatch",
                    "store-scan"} <= kinds
            assert all(d["trace_id"] == root.trace_id for d in spans)
            assert e.trace_id == root.trace_id and e.hits == res.n
            return sorted(kinds), res.n
        j, t = both(run)
        assert t == j

    def test_rest_trace_list_get_and_unknown(self):
        def run(P):
            with tracing(P, "1.0") as (srv, _):
                a = srv.handle("GET", "/rest/query/pts",
                               {"cql": ["BBOX(geom, -10, -10, 10, 10)"]}, None)
                summaries = json.loads(srv.handle("GET", "/rest/trace",
                                                  {}, None)[2])
                tid = summaries[0]["trace_id"]
                full = json.loads(srv.handle("GET", f"/rest/trace/{tid}",
                                             {}, None)[2])
                unknown = srv.handle("GET", "/rest/trace/deadbeef",
                                     {}, None)[0]
            assert a[0] == 200 and full["trace_id"] == tid
            assert {"kind", "span_id", "duration_ms"} <= set(full["spans"][0])
            return (steady(summaries), sorted(s["kind"] for s in
                                              full["spans"]), unknown)
        j, t = both(run)
        assert t == j and t[2] == 404

    def test_rest_metrics_prometheus_parses(self):
        def run(P):
            with tracing(P, "0") as (srv, _):
                srv.handle("GET", "/rest/query/pts", {"cql": ["INCLUDE"]},
                           None)
                st, ctype, body = srv.handle(
                    "GET", "/rest/metrics", {"format": ["prometheus"]},
                    None)[:3]
                d = srv.handle("GET", "/rest/metrics", {}, None)[1]
            assert st == 200 and ctype.startswith("text/plain")
            for ln in body.splitlines():
                assert ln.startswith("#") or " " in ln, ln
            return ctype, d, "geomesa_web_request" in body
        j, t = both(run)
        assert t == j

    def test_bearer_principal_lands_in_audit(self):
        def run(P):
            with tracing(P, "0") as (srv, log):
                out = srv.handle("GET", "/rest/query/pts",
                                 {"cql": ["INCLUDE"]}, None,
                                 {"Authorization": "Bearer s3cret"})
                e = log.query()[-1]
            assert out[0] == 200 and e.user.startswith("bearer:")
            assert "s3cret" not in e.user
            return e.user
        j, t = both(run)
        assert t == j

    def test_trace_header_continues_wire_trace(self):
        def run(P):
            hdr = "feedface00000001:cafe000000000002:1"
            with tracing(P, "1.0") as (srv, _):
                out = srv.handle("GET", "/rest/query/pts",
                                 {"cql": ["INCLUDE"]}, None,
                                 {P.obs.TRACE_HEADER: hdr})
                spans = P.obs.tracer.get("feedface00000001")
            web = [d for d in spans if d["kind"] == "web"]
            assert out[0] == 200 and web[0]["parent_id"] == \
                "cafe000000000002"
            return web[0]["parent_id"], web[0]["name"]
        j, t = both(run)
        assert t == j


# -- the request thread's CUDA device, pyarrow's first load -------------------

def test_server_loads_arrow_on_its_own_thread():
    """A fresh process: the server loads pyarrow where it is built, so a
    request thread never loads it first (pyarrow's allocator, loaded
    inside a short-lived request thread, can crash the process on that
    thread's first arrays); the first Arrow query then answers."""
    import subprocess
    import sys
    code = (
        "import sys, numpy as np\n"
        "from geomesa_tpu_torch.store import InMemoryDataStore, "
        "RemoteDataStore\n"
        "from geomesa_tpu_torch.web import GeoMesaWebServer\n"
        "ds = InMemoryDataStore(device='cpu')\n"
        "ds.create_schema('t', 'dtg:Date,*geom:Point')\n"
        "n = 50_000\n"
        "rng = np.random.default_rng(1)\n"
        "ds.write_dict('t', np.arange(n).astype(str).astype(object), "
        "{'dtg': rng.integers(0, 10**12, n), "
        "'geom': (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})\n"
        "assert 'pyarrow' not in sys.modules\n"
        "srv = GeoMesaWebServer(ds).start()\n"
        "assert 'pyarrow' in sys.modules\n"
        "c = RemoteDataStore('127.0.0.1', srv.port, hedge=False)\n"
        "print(c.query('BBOX(geom, -10, -10, 10, 10)', 't').n == "
        "ds.query('BBOX(geom, -10, -10, 10, 10)', 't').n)\n"
        "srv.stop()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"


def test_device_scope_is_a_noop_on_the_host():
    with served(T, seeded_store(T)) as srv:
        assert srv._cuda_index is None
        with srv._device_scope():
            pass


# -- on the card (no JAX) -----------------------------------------------------

def _cuda_store(n=200_000, seed=3):
    rng = np.random.default_rng(seed)
    ds = T.Store()
    ds.create_schema(T.parse_spec("pts", "dtg:Date,*geom:Point:srid=4326"))
    ds.write_dict("pts", np.arange(n).astype(str).astype(object),
                  {"dtg": rng.integers(0, 10**12, n).astype(np.int64),
                   "geom": (rng.uniform(-180, 180, n),
                            rng.uniform(-90, 90, n))})
    return ds


@pytest.mark.gpu
def test_cuda_server_answers_as_direct_calls():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from geomesa_tpu_torch.analytics.processes import knn_process
    from geomesa_tpu_torch.cache import CACHE_ENABLED
    from geomesa_tpu_torch.scan import kernels
    ds = _cuda_store()
    assert ds.device.type == "cuda"
    ecql = "BBOX(geom, -20, -10, 25, 30)"
    host_rows = T.Property("geomesa.scan.host.rows")
    points = [(1.5 * i - 5.0, 2.5 - i) for i in range(8)]
    e0 = T.metrics.snapshot()["counters"].get("resilience.web.errors", 0)
    with served(T, ds) as srv:
        assert srv._cuda_index == torch.cuda.current_device()
        client = T.Remote("127.0.0.1", srv.port, hedge=False)
        CACHE_ENABLED.set("false")
        host_rows.set("0")          # the gathered tier, not the host's
        try:
            kernels.reset_launches()
            got = client.query(ecql, "pts")
            scans = (kernels.launches["scan_mask"]
                     + kernels.launches["scan_mask_gather"])
            grid = client.density("pts", ecql, (-20, -10, 25, 30), 64, 64)
            dens = kernels.launches["density_grid"]
            knn = _knn_burst(srv, points, 25)
            knns = kernels.launches["knn_topk"]
        finally:
            CACHE_ENABLED.set(None)
            host_rows.set(None)
        errors = T.metrics.snapshot()["counters"].get(
            "resilience.web.errors", 0) - e0
    want = ds.query(ecql, "pts")
    assert sorted(got.ids) == sorted(want.ids) and got.n == want.n
    assert np.array_equal(grid, np.asarray(
        ds.density("pts", ecql, (-20, -10, 25, 30), 64, 64)))
    for (qx, qy), reply in zip(points, knn):
        ids, dist = knn_process(ds, "pts", qx, qy, 25)
        assert reply["ids"] == [str(i) for i in ids]
        assert reply["distances"] == np.asarray(dist, np.float64).tolist()
    assert scans > 0 and dens > 0 and knns > 0 and errors == 0


def _knn_burst(srv, points, k):
    """``points`` as concurrent /rest/knn requests that the server's
    batcher fuses into one batched top-k: its in-flight count is held up
    (as if a dispatch were running) and its linger is static and long,
    so the leader waits until all of them have arrived."""
    b = srv.batcher
    replies = [None] * len(points)

    def one(i):
        qx, qy = points[i]
        replies[i] = jbody(call(srv, "GET",
                                f"/rest/knn/pts?x={qx}&y={qy}&k={k}"))
    with b._cond:
        b._in_flight += 1
    saved = (b.max_batch, b.adaptive, b._linger_override)
    b.max_batch, b.adaptive, b._linger_override = len(points), False, 5e6
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(points))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        b.max_batch, b.adaptive, b._linger_override = saved
        with b._cond:
            b._in_flight -= 1
    return replies
