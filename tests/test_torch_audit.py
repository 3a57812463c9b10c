"""The port's audit plane against the JAX package's on the CPU: the
``AuditLogger`` (whole JSONL lines under concurrent writers, the bounded
ring, its filters), the unified hook (trace, principal, flag and tenant
enrichment, delegation suppression, the global fallback logger and its
path), and the store's records for ``query``, ``query_count`` and
``query_batched``.

Tolerance: exact. Events from the same seeded writes and queries equal
the JAX store's in every field but the times (``date_ms``,
``plan_time_ms``, ``scan_time_ms``) and the random trace ids, whose
presence is compared instead."""

import dataclasses
import json
import threading
import types

import numpy as np
import pytest

import geomesa_tpu.audit as j_audit
import geomesa_tpu.audit.hook as j_hook
import geomesa_tpu.obs as j_obs
import geomesa_tpu.tenants as j_tenants
from geomesa_tpu.features import parse_spec as j_parse_spec
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.store.memory import InMemoryDataStore as JStore
import geomesa_tpu_torch.audit as t_audit
import geomesa_tpu_torch.audit.hook as t_hook
import geomesa_tpu_torch.obs as t_obs
import geomesa_tpu_torch.tenants as t_tenants
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.index.api import Query as TQuery
from geomesa_tpu_torch.store.memory import InMemoryDataStore as TStore

J = types.SimpleNamespace(name="jax", audit=j_audit, hook=j_hook, obs=j_obs,
                          tenants=j_tenants, parse_spec=j_parse_spec,
                          Query=JQuery, store=lambda **kw: JStore(**kw))
T = types.SimpleNamespace(name="torch", audit=t_audit, hook=t_hook, obs=t_obs,
                          tenants=t_tenants, parse_spec=t_parse_spec,
                          Query=TQuery,
                          store=lambda **kw: TStore(device="cpu", **kw))
PKGS = (J, T)

SPEC = "*geom:Point:srid=4326,dtg:Date,name:String:index=true"
_TIMES = ("date_ms", "plan_time_ms", "scan_time_ms", "trace_id")


def both(fn):
    return fn(J), fn(T)


@pytest.fixture(autouse=True)
def _hygiene():
    for P in PKGS:
        P.obs.tracer.clear()
        P.hook._reset_global()
    yield
    for P in PKGS:
        P.obs.trace.TRACE_SAMPLE.set(None)
        P.tenants.QOS_ENABLED.set(None)
        P.hook.AUDIT_PATH.set(None)
        P.hook._reset_global()
        P.obs.tracer.clear()


def _fields(e):
    d = dataclasses.asdict(e)
    d["trace_id"] = d["trace_id"] is not None
    for k in _TIMES[:3]:
        assert d.pop(k) >= 0
    return d


def seeded_store(P, n=300, **kw):
    rng = np.random.default_rng(17)
    ds = P.store(**kw)
    ds.create_schema(P.parse_spec("pts", SPEC))
    ds.write_dict("pts", [f"f{i}" for i in range(n)], {
        "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)),
        "dtg": rng.integers(0, 10**12, n),
        "name": [f"n{i % 5}" for i in range(n)]})
    return ds


# -- the logger ---------------------------------------------------------------

def test_concurrent_writers_whole_lines(tmp_path):
    path = tmp_path / "audit.jsonl"
    log = t_audit.AuditLogger(path=str(path))
    n_threads, per = 8, 200
    barrier = threading.Barrier(n_threads)

    def worker(t):
        barrier.wait(10.0)
        for i in range(per):
            log.record(f"type{t}", "INCLUDE", {}, 0.1, 0.2, i, user=f"u{t}")
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert len(log.query()) == n_threads * per
    lines = path.read_text().splitlines()
    assert len(lines) == n_threads * per
    for ln in lines:
        assert json.loads(ln)["type_name"].startswith("type")


@pytest.mark.parametrize("capacity,n", [(10, 25), (5, 12), (100, 3)])
def test_ring_bounded_equal_reference(capacity, n):
    def run(P):
        log = P.audit.AuditLogger(capacity=capacity)
        for i in range(n):
            log.record("t" if i % 2 else "u", f"f{i}", {}, 1.0, 2.0, i)
        return ([_fields(e) for e in log.events],
                [e.hits for e in log.query("t")],
                len(log.query(since_ms=0)))
    want, got = both(run)
    assert got == want
    assert len(got[0]) == min(capacity, n)


def test_event_json_equals_reference():
    def run(P):
        e = P.audit.QueryEvent("t", "u", "INCLUDE", {"k": 1}, 123, 1.5, 2.5,
                               7, trace_id="abc", surface="memory",
                               index="z3", rows_scanned=9, batched=True,
                               tenant="tt")
        return e.to_json()
    want, got = both(run)
    assert got == want


# -- the hook -----------------------------------------------------------------

def test_enriched_event_fields_equal_reference():
    def run(P):
        P.obs.trace.TRACE_SAMPLE.set("1.0")
        log = P.audit.AuditLogger()
        with P.obs.tracer.span("web", "t", root=True):
            P.obs.set_flag("cache_hit")
            P.obs.set_flag("hedged")
            ok = P.audit.audit_query(log, "memory", "pts", "INCLUDE", {},
                                     1.0, 2.0, 42, index="z2",
                                     rows_scanned=100)
        (e,) = log.query()
        assert P.obs.tracer.get(e.trace_id) is not None
        return ok, _fields(e)
    want, got = both(run)
    assert got == want
    assert got[1]["cache_hit"] and got[1]["hedged"] and got[1]["trace_id"]


def test_delegation_and_principal_equal_reference():
    def run(P):
        log = P.audit.AuditLogger()
        with P.audit.delegated_scope():
            suppressed = P.audit.audit_query(log, "memory", "pts",
                                             "INCLUDE", {}, 0, 0, 1)
        with P.audit.principal_scope("bearer:abc123"):
            assert P.audit.current_principal() == "bearer:abc123"
            P.audit.audit_query(log, "memory", "pts", "INCLUDE", {}, 0, 0, 1)
        P.audit.audit_query(log, "memory", "pts", "INCLUDE", {}, 0, 0, 2,
                            user="explicit")
        return suppressed, [_fields(e) for e in log.query()]
    want, got = both(run)
    assert got == want
    assert got[0] is False
    assert [e["user"] for e in got[1]] == ["bearer:abc123", "explicit"]


def test_global_fallback_honors_audit_path(tmp_path):
    def run(P):
        path = tmp_path / f"{P.name}.jsonl"
        P.hook.AUDIT_PATH.set(str(path))
        P.hook._reset_global()
        P.audit.audit_query(None, "remote", "pts", "INCLUDE", {}, 0, 0, 3)
        assert len(P.audit.global_audit().query()) == 1
        e = json.loads(path.read_text().splitlines()[0])
        for k in _TIMES:
            e.pop(k)
        return e
    want, got = both(run)
    assert got == want
    assert got["surface"] == "remote" and got["hits"] == 3


# -- the store's records ------------------------------------------------------

STORE_QUERIES = {
    "query": lambda P, ds: [ds.query(P.Query(
        "pts", "BBOX(geom, -50, -40, 50, 40)"))],
    "query_attr": lambda P, ds: [ds.query(P.Query(
        "pts", "name = 'n2'", properties=["name"], max_features=7))],
    "query_empty_plan": lambda P, ds: [ds.query(P.Query(
        "pts", "BBOX(geom, 0, 0, 1, 1) AND BBOX(geom, 5, 5, 6, 6)"))],
    "query_count": lambda P, ds: [ds.query_count(P.Query(
        "pts", "BBOX(geom, -50, -40, 50, 40) AND name = 'n1'",
        max_features=3))],
    "query_batched": lambda P, ds: ds.query_batched([
        P.Query("pts", "BBOX(geom, -50, -40, 50, 40)"),
        P.Query("pts", "BBOX(geom, 0, 0, 60, 50)"),
        P.Query("pts", "name = 'n2'")]),
    "empty_type": lambda P, ds: [ds.query(P.Query("none", "INCLUDE"))],
}


@pytest.mark.parametrize("qos", [False, True])
@pytest.mark.parametrize("entry", sorted(STORE_QUERIES))
def test_store_audit_events_equal_reference(entry, qos):
    """One record per query with the JAX store's fields: surface,
    index, hits (the result's count), rows scanned, batched on fused
    queries, the principal and, with QoS on, the tenant; nothing for a
    type without rows."""
    def run(P):
        if qos:
            P.tenants.QOS_ENABLED.set("true")
        log = P.audit.AuditLogger()
        ds = seeded_store(P, audit=log)
        ds.create_schema(P.parse_spec("none", SPEC))
        with P.audit.principal_scope("svc"), \
                P.tenants.tenant_scope("acme"):
            out = STORE_QUERIES[entry](P, ds)
        hits = [r if isinstance(r, int) else r.n for r in out]
        return [_fields(e) for e in log.query()], hits
    want, got = both(run)
    assert got == want
    events, hits = got
    if entry == "empty_type":
        assert events == []
        return
    assert sorted(e["hits"] for e in events) == sorted(hits)
    for e in events:
        assert e["user"] == "svc" and e["surface"] == "memory"
        assert e["rows_scanned"] == 300
        assert e["tenant"] == ("acme" if qos else None)
    if entry == "query_batched":
        assert [e["batched"] for e in events].count(True) == 2


def test_store_without_logger_feeds_the_global_one():
    def run(P):
        ds = seeded_store(P)
        ds.query(P.Query("pts", "BBOX(geom, -1, -1, 1, 1)"))
        ds.query(P.Query("pts", "name = 'n1'"))
        return [_fields(e) for e in P.audit.global_audit().query("pts")]
    want, got = both(run)
    assert got == want and len(got) == 2


def test_audit_records_queries():
    """The JAX surfaces suite's audit case on the port's store."""
    ds = TStore(device="cpu", audit=t_audit.AuditLogger())
    ds.create_schema("a", "v:Integer,*geom:Point")
    ds.write_dict("a", ["x"], {"v": [1], "geom": ([0.0], [0.0])})
    ds.query("BBOX(geom, -1, -1, 1, 1)", "a")
    ds.query("v = 1", "a")
    events = ds.audit.query("a")
    assert len(events) == 2
    assert events[0].hits == 1 and "BBOX" in events[0].filter
    assert events[0].scan_time_ms >= 0


def test_fused_queries_audited_under_their_callers():
    """A departure by design: the batcher's leader runs its followers'
    queries, and the port writes each record in its caller's context
    (principal, tenant); the JAX batcher writes every record of the
    dispatch under the leader's. The records' other fields are equal."""
    import geomesa_tpu.scan.batcher as j_batcher
    import geomesa_tpu_torch.scan.batcher as t_batcher

    def run(P, batcher_mod):
        P.tenants.QOS_ENABLED.set("true")
        log = P.audit.AuditLogger()
        ds = seeded_store(P, audit=log)
        b = batcher_mod.QueryBatcher(ds, max_batch=4)
        chunk = []
        for i in range(4):
            with P.audit.principal_scope(f"u{i}"), \
                    P.tenants.tenant_scope(f"t{i}"):
                chunk.append(batcher_mod._Pending(P.Query(
                    "pts", f"BBOX(geom, {-160 + 80 * i}, -60, "
                           f"{-100 + 80 * i}, 60)")))
        with P.audit.principal_scope("leader"), \
                P.tenants.tenant_scope("lead"):
            b._dispatch("pts", chunk)
        return [_fields(e) for e in log.query()]
    want, got = run(J, j_batcher), run(T, t_batcher)
    assert [(e["user"], e["tenant"]) for e in want] == [("leader", "lead")] * 4
    assert [(e["user"], e["tenant"]) for e in got] == \
        [(f"u{i}", f"t{i}") for i in range(4)]
    for g, w in zip(got, want):
        for k in ("user", "tenant"):
            g.pop(k), w.pop(k)
        assert g == w and g["batched"] is True
