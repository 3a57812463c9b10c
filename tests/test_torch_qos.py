"""The port's tenant plane against the JAX package's on the CPU: identity
(token map, the kill switch, scopes across copied contexts), the
deficit-weighted round-robin drain, the batcher's per-tenant admission,
per-tenant retry budgets, metric-label safety, and the tenant's
attribution in audit events and SLO series.

Each scenario runs in both packages. Tolerance: exact — drained orders,
deficits, dispatched counts, retry counts, metrics snapshots and audit
fields are equal. QoS stays off by default (``geomesa.qos.enabled``), and
the off path is the plain FIFO, bit for bit.

Every wait is bounded and every thread is joined."""

import contextvars
import threading
import types

import numpy as np
import pytest

import geomesa_tpu.audit as j_audit
import geomesa_tpu.metrics as j_metrics
import geomesa_tpu.metrics.registry as j_registry
import geomesa_tpu.obs.slo as j_slo
import geomesa_tpu.resilience.policy as j_policy
import geomesa_tpu.scan.batcher as j_batcher
import geomesa_tpu.tenants as j_tenants
from geomesa_tpu.features import parse_spec as j_parse_spec
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.store.memory import InMemoryDataStore as JStore
from geomesa_tpu.utils.properties import SystemProperty as JProperty
import geomesa_tpu_torch.audit as t_audit
import geomesa_tpu_torch.metrics as t_metrics
import geomesa_tpu_torch.metrics.registry as t_registry
import geomesa_tpu_torch.obs.slo as t_slo
import geomesa_tpu_torch.resilience.policy as t_policy
import geomesa_tpu_torch.scan.batcher as t_batcher
import geomesa_tpu_torch.tenants as t_tenants
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.index.api import Query as TQuery
from geomesa_tpu_torch.store.memory import InMemoryDataStore as TStore
from geomesa_tpu_torch.utils.properties import SystemProperty as TProperty

J = types.SimpleNamespace(
    name="jax", tenants=j_tenants, metrics=j_metrics, registry=j_registry,
    policy=j_policy, batcher=j_batcher, audit=j_audit, slo=j_slo,
    Query=JQuery, Property=JProperty, parse_spec=j_parse_spec,
    store=lambda: JStore())
T = types.SimpleNamespace(
    name="torch", tenants=t_tenants, metrics=t_metrics, registry=t_registry,
    policy=t_policy, batcher=t_batcher, audit=t_audit, slo=t_slo,
    Query=TQuery, Property=TProperty, parse_spec=t_parse_spec,
    store=lambda: TStore(device="cpu"))
PKGS = (J, T)

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"


def both(fn):
    return fn(J), fn(T)


def seeded_store(P, n=100):
    rng = np.random.default_rng(5)
    ds = P.store()
    ds.create_schema(P.parse_spec("people", SPEC))
    ds.write_dict("people", [f"p{i}" for i in range(n)], {
        "name": [f"n{i % 7}" for i in range(n)], "age": np.arange(n),
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})
    return ds


@pytest.fixture(autouse=True)
def _hygiene():
    for P in PKGS:
        P.tenants.tenant_registry.reset()
        P.slo.slo_engine.clear()
    yield
    for P in PKGS:
        P.tenants.QOS_ENABLED.set(None)
        P.tenants.WEB_AUTH_TOKENS.set(None)
        P.tenants.tenant_registry.reset()
        P.slo.slo_engine.clear()


@pytest.fixture
def qos_on():
    for P in PKGS:
        P.tenants.QOS_ENABLED.set("true")
    yield


class _knob:
    """A per-tenant property of both packages for a block."""

    def __init__(self, name, value):
        self.props = [P.Property(name) for P in PKGS]
        self.value = value

    def __enter__(self):
        for p in self.props:
            p.set(self.value)

    def __exit__(self, *exc):
        for p in self.props:
            p.set(None)


# -- identity ---------------------------------------------------------------

def test_token_map_resolves(qos_on):
    for P in PKGS:
        reg = P.tenants.tenant_registry
        assert reg.resolve_token("anything") == P.tenants.DEFAULT_TENANT
        P.tenants.WEB_AUTH_TOKENS.set("tok1:alice, tok2:bob")
        assert [reg.resolve_token(t) for t in ("tok1", "tok2", "nope",
                                               None)] == \
            ["alice", "bob", "default", "default"]


def test_kill_switch_hides_tenant():
    """QoS is off by default: no tenant, no tenant budget."""
    for P in PKGS:
        with P.tenants.tenant_scope("alice"):
            assert P.tenants.active_tenant() is None
            assert P.tenants.tenant_budget() is None
        assert P.tenants.qos_enabled() is False


def test_scope_nests_restores_and_survives_copied_context(qos_on):
    for P in PKGS:
        at = P.tenants.active_tenant
        assert at() is None
        with P.tenants.tenant_scope("a"):
            assert at() == "a"
            with P.tenants.tenant_scope("b"):
                assert at() == "b"
            assert at() == "a"
            ctx = contextvars.copy_context()
        assert at() is None
        assert ctx.run(at) == "a"


def test_policy_reads_knobs_live(qos_on):
    def run(P):
        with _knob("geomesa.qos.tenant.pt.weight", "3"), \
                _knob("geomesa.qos.max.inflight", "5"), \
                _knob("geomesa.qos.tenant.pt.visibility", "admin"):
            pol = P.tenants.tenant_registry.policy("pt")
            other = P.tenants.tenant_registry.policy("other")
        return pol, other
    want, got = both(run)
    assert [g.__dict__ for g in got] == [w.__dict__ for w in want]
    assert got[0].weight == 3.0 and got[1].weight == 1.0


# -- the deficit-weighted round-robin ---------------------------------------

DRAINS = {
    "two_to_one": ([{"a": list(range(100)), "b": list(range(100, 200))}],
                   30, {"a": 2.0, "b": 1.0}),
    "fifo": ([{"a": [1, 2, 3, 4], "b": [10, 20, 30, 40]}], 8, None),
    "fractional": ([{"a": [1, 2, 3, 4], "b": [10, 11]}] * 2, 2,
                   {"a": 1.0, "b": 0.5}),
    "cap": ([{"a": [1, 2, 3]}], 2, None),
    "three_tenants": ([{"x": list(range(40)), "y": list(range(100, 140)),
                        "z": list(range(200, 240))}] * 3, 16,
                      {"x": 4.0, "y": 2.0, "z": 1.0}),
    "idle_return": ([{"a": list(range(10)), "b": [99]}]
                    + [{"a": list(range(4))}] * 5
                    + [{"a": list(range(10)), "b": list(range(100, 110))}],
                    11, {"a": 5.0, "b": 5.0}),
}


@pytest.mark.parametrize("case", sorted(DRAINS))
def test_weighted_drain_orders_equal_reference(case):
    """The same queues, caps and weights drain in the same order, with
    the same deficits carried between calls, in both packages."""
    rounds, cap, weights = DRAINS[case]

    def run(P):
        deficits, out = {}, []
        queues = {t: list(q) for t, q in rounds[0].items()}
        for i, r in enumerate(rounds):
            if i:
                for t, q in r.items():
                    queues[t] = list(q) if t not in queues or not queues[t] \
                        else queues[t]
            got = P.tenants.weighted_drain(
                queues, deficits, cap,
                weights.get if weights else None)
            out.append((got, dict(deficits),
                        {t: list(q) for t, q in queues.items()}))
        return out
    want, got = both(run)
    assert got == want
    if case == "two_to_one":
        first = got[0][0]
        assert sum(v < 100 for v in first) == 20
    if case == "fractional":
        assert [g[0] for g in got] == [[1, 2], [3, 10]]


# -- the batcher's admission ------------------------------------------------

def _pendings(P, tenants):
    out = []
    for t in tenants:
        p = P.batcher._Pending(P.Query("people", "INCLUDE"))
        p.tenant = t
        out.append(p)
    return out


@pytest.mark.parametrize("tenants,weights", [
    ([None] * 10, {}),
    (["heavy"] * 12 + ["light"] * 12, {"heavy": "3"}),
    (["a", "b", "c"] * 9 + ["a"] * 5, {"a": "4", "b": "2"}),
])
def test_drain_chunks_equal_reference(qos_on, tenants, weights):
    """The leader's chunks: the plain FIFO with QoS off (no deficit
    kept), per-tenant deficit-weighted chunks with tenants bound; equal
    order, FIFO within each tenant, equal qos.admission.dispatched."""
    def run(P):
        reg = P.metrics.MetricsRegistry()
        b = P.batcher.QueryBatcher(seeded_store(P), max_batch=4,
                                   registry=reg)
        tq = P.batcher._TypeQueue()
        tq.items = _pendings(P, tenants)
        idx = {id(p): i for i, p in enumerate(tq.items)}
        props = [P.Property(f"geomesa.qos.tenant.{t}.weight")
                 for t in weights]
        for p, v in zip(props, weights.values()):
            p.set(v)
        try:
            with b._cond:
                chunks = b._drain_chunks("people", tq, 4)
        finally:
            for p in props:
                p.set(None)
        return ([[idx[id(p)] for p in c] for c in chunks], b._deficits,
                reg.snapshot()["counters"])
    want, got = both(run)
    assert got == want
    flat = [i for c in got[0] for i in c]
    assert sorted(flat) == list(range(len(tenants)))
    for t in set(tenants):
        mine = [i for i in flat if tenants[i] == t]
        assert mine == sorted(mine)
    if set(tenants) == {None}:
        assert flat == list(range(len(tenants))) and got[1] == {}


def test_fused_results_stay_exact_under_qos(qos_on):
    """Two tenants' queries through the batcher: each caller gets the
    JAX store's ids for its own query."""
    def run(P):
        ds = seeded_store(P)
        b = P.batcher.QueryBatcher(ds, max_batch=8, linger_us=4000)
        qs = [P.Query("people", f"age < {5 + i}") for i in range(6)]
        got = [None] * 6

        def go(i):
            with P.tenants.tenant_scope("t-even" if i % 2 else "t-odd"):
                got[i] = sorted(b.query(qs[i]).ids.astype(str))
        threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        return got
    want, got = both(run)
    assert got == want
    assert [len(g) for g in got] == [5, 6, 7, 8, 9, 10]


# -- per-tenant retry budgets -------------------------------------------------

def _retry(P, tenant, budget_cap, shared_cap, registry=None):
    shared = (P.policy.RetryBudget(capacity=shared_cap)
              if shared_cap is not None else None)
    pol = P.policy.RetryPolicy(
        max_attempts=5, base_s=0.0, cap_s=0.0, budget=shared,
        sleep=lambda s: None,
        **({"registry": registry} if registry is not None else {}))
    boom = [0]

    def flaky():
        boom[0] += 1
        raise ConnectionError("flap")
    prop = P.Property(f"geomesa.qos.tenant.{tenant}.retry.budget")
    prop.set(budget_cap)
    try:
        with P.tenants.tenant_scope(tenant):
            with pytest.raises(ConnectionError):
                pol.call(flaky)
    finally:
        prop.set(None)
    return boom[0], (shared.tokens if shared is not None else None)


@pytest.mark.parametrize("qos,tenant,cap,shared", [
    (True, "ra", "1", 100.0), (True, "rb", None, 100.0),
    (False, "ra", "1", 1.0), (True, "rx", "0", None)])
def test_retry_budgets_equal_reference(qos, tenant, cap, shared):
    """With QoS on a call charges its tenant's own budget (the shared
    one untouched); off, the policy's budget; an exhausted tenant
    budget counts qos.retry.exhausted{tenant}."""
    def run(P):
        P.tenants.QOS_ENABLED.set("true" if qos else "false")
        reg = P.metrics.MetricsRegistry()
        out = _retry(P, tenant, cap, shared, reg)
        return out, reg.snapshot()["counters"]
    want, got = both(run)
    assert got == want
    attempts = got[0][0]
    assert attempts == {("ra", True): 2, ("rb", True): 5, ("ra", False): 2,
                        ("rx", True): 1}[(tenant, qos)]
    if qos and shared is not None:
        assert got[0][1] == shared
    if tenant == "rx":
        assert got[1]['qos.retry.exhausted{tenant="rx"}'] == 1


# -- metric-label safety ------------------------------------------------------

@pytest.mark.parametrize("name", ['evil"\ntenant{x}', "a\nb", "x" * 500,
                                  "plain"])
def test_tenant_label_equals_reference(name):
    got = t_tenants.tenant_label(name)
    assert got == j_tenants.tenant_label(name)
    assert "\n" not in got and len(got) <= 64


def test_hostile_tenants_keep_exposition_parseable(qos_on):
    def run(P):
        reg = P.metrics.MetricsRegistry()
        registry = P.tenants.TenantRegistry(registry=reg)
        registry.try_acquire_inflight('evil"\nname # HELP bomb')
        P.registry.METRICS_MAX_SERIES.set("4")
        try:
            for i in range(20):
                registry.try_acquire_inflight(f"t{i}")
            registry.release_inflight("t3")
        finally:
            P.registry.METRICS_MAX_SERIES.set(None)
        return P.metrics.prometheus_text(reg.snapshot()), reg.snapshot()
    want, got = both(run)
    assert got == want
    text, snap = got
    for line in text.splitlines():
        assert line.startswith("#") or " " in line
    assert 'tenant="evil' in text
    fam = [k for k in snap["gauges"] if k.startswith("qos.web.inflight")]
    assert len(fam) == 5 and any('tenant="other"' in k for k in fam)
    assert snap["counters"]["metrics.series.dropped"] > 0


def test_inflight_caps_and_row_buckets_equal_reference(qos_on):
    def run(P):
        reg = P.metrics.MetricsRegistry()
        registry = P.tenants.TenantRegistry(registry=reg)
        with _knob("geomesa.qos.tenant.capped.max.inflight", "2"), \
                _knob("geomesa.qos.tenant.capped.max.inflight.rows", "100"):
            got = [registry.try_acquire_inflight("capped")
                   for _ in range(3)]
            got.append(registry.try_acquire_inflight("free"))
            got.append(registry.acquire_rows("capped", 80, block=False))
            got.append(registry.acquire_rows("capped", 30, block=False))
            registry.release_rows("capped", 80)
            got.append(registry.acquire_rows("capped", 300, block=False))
            status = registry.status()
        for t in status["tenants"].values():
            t.pop("retry_budget_tokens")
        return got, status, reg.snapshot()
    want, got = both(run)
    assert got == want
    assert got[0] == [True, True, False, True, True, False, True]


# -- attribution --------------------------------------------------------------

def test_audit_event_carries_tenant(qos_on):
    def run(P):
        log = P.audit.AuditLogger()
        with P.tenants.tenant_scope("aud"):
            assert P.audit.audit_query(log, "memory", "pts", "INCLUDE", {},
                                       1.0, 2.0, 3)
        first = log.query()[-1].tenant
        P.tenants.QOS_ENABLED.set("false")
        P.audit.audit_query(log, "memory", "pts", "INCLUDE", {}, 1.0, 2.0, 3)
        P.tenants.QOS_ENABLED.set("true")
        return first, log.query()[-1].tenant
    want, got = both(run)
    assert got == want == ("aud", None)


def test_slo_engine_grows_tenant_series(qos_on):
    def run(P):
        eng = P.slo.slo_engine
        eng.record("query", ok=True, latency_s=0.01, tenant="slo-t")
        routes = sorted(eng.status()["routes"])
        eng.clear()
        eng.record("query", ok=True, latency_s=0.01)
        return routes, sorted(eng.status()["routes"])
    want, got = both(run)
    assert got == want == (["query", "query.tenant.slo-t"], ["query"])
