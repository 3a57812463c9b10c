"""The port's observability planes against the JAX package's on the CPU:
the metrics registry (histogram timers, labels, the cardinality guard)
and its Prometheus exposition and reporters, request tracing (span
trees, sampling, the wire header, the ring, the JSONL export, the
batcher's fan-in graft), the stall watchdog and the sampling profiler,
the runtime collector, the SLO burn-rate engine and its react loop, the
query reaper, the batcher registry and the latency-derived batch caps.

Each scenario runs the same calls in both packages. Tolerance: exact.
Prometheus text and reporter lines are byte-equal (timestamps cut off);
snapshots, burn rates, react decisions and ``QueryTimeout`` stages are
equal; span trees are equal in kind, name, parent and attributes, times
and ids excepted. Where the port departs by design it says so beside the
check (device memory is sampled from ``torch.cuda`` only once CUDA is
initialized, so a CPU process records nothing).

Every wait is bounded, every thread a test starts is joined in a
``finally``, and the process-wide singletons are reset around each
test."""

import importlib
import json
import re
import threading
import time
import types

import numpy as np
import pytest

import geomesa_tpu.metrics as j_metrics
import geomesa_tpu.metrics.registry as j_registry
import geomesa_tpu.metrics.reporters as j_reporters
import geomesa_tpu.obs as j_obs
import geomesa_tpu.obs.prof as j_prof
import geomesa_tpu.obs.slo as j_slo
import geomesa_tpu.obs.trace as j_trace
import geomesa_tpu.resilience.policy as j_policy
import geomesa_tpu.scan.batcher as j_batcher
import geomesa_tpu.scan.registry as j_scanreg
import geomesa_tpu.store.memory as j_memory
import geomesa_tpu.utils.threads as j_threads
from geomesa_tpu.features import FeatureBatch as JFeatureBatch
from geomesa_tpu.features import parse_spec as j_parse_spec
from geomesa_tpu.index.api import Query as JQuery
from geomesa_tpu.utils.properties import SystemProperty as JProperty
import geomesa_tpu_torch.metrics as t_metrics
import geomesa_tpu_torch.metrics.registry as t_registry
import geomesa_tpu_torch.metrics.reporters as t_reporters
import geomesa_tpu_torch.obs as t_obs
import geomesa_tpu_torch.obs.prof as t_prof
import geomesa_tpu_torch.obs.slo as t_slo
import geomesa_tpu_torch.obs.trace as t_trace
import geomesa_tpu_torch.resilience.policy as t_policy
import geomesa_tpu_torch.scan.batcher as t_batcher
import geomesa_tpu_torch.scan.registry as t_scanreg
import geomesa_tpu_torch.store.memory as t_memory
import geomesa_tpu_torch.utils.properties as t_properties
import geomesa_tpu_torch.utils.threads as t_threads
from geomesa_tpu_torch.features import FeatureBatch as TFeatureBatch
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.index.api import Query as TQuery
from geomesa_tpu_torch.utils.properties import SystemProperty as TProperty

# the packages' ``obs`` export the collector as ``runtime``, which hides
# the submodule of that name from an ``import ... as``
j_runtime = importlib.import_module("geomesa_tpu.obs.runtime")
t_runtime = importlib.import_module("geomesa_tpu_torch.obs.runtime")


def _ns(name, metrics, registry, reporters, obs, prof, runtime, slo, trace,
        policy, batcher, scanreg, memory, threads, batch, parse, query,
        prop, store):
    return types.SimpleNamespace(
        name=name, metrics=metrics, registry=registry, reporters=reporters,
        obs=obs, prof=prof, runtime=runtime, slo=slo, trace=trace,
        policy=policy, batcher=batcher, scanreg=scanreg, memory=memory,
        threads=threads, FeatureBatch=batch, parse_spec=parse, Query=query,
        Property=prop, store=store,
        shed=(JProperty if name == "jax" else TProperty)(
            "geomesa.ingest.shed.queue.depth", "64"))


J = _ns("jax", j_metrics, j_registry, j_reporters, j_obs, j_prof, j_runtime,
        j_slo, j_trace, j_policy, j_batcher, j_scanreg, j_memory, j_threads,
        JFeatureBatch, j_parse_spec, JQuery, JProperty,
        lambda **kw: j_memory.InMemoryDataStore(**kw))
T = _ns("torch", t_metrics, t_registry, t_reporters, t_obs, t_prof,
        t_runtime, t_slo, t_trace, t_policy, t_batcher, t_scanreg, t_memory,
        t_threads, TFeatureBatch, t_parse_spec, TQuery, TProperty,
        lambda **kw: t_memory.InMemoryDataStore(device="cpu", **kw))
PKGS = (J, T)

SPEC = "*geom:Point:srid=4326,dtg:Date,name:String"


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


@pytest.fixture(autouse=True)
def _hygiene():
    """Reset every process-wide singleton of both packages around each
    test (the JAX suites' TestSingletonHygiene contract)."""
    def reset():
        for P in PKGS:
            P.obs.tracer.clear()
            P.obs.slo_engine.clear()
            P.obs.runtime.clear()
            P.obs.watchdog.clear()
            P.scanreg.batcher_registry.clear()
    reset()
    yield
    for P in PKGS:
        assert not P.obs.profiler.running, "a test left the profiler on"
    reset()


def seeded_store(P, n=200, name="pts", cls=None, **kw):
    rng = np.random.default_rng(11)
    sft = P.parse_spec(name, SPEC)
    ds = cls(**kw) if cls is not None else P.store(**kw)
    ds.create_schema(sft)
    ds.write(name, P.FeatureBatch.from_dict(
        sft, np.array([f"f{i}" for i in range(n)], dtype=object),
        {"geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)),
         "dtg": rng.integers(0, 10**12, n).astype(np.int64),
         "name": np.array([f"n{i % 5}" for i in range(n)], dtype=object)}))
    return ds


class _props:
    """Set package properties for a block; every one cleared after."""

    def __init__(self, P, **values):
        self.props = [(getattr(mod, attr), v) for (mod, attr), v in
                      ((_where(P, k), v) for k, v in values.items())]

    def __enter__(self):
        for p, v in self.props:
            p.set(v)
        return self

    def __exit__(self, *exc):
        for p, _ in self.props:
            p.set(None)


def _where(P, name):
    for mod in (P.trace, P.prof, P.runtime, P.slo, P.registry, P.policy,
                P.batcher, P.scanreg):
        if hasattr(mod, name):
            return mod, name
    raise KeyError(name)


# -- Prometheus text-format validator (exposition format 0.0.4) -------------

_PROM_TYPE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(counter|gauge|summary|histogram|untyped)$")
_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\\\|\\"|\\n|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\\\|\\"|\\n|[^"\\])*")*\})?'
    r" [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$")


def assert_prometheus_parses(text: str):
    assert text.endswith("\n") or text == ""
    for ln in text.splitlines():
        if ln:
            assert _PROM_TYPE.match(ln) or _PROM_SAMPLE.match(ln), ln


# -- the metrics registry: the same calls, byte-equal outputs ---------------

def _calls_basic(reg):
    reg.counter("web.requests", 3, labels={"route": "query"})
    reg.counter("queries")
    reg.counter("queries", 2)
    reg.gauge("cache.bytes", 1024)
    reg.gauge("features", 42.0)
    for _ in range(10):
        reg.observe("scan.latency", 0.002)


def _calls_labels(reg):
    reg.counter("hits", labels={"type": "a"})
    reg.counter("hits", 2, labels={"type": "b"})
    reg.counter("m", labels={"f": 'say "hi"\nback\\slash'})
    reg.observe("lat", 0.001, labels={"r": "a"})
    reg.observe("lat", 0.002, labels={"r": "b"})


def _calls_nonfinite(reg):
    reg.gauge("ewma.cold", float("inf"))
    reg.gauge("ewma.nan", float("nan"))
    reg.gauge("fine", 3.5)
    reg.counter("c", 4)


def _calls_histogram(reg):
    for _ in range(90):
        reg.observe("op", 0.001)
    for _ in range(10):
        reg.observe("op", 0.100)
    for v in np.random.default_rng(3).lognormal(-6.0, 2.0, 500):
        reg.observe("spread", float(v))


def _calls_cardinality(reg):
    for i in range(20):
        reg.counter("cg.hits", labels={"route": f"r{i}"})
    for _ in range(3):
        reg.counter("cg.ok", labels={"r": "a"})
    reg.counter("cg.ok", labels={"r": "z"})
    reg.gauge("cg.g", 1.0, labels={"r": "a"})
    reg.gauge("cg.g", 2.0, labels={"r": "b"})
    reg.observe("cg.t", 0.01, labels={"r": "a"})
    reg.observe("cg.t", 0.02, labels={"r": "b"})


REGISTRY_CALLS = {"basic": _calls_basic, "labels": _calls_labels,
                  "nonfinite": _calls_nonfinite,
                  "histogram": _calls_histogram,
                  "cardinality": _calls_cardinality}


def _registry_outputs(P, calls, tmp_path):
    reg = P.metrics.MetricsRegistry()
    with _props(P, METRICS_MAX_SERIES="4"):
        calls(reg)
    snap = reg.snapshot()
    tsv = tmp_path / f"{P.name}.tsv"
    reg.report_delimited(str(tsv))
    P.reporters.DelimitedFileReporter(str(tsv), ",").report(snap)
    graphite = []
    P.reporters.GraphiteLineReporter(graphite.append, "gm").report(snap)
    jl = tmp_path / f"{P.name}.jsonl"
    P.reporters.JsonLineReporter(str(jl)).report(snap)
    rows = [ln.split("\t", 1)[-1] if "\t" in ln else ln.split(",", 1)[1]
            for ln in tsv.read_text().splitlines()]
    doc = json.loads(jl.read_text())
    doc.pop("ts")
    return {"prometheus": reg.prometheus_text(),
            "module_prometheus": P.metrics.prometheus_text(snap),
            "snapshot": json.dumps(snap, sort_keys=True, allow_nan=False),
            "delimited": rows,
            "graphite": [ln.rsplit(" ", 1)[0] for ln in graphite],
            "json": doc}


@pytest.mark.parametrize("case", sorted(REGISTRY_CALLS))
def test_registry_outputs_equal_reference(case, tmp_path):
    """The same registry calls give byte-equal Prometheus text, equal
    snapshots (strict JSON) and equal delimited, Graphite and JSON
    reporter lines in both packages."""
    want, got = both(lambda P: _registry_outputs(P, REGISTRY_CALLS[case],
                                                 tmp_path))
    assert got == want
    assert_prometheus_parses(got["prometheus"])
    assert got["prometheus"] == got["module_prometheus"]


def test_histogram_quantiles_and_buckets():
    reg = t_metrics.MetricsRegistry()
    _calls_histogram(reg)
    t = reg.snapshot()["timers"]["op"]
    assert t["count"] == 100
    assert 0.5 <= t["p50_ms"] <= 1.6 and 50 <= t["p99_ms"] <= 110
    assert t["p99_ms"] <= t["max_ms"]
    assert t["max_ms"] == pytest.approx(100, rel=0.01)
    assert t["mean_ms"] == pytest.approx(10.9, rel=0.05)
    assert t["buckets"][-1] == [None, 100]
    text = reg.prometheus_text()
    found = re.findall(
        r'^geomesa_op_seconds_hist_bucket\{le="([^"]+)"\} (\S+)$', text,
        re.M)
    counts = [float(c) for _, c in found]
    assert counts == sorted(counts) and found[-1] == ("+Inf", "100.0")
    assert 'geomesa_op_seconds{quantile="0.5"}' in text
    assert "# TYPE geomesa_op_seconds_hist histogram" in text


def test_time_context_manager_and_empty_timer():
    for P in PKGS:
        reg = P.metrics.MetricsRegistry()
        assert reg.snapshot()["timers"] == {}
        with reg.time("slept"):
            time.sleep(0.01)
        t = reg.snapshot()["timers"]["slept"]
        assert t["count"] == 1 and t["p50_ms"] >= 5


def test_labeled_and_split_keys_equal_reference():
    for labels in ({"route": "query", "code": 200}, None,
                   {"f": 'say "hi"\nback\\slash', "bad key": 1}):
        want, got = both(lambda P: P.metrics.labeled_key("m.x", labels))
        assert got == want
        assert t_metrics.split_key(got) == j_metrics.split_key(want)
    assert t_metrics.split_key("plain") == ("plain", "")


@pytest.mark.parametrize("raw", ["query", "a b\nc\td", "evil\nkey\r\n",
                                 "x" * 500, "", "a\tb", "ok.key:1/-"])
def test_sanitize_key_equals_reference(raw):
    got = t_metrics.sanitize_key(raw)
    assert got == j_metrics.sanitize_key(raw)
    assert "\n" not in got and "\t" not in got and 0 < len(got) <= 64


def test_cardinality_guard_collapses_to_other():
    reg = t_metrics.MetricsRegistry()
    with _props(T, METRICS_MAX_SERIES="4"):
        _calls_cardinality(reg)
    snap = reg.snapshot()
    fam = [k for k in snap["counters"] if k.startswith("cg.hits")]
    assert len(fam) == 5
    assert snap["counters"]['cg.hits{route="other"}'] == 16
    assert snap["counters"]['cg.ok{r="a"}'] == 3
    assert snap["counters"]["metrics.series.dropped"] == 16


# -- tracing ----------------------------------------------------------------

@pytest.fixture
def sampled():
    """Head sampling on in both packages; restored after."""
    for P in PKGS:
        P.trace.TRACE_SAMPLE.set("1.0")
    try:
        yield
    finally:
        for P in PKGS:
            P.trace.TRACE_SAMPLE.set(None)
            P.trace.TRACE_SLOW_MS.set(None)


@pytest.fixture
def untraced():
    for P in PKGS:
        P.trace.TRACE_SAMPLE.set("0")
        P.trace.TRACE_SLOW_MS.set("0")
    try:
        yield
    finally:
        for P in PKGS:
            P.trace.TRACE_SAMPLE.set(None)
            P.trace.TRACE_SLOW_MS.set(None)


_VOLATILE_ATTRS = {"stalled"}


def _tree(spans):
    """A trace as a sorted tuple of (kind, name, parent path, attrs,
    annotation texts, link count, error type): ids and times dropped."""
    by_id = {s["span_id"]: s for s in spans}

    def path(s):
        out = []
        pid = s.get("parent_id")
        while pid in by_id:
            p = by_id[pid]
            out.append((p["kind"], p["name"]))
            pid = p.get("parent_id")
        return tuple(out)

    rows = []
    for s in spans:
        attrs = tuple(sorted((k, v) for k, v in s.get("attrs", {}).items()
                             if k not in _VOLATILE_ATTRS))
        notes = tuple(a["text"] for a in s.get("annotations", []))
        err = (s.get("error") or "").split(":")[0]
        rows.append((s["kind"], s["name"], path(s), attrs, notes,
                     len(s.get("links", [])), err))
    return tuple(sorted(rows, key=repr))


def _trees(P):
    return sorted((_tree(P.obs.tracer.get(t["trace_id"]))
                   for t in P.obs.tracer.traces(limit=1000)), key=repr)


TRACED = {
    "query": lambda P, ds: ds.query(P.Query(
        "pts", "BBOX(geom, -50, -40, 50, 40)")),
    "query_count": lambda P, ds: ds.query_count(P.Query(
        "pts", "BBOX(geom, -50, -40, 50, 40) AND name = 'n1'")),
    "query_batched": lambda P, ds: ds.query_batched([
        P.Query("pts", "BBOX(geom, -50, -40, 50, 40)"),
        P.Query("pts", "BBOX(geom, 0, 0, 60, 50)"),
        P.Query("pts", "name = 'n2'"),
        P.Query("pts", "BBOX(geom, 0, 0, 1, 1) AND BBOX(geom, 5, 5, 6, 6)")]),
    "empty_type": lambda P, ds: ds.query(P.Query("none", "INCLUDE")),
}


@pytest.mark.parametrize("entry", sorted(TRACED))
def test_store_span_trees_equal_reference(sampled, entry):
    """A web-rooted request through each store entry point: the same
    span tree (store-scan spans with index, rows, hits; the fused
    store-scan with fused and rows) in both packages."""
    def run(P):
        ds = seeded_store(P)
        ds.create_schema(P.parse_spec("none", SPEC))
        with P.obs.tracer.span("web", entry, root=True):
            TRACED[entry](P, ds)
        return _trees(P)
    want, got = both(run)
    assert got == want
    assert len(got) == 1 and got[0]


def test_span_tree_parenting_and_noops(sampled):
    tracer = t_obs.tracer
    with tracer.span("web", "GET /x", root=True) as w:
        with tracer.span("store-scan", "pts") as s:
            s.set_attr(rows=10)
    by_kind = {d["kind"]: d for d in tracer.get(w.trace_id)}
    assert by_kind["store-scan"]["parent_id"] == by_kind["web"]["span_id"]
    assert by_kind["web"]["parent_id"] is None
    assert by_kind["store-scan"]["attrs"]["rows"] == 10
    orphan = tracer.span("store-scan", "orphan")
    assert orphan.span_id is None
    with orphan:
        pass
    assert len(tracer.traces()) == 1


@pytest.mark.parametrize("sample,slow_ms,sleep_s,kept", [
    ("0", "0", 0.0, False), ("0", "60000", 0.0, False),
    ("0", "10", 0.03, True), ("1.0", "0", 0.0, True)])
def test_sampling_policies_equal_reference(sample, slow_ms, sleep_s, kept):
    """Head sampling and slow-query capture keep or drop the same
    traces in both packages."""
    def run(P):
        with _props(P, TRACE_SAMPLE=sample, TRACE_SLOW_MS=slow_ms):
            sp = P.obs.tracer.span("web", "x", root=True)
            with sp:
                time.sleep(sleep_s)
            return (sp.span_id is not None, len(P.obs.tracer.traces()))
    want, got = both(run)
    assert got == want
    assert (got[1] == 1) == kept


def test_annotations_error_and_ring_eviction(sampled):
    def run(P):
        tracer = P.obs.tracer
        try:
            with tracer.span("web", "boom", root=True) as w:
                w.annotate("checkpoint", step=1)
                raise ValueError("kaput")
        except ValueError:
            pass
        first = _tree(tracer.get(w.trace_id))
        assert tracer.traces()[0]["error"] is True
        with _props(P, TRACE_MAX_SPANS="10"):
            tids = []
            for i in range(20):
                with tracer.span("web", f"t{i}", root=True) as sp:
                    pass
                tids.append(sp.trace_id)
        kept = {s["trace_id"] for s in tracer.traces(limit=100)}
        assert tids[-1] in kept and tids[0] not in kept
        return first, [tids.index(t) for t in kept if t in tids]
    want, got = both(run)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])


def test_wire_header_roundtrip_and_continuation(sampled):
    def run(P):
        tracer = P.obs.tracer
        with tracer.span("remote", "client-leg", root=True) as c:
            hdr = tracer.inject()
        tid, span_id, flag = tracer.extract(hdr)
        assert (tid, span_id, flag) == (c.trace_id, c.span_id, True)
        assert tracer.extract(None) is None
        assert tracer.extract("garbage") is None
        seen = {}

        def server_side():
            with tracer.span("web", "srv", root=True, remote=hdr) as s:
                seen["tid"] = s.trace_id
        t = threading.Thread(target=server_side)
        t.start()
        t.join(10.0)
        assert not t.is_alive()
        assert seen["tid"] == c.trace_id
        return _tree(tracer.get(c.trace_id)), P.obs.TRACE_HEADER
    want, got = both(run)
    assert got == want


def test_wire_sampled_flag_keeps_downstream(untraced):
    def run(P):
        hdr = "aaaa0000bbbb1111:cccc2222dddd3333:1"
        with P.obs.tracer.span("web", "srv", root=True, remote=hdr) as s:
            pass
        return (P.obs.tracer.get("aaaa0000bbbb1111") is not None,
                s.parent_id)
    want, got = both(run)
    assert got == want == (True, "cccc2222dddd3333")


def test_jsonl_export_equal_reference(sampled, tmp_path):
    def run(P):
        out = tmp_path / f"{P.name}.jsonl"
        with _props(P, TRACE_PATH=str(out)):
            with P.obs.tracer.span("web", "exported", root=True) as w:
                with P.obs.tracer.span("store-scan", "pts"):
                    P.obs.annotate("note", k=1)
                    P.obs.set_flag("cache_hit")
                    assert P.obs.get_flag("cache_hit") is True
                    assert P.obs.current_trace_id() == w.trace_id
        lines = [json.loads(ln) for ln in out.read_text().splitlines()]
        return _tree(lines)
    want, got = both(run)
    assert got == want and len(got) == 2


# -- the batcher's fan-in: links and the graft --------------------------------

def _gated_class(P):
    """A store that holds a marked scalar query in flight (an event
    gates it) so the next leader lingers for followers; ``entered`` is
    set once the gated query is inside the store."""
    base = P.memory.InMemoryDataStore

    class Gated(base):
        hold = None
        entered = None

        def query(self, q, *args, **kwargs):
            if getattr(q, "hints", {}).get("_gate"):
                q = P.Query(q.type_name, q.filter)
                self.entered.set()
                assert self.hold.wait(10.0), "gated query never released"
            return super().query(q, *args, **kwargs)
    return Gated


def _fan_in(P):
    """Two followers coalesced behind a gated dispatch: the batcher's
    leader lingers (adaptive off, so the wait is the ceiling) until both
    are queued; no sleep lines the threads up."""
    cls = _gated_class(P)
    ds = seeded_store(P, cls=lambda: cls(**({"device": "cpu"}
                                           if P is T else {})))
    b = P.batcher.QueryBatcher(ds, max_batch=2, linger_us=5_000_000,
                               adaptive=False)
    ds.hold, ds.entered = threading.Event(), threading.Event()
    gate = P.Query("pts", "BBOX(geom, -179.5, -89.5, -179.0, -89.0)")
    gate.hints["_gate"] = True
    warm = threading.Thread(target=b.query, args=(gate,))
    warm.start()
    threads = []
    try:
        assert ds.entered.wait(10.0)
        qs = [P.Query("pts", "BBOX(geom, -60, -50, 0, 0)"),
              P.Query("pts", "BBOX(geom, 0, 0, 60, 50)")]
        results = [None, None]
        for i, q in enumerate(qs):
            t = threading.Thread(target=lambda i=i, q=q:
                                 results.__setitem__(i, b.query(q)))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(30.0)
            assert not t.is_alive()
        summaries = P.obs.tracer.traces()
        trees = sorted((_tree(P.obs.tracer.get(s["trace_id"]))
                        for s in summaries), key=repr)
        dispatch_ids = set()
        for s in summaries:
            spans = P.obs.tracer.get(s["trace_id"])
            by_kind = {d["kind"]: d for d in spans}
            assert any(ln["span_id"] == by_kind["dispatch"]["span_id"]
                       for ln in by_kind["batcher-wait"]["links"])
            dispatch_ids.add(by_kind["dispatch"]["span_id"])
        ids = [list(r.ids) for r in results]
    finally:
        ds.hold.set()
        warm.join(10.0)
        for t in threads:
            t.join(10.0)
    assert not warm.is_alive()
    assert len(summaries) == 2 and len(dispatch_ids) == 1
    return trees, ids, b.stats()["coalesced_queries"]


def test_coalesced_followers_get_dispatch_subtree(sampled):
    """Both callers' traces hold the one fused dispatch (batcher-wait ->
    dispatch -> store-scan), with links both ways, as in the JAX
    batcher; the ids equal the reference's."""
    want, got = both(_fan_in)
    assert got == want
    assert got[2] == 2
    for tree in got[0]:
        kinds = [r[0] for r in tree]
        assert sorted(kinds) == ["batcher-wait", "dispatch", "store-scan"]


# -- the stall watchdog and the profiler --------------------------------------

class FakeClock:
    def __init__(self, t=1_000_000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += float(s)


def test_watchdog_thresholds_equal_reference():
    def run(P):
        clk = FakeClock()
        wd = P.prof.StallWatchdog(registry=P.metrics.MetricsRegistry(),
                                  clock=clk)
        with _props(P, WATCHDOG_MIN_MS="1"):
            for _ in range(10):
                with wd.watch("op"):
                    clk.advance(0.010)
            learned = wd.threshold_s("op")
        cold = wd.threshold_s("never-seen")
        with wd.watch("short"):
            clk.advance(0.001)
        clk.advance(100)
        after = (wd.check(now=clk()), wd.stalls())
        with _props(P, WATCHDOG_FACTOR="0"):
            with wd.watch("op"):
                clk.advance(100)
                off = wd.check(now=clk())
        return learned, cold, after, off
    want, got = both(run)
    assert got == want
    assert 0.05 <= got[0] <= 0.15 and got[1] == pytest.approx(0.8)
    assert got[2] == ([], []) and got[3] == []


def test_stall_captured_with_live_stack_and_span_kept():
    """A watched op parked past its threshold: the owning thread's live
    stack lands on its span, which is force-kept at sample rate 0."""
    def run(P):
        clk = FakeClock()
        reg = P.metrics.MetricsRegistry()
        wd = P.prof.StallWatchdog(registry=reg, clock=clk)
        parked, release = threading.Event(), threading.Event()

        def worker():
            with P.obs.tracer.span("dispatch", "stalled", root=True) as sp:
                with wd.watch("dispatch.stalltest", span=sp):
                    parked.set()
                    release.wait(30.0)
        t = threading.Thread(target=worker, daemon=True)
        with _props(P, TRACE_SAMPLE="0", TRACE_SLOW_MS="60000"):
            t.start()
            try:
                assert parked.wait(10.0)
                clk.advance(10)
                recs = wd.check(now=clk())
                again = wd.check(now=clk())
            finally:
                release.set()
                t.join(10.0)
        assert not t.is_alive()
        (rec,) = recs
        assert rec["stack"] and any("threading" in f for f in rec["stack"])
        assert any(k.startswith("prof.watchdog.stalls")
                   for k in reg.snapshot()["counters"])
        (summary,) = P.obs.tracer.traces()
        return (rec["key"], again, summary["root_kind"],
                _tree(P.obs.tracer.get(summary["trace_id"])))
    want, got = both(run)
    assert got == want
    assert got[1] == [] and got[2] == "dispatch"


def test_profiler_sample_and_collapsed_format():
    p = t_prof.ContinuousProfiler(registry=t_metrics.MetricsRegistry())
    release = threading.Event()
    t = threading.Thread(target=lambda: release.wait(30.0), daemon=True)
    t.start()
    try:
        p.sample_once()
    finally:
        release.set()
        t.join(10.0)
    assert not t.is_alive()
    text = p.collapsed()
    assert text.endswith("\n") and "threading.py:" in text
    for ln in text.splitlines():
        assert re.match(r"^\S+(;\S+)* \d+$", ln), ln
    st = p.stats()
    assert st["samples"] == 1 and st["nodes"] > 1


def test_profiler_trie_cap_equal_reference():
    def run(P):
        p = P.prof.ContinuousProfiler(registry=P.metrics.MetricsRegistry())
        with _props(P, PROF_MAX_NODES="3"):
            p._insert(["a", "b", "c", "d", "e"])
            p._insert(["x", "y", "z"])
        st = p.stats()
        return st["nodes"], st["truncated"], p.collapsed()
    want, got = both(run)
    assert got == want
    assert got[0] <= 5 and got[1] >= 1 and "<trunc>" in got[2]


def test_profiler_runs_and_stops(monkeypatch):
    """Refcounted start/stop; at 19 Hz the thread samples, checks the
    watchdog and leaves device memory alone on a CPU process."""
    p = t_prof.ContinuousProfiler(registry=t_metrics.MetricsRegistry())
    with _props(T, PROF_HZ="0"):
        p.start()
        p.start()
        try:
            assert p.running is True
            p.stop()
            assert p.running is True
        finally:
            p.stop()
        assert p.running is False
    p.start()
    try:
        deadline = time.monotonic() + 10.0
        while p.stats()["samples"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        p.stop()
    assert p.running is False and p.stats()["samples"] >= 2
    assert p.stats()["hz"] == 19.0


# -- the runtime collector ----------------------------------------------------

def test_runtime_accounting_equal_reference():
    def run(P):
        rc = P.runtime.RuntimeCollector(registry=P.metrics.MetricsRegistry())
        rc.note_plan_probe("batcher", ("pts", 8), hit=False)
        rc.note_plan_probe("batcher", ("pts", 8), hit=True)
        rc.note_plan_probe("batcher", ("pts", 8), hit=True)
        rc.note_dispatch("batcher", ("pts", 8), 0.004, h2d_bytes=1024,
                         d2h_bytes=256)
        rc.note_dispatch("batcher", ("pts", 8), 0.006)
        snap = rc.snapshot()
        with _props(P, RUNTIME_ENABLED="false"):
            off = P.runtime.RuntimeCollector(
                registry=P.metrics.MetricsRegistry())
            off.note_plan_probe("batcher", ("pts", 8), hit=False)
            off.note_dispatch("batcher", ("pts", 8), 0.004)
            off_snap = off.snapshot()
        return (snap["compile"], snap["dispatch"], snap["transfer"],
                off_snap["compile"], off_snap["dispatch"],
                rc._registry.prometheus_text().replace("\n", "|"))
    want, got = both(run)
    assert got == want
    assert got[0]["batcher"]["pts/8"] == {"hits": 2, "misses": 1}


def test_device_memory_sample_needs_initialized_cuda(monkeypatch):
    """Departure by design: the port samples ``torch.cuda`` only once
    this process initialized CUDA, so a CPU process records nothing
    (the JAX collector falls back to live host buffers). With CUDA
    initialized it reports the allocator's numbers for each card."""
    rc = t_runtime.RuntimeCollector(registry=t_metrics.MetricsRegistry())
    rc.sample_device_memory()
    assert rc.snapshot()["device_memory"]["samples"] == 0
    import torch
    stats = {"allocated_bytes.all.current": 4096,
             "allocated_bytes.all.peak": 8192,
             "allocation.all.current": 3}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    rc.sample_device_memory()
    mem = rc.snapshot()["device_memory"]
    assert mem["samples"] == 1
    assert mem["devices"]["cuda:0"] == {"bytes_in_use": 4096,
                                        "peak_bytes_in_use": 8192,
                                        "hwm_bytes": 8192}
    assert (mem["live_buffers"], mem["live_bytes"]) == (3, 4096)
    g = rc._registry.snapshot()["gauges"]
    assert g['runtime.device.bytes{device="cuda:0"}'] == 4096
    assert g["runtime.device.live_bytes"] == 4096


def test_runtime_hooks_fire_on_the_cpu_store():
    """The store's hooks reach the runtime plane: a fused batcher
    dispatch probes domain batcher (a miss, then a hit of the same
    class) and the join prewarm notes its dwithin and KNN classes."""
    from geomesa_tpu_torch.analytics.join import prewarm_join_kernels
    import torch
    t_obs.runtime.clear()
    ds = seeded_store(T)
    b = t_batcher.QueryBatcher(ds, max_batch=4)
    qs = [T.Query("pts", f"BBOX(geom, {x}, -40, {x + 40}, 40)")
          for x in (-120, -60, 0, 60)]
    b._dispatch("pts", [t_batcher._Pending(q) for q in qs])
    b._dispatch("pts", [t_batcher._Pending(q) for q in qs[:3]])
    prewarm_join_kernels((torch.zeros(8), torch.zeros(8)), 5)
    snap = t_obs.runtime.snapshot()
    assert snap["compile"]["batcher"] == {
        "pts/2/256/4": {"hits": 1, "misses": 1}}
    assert snap["dispatch"]["batcher"]["pts/2/256/4"]["count"] == 2
    assert snap["compile"]["join"] == {
        "dwithin/8/1024": {"hits": 0, "misses": 1},
        "knn/8/1": {"hits": 0, "misses": 1},
        "knn/8/8": {"hits": 0, "misses": 1}}


# -- the SLO engine -----------------------------------------------------------

class SpyReaction:
    engaged = False

    def __init__(self):
        self.calls = []

    def apply(self, firing):
        self.calls.append(bool(firing))


def _burn_fast(e, clk):
    for i in range(50):
        e.record("query", ok=(i != 0), latency_s=0.01, now=clk())


def _burn_below(e, clk):
    for i in range(100):
        e.record("query", ok=(i != 0), latency_s=0.01, now=clk())


def _burn_tiny(e, clk):
    for _ in range(6):
        e.record("query", ok=False, latency_s=0.01, now=clk())


def _burn_clear(e, clk):
    for _ in range(20):
        e.record("query", ok=False, latency_s=0.01, now=clk())
    e.evaluate(clk())
    clk.advance(400)
    for _ in range(20):
        e.record("query", ok=True, latency_s=0.01, now=clk())


def _burn_latency(e, clk):
    for _ in range(50):
        e.record("query", ok=True, latency_s=0.9, now=clk())


def _burn_trickle(e, clk):
    for i in range(200):
        e.record("query", ok=(i % 20 != 0), latency_s=0.01,
                 now=clk() - 7200)


def _burn_spike(e, clk):
    for _ in range(6000):
        e.record("query", ok=True, latency_s=0.01, now=clk() - 7200)
    for _ in range(5):
        e.record("query", ok=False, latency_s=0.01, now=clk())


def _burn_routes(e, clk):
    for i in range(10):
        e.record(f"route{i}", ok=True, latency_s=0.01, now=clk())


def _burn_tenants(e, clk):
    for i in range(30):
        e.record("store.scan", ok=i % 3 != 0, latency_s=0.2 * (i % 4),
                 now=clk(), tenant=f"t{i % 3}\n")


BURNS = {"fast": (_burn_fast, {}), "below": (_burn_below, {}),
         "tiny": (_burn_tiny, {}), "clear": (_burn_clear, {}),
         "latency": (_burn_latency, {}), "trickle": (_burn_trickle, {}),
         "spike": (_burn_spike, {}),
         "routes": (_burn_routes, {"SLO_MAX_ROUTES": "3"}),
         "windows": (_burn_tiny, {"SLO_WINDOWS_FAST": "1:10:14.4",
                                  "SLO_MIN_EVENTS": "2"}),
         "tenants": (_burn_tenants, {})}


@pytest.mark.parametrize("case", sorted(BURNS))
def test_burn_rates_equal_reference(case):
    """The same event stream under a fake clock gives equal burn rates,
    alert states, gauges and transition counters in both packages."""
    stream, knobs = BURNS[case]

    def run(P):
        clk = FakeClock()
        reg = P.metrics.MetricsRegistry()
        spy = SpyReaction()
        e = P.slo.SloEngine(clock=clk, registry=reg, reaction=spy)
        with _props(P, **knobs):
            stream(e, clk)
            st = e.evaluate(clk())
        return st, reg.snapshot(), spy.calls
    want, got = both(run)
    assert got == want


def _react_run(P, factor, preset):
    clk = FakeClock()
    linger, scale = P.batcher.BATCH_LINGER_MICROS, P.policy.RETRY_BUDGET_SCALE
    out = []
    with _props(P, SLO_REACT="true", SLO_REACT_FACTOR=factor):
        linger.set(preset)
        try:
            e = P.slo.SloEngine(clock=clk,
                                registry=P.metrics.MetricsRegistry())
            rb = P.policy.RetryBudget(capacity=10.0)
            knobs = (scale, linger, P.shed)

            def state():
                return ([k.get_override() for k in knobs],
                        round(rb.effective_capacity(), 9),
                        e._reaction.engaged)
            out.append(state())
            for _ in range(20):
                e.record("query", ok=False, latency_s=0.01, now=clk())
            e.evaluate(clk())
            out.append(state())
            clk.advance(400)
            for _ in range(20):
                e.record("query", ok=True, latency_s=0.01, now=clk())
            e.evaluate(clk())
            out.append(state())
            for _ in range(20):
                e.record("query", ok=False, latency_s=0.01, now=clk())
            e.evaluate(clk())
            _where(P, "SLO_REACT")[0].SLO_REACT.set("false")
            e.evaluate(clk())
            out.append(state())
        finally:
            linger.set(None)
            scale.set(None)
            P.shed.set(None)
    return out


@pytest.mark.parametrize("factor,preset", [(None, None), ("4", "7777"),
                                           ("10", None)])
def test_react_decisions_equal_reference(factor, preset):
    """The react loop tightens the same knobs by the same factor and
    restores each override exactly (the not-set state included), also
    when react is switched off mid-fire; the port's ingest shed knob
    (its home is utils.properties) moves as the JAX one does."""
    want, got = both(lambda P: _react_run(P, factor, preset))
    assert got == want
    assert got[1][2] is True and got[2][2] is False


def test_react_never_touches_knobs_by_default():
    for P in PKGS:
        clk = FakeClock()
        e = P.slo.SloEngine(clock=clk, registry=P.metrics.MetricsRegistry())
        _burn_fast(e, clk)
        assert e.evaluate(clk())["query"]["fast_firing"] is True
        assert P.policy.RETRY_BUDGET_SCALE.get_override() is None
        assert P.batcher.BATCH_LINGER_MICROS.get_override() is None
    assert t_properties.INGEST_SHED_QUEUE_DEPTH.name == \
        "geomesa.ingest.shed.queue.depth"
    assert t_properties.INGEST_SHED_QUEUE_DEPTH.as_int() == 64


def test_retry_budget_scale_clamps_banked_tokens():
    for P in PKGS:
        rb = P.policy.RetryBudget(capacity=10.0)
        assert rb.try_withdraw() is True
        P.policy.RETRY_BUDGET_SCALE.set("0.05")
        try:
            assert rb.effective_capacity() == pytest.approx(0.5)
            assert rb.try_withdraw() is False
        finally:
            P.policy.RETRY_BUDGET_SCALE.set(None)
        assert rb.try_withdraw() is False
        for _ in range(5):
            rb.deposit()
        assert rb.try_withdraw() is True


def test_store_queries_feed_the_slo_and_timer():
    """Every query records a store.scan timer and an SLO event (the
    reference's defaults: runtime and SLO on)."""
    from geomesa_tpu_torch.metrics import metrics
    ds = seeded_store(T)
    before = metrics.snapshot()["timers"]
    res = ds.query(T.Query("pts", "BBOX(geom, -50, -40, 50, 40)"))
    after = metrics.snapshot()["timers"]
    key = f'store.scan{{index="{res.plan.index}",type="pts"}}'
    assert after[key]["count"] == before.get(key, {"count": 0})["count"] + 1
    routes = t_obs.slo_engine.status()["routes"]
    assert routes["store.scan"]["events"] == 1


def test_singletons_exported():
    for P in PKGS:
        assert P.obs.slo_engine is P.slo.slo_engine
        assert P.obs.runtime is P.runtime.runtime
        assert P.obs.watchdog is P.prof.watchdog
        assert P.obs.profiler is P.prof.profiler
        assert P.obs.tracer is P.trace.tracer
    assert sorted(t_obs.__all__) == sorted(j_obs.__all__)


# -- the query reaper ---------------------------------------------------------

def test_managed_query_and_reaper():
    for P in PKGS:
        q = P.threads.ManagedQuery("t", "INCLUDE", 0.01)
        time.sleep(0.02)
        with pytest.raises(P.threads.QueryTimeout):
            q.check()
        tm = P.threads.ThreadManagement(sweep_interval_s=100)
        try:
            q2 = tm.register(P.threads.ManagedQuery("t", "f", 0.01))
            time.sleep(0.02)
            assert tm.sweep() == 1
            with pytest.raises(P.threads.QueryTimeout):
                q2.check()
        finally:
            tm.shutdown()
            tm._reaper.join(10.0)
            assert not tm._reaper.is_alive()


@pytest.fixture
def fake_reaper(monkeypatch):
    """Each package's store reaper swapped for a fresh one whose sweep
    thread is joined after the test, and the deadline clock of both
    ``utils.threads`` modules replaced by one fake monotonic clock the
    test advances."""
    clk = FakeClock(100.0)
    reapers = []
    for P in PKGS:
        monkeypatch.setattr(P.threads, "time",
                            types.SimpleNamespace(monotonic=clk))
        r = P.threads.ThreadManagement(sweep_interval_s=100)
        monkeypatch.setattr(P.memory, "_REAPER", r)
        reapers.append(r)
    yield clk
    for r in reapers:
        r.shutdown()
        if r._reaper is not None:
            r._reaper.join(10.0)
            assert not r._reaper.is_alive()


ENTRIES = {
    "query": lambda P, ds, q: ds.query(q),
    "query_count": lambda P, ds, q: ds.query_count(q),
    "query_batched": lambda P, ds, q: ds.query_batched(
        [q, P.Query("pts", "name = 'n1'")]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("stage", ["plan", "scan", "none"])
@pytest.mark.parametrize("how", ["hint", "property"])
def test_timeout_raised_at_the_same_stage(fake_reaper, entry, stage, how):
    """A deadline of 10 s on the fake clock; the clock jumps 20 s inside
    the plan or inside the scan. QueryTimeout comes from the same check
    in both packages (after the plan: the scan never runs), and a query
    whose clock stands still answers as the reference does. The deadline
    comes from the TIMEOUT hint or geomesa.query.timeout."""
    clk = fake_reaper

    def run(P):
        ds = seeded_store(P)
        cls = type(ds)
        calls = []
        orig_plan, orig_exec = cls._plan_for, cls._execute

        def plan(self, *a, **k):
            calls.append("plan")
            out = orig_plan(self, *a, **k)
            if stage == "plan":
                clk.advance(20)
            return out

        def execute(self, *a, **k):
            calls.append("scan")
            out = orig_exec(self, *a, **k)
            if stage == "scan":
                clk.advance(20)
            return out
        q = P.Query("pts", "BBOX(geom, -50, -40, 50, 40)")
        prop = P.Property("geomesa.query.timeout")
        if how == "hint":
            q.hints["TIMEOUT"] = 10
        else:
            prop.set("10 s")
        cls._plan_for, cls._execute = plan, execute
        try:
            ENTRIES[entry](P, ds, q)
            outcome = "answered"
        except P.threads.QueryTimeout as e:
            outcome = type(e).__name__ + ":" + str(e).split(":")[0]
        finally:
            cls._plan_for, cls._execute = orig_plan, orig_exec
            prop.set(None)
        return outcome, calls, len(P.memory._REAPER._open)
    want, got = both(run)
    assert got == want
    assert (got[0] == "answered") == (stage == "none")
    assert got[2] == 0     # every query completed, timed out or not


def test_timeout_hint_end_to_end():
    """TIMEOUT 1e-9 raises the port's QueryTimeout; 60 s answers."""
    ds = seeded_store(T)
    q = T.Query("pts", "INCLUDE", hints={"TIMEOUT": 1e-9})
    with pytest.raises(t_threads.QueryTimeout):
        ds.query(q)
    got = ds.query(T.Query("pts", "INCLUDE", hints={"TIMEOUT": 60}))
    assert got.n == 200
    import geomesa_tpu_torch.utils as t_utils
    assert t_utils.QueryTimeout is t_threads.QueryTimeout


# -- the batcher registry and the latency-derived caps ------------------------

def _fill(P, ds, tn, n=200, seed=3):
    ds.create_schema(P.parse_spec(tn, "*geom:Point:srid=4326"))
    rng = np.random.default_rng(seed)
    ds.write_dict(tn, [f"{tn}{i}" for i in range(n)],
                  {"geom": (rng.uniform(-180, 180, n),
                            rng.uniform(-90, 90, n))})


def test_registry_identity_and_kill_switch():
    reg = t_scanreg.BatcherRegistry(registry=t_metrics.MetricsRegistry())
    a, b = T.store(), T.store()
    assert reg.get(a) is reg.get(a) and reg.get(a) is not reg.get(b)
    assert reg.stats()["size"] == 2
    remote = types.SimpleNamespace(host="10.0.0.1", port=8080)
    assert t_scanreg.store_identity(remote) == ("remote", "10.0.0.1", 8080)
    t_scanreg.BATCHER_REGISTRY_ENABLED.set("false")
    try:
        assert t_scanreg.shared_batcher(a) is not t_scanreg.shared_batcher(a)
    finally:
        t_scanreg.BATCHER_REGISTRY_ENABLED.set(None)
    assert t_scanreg.shared_batcher(a) is t_scanreg.shared_batcher(a)
    assert t_scanreg.batcher_registry.get(a) is t_scanreg.shared_batcher(a)


def test_registry_survives_store_reopen(tmp_path):
    def run(P):
        reg = P.scanreg.BatcherRegistry(registry=P.metrics.MetricsRegistry())
        root = str(tmp_path / P.name)
        ds1 = P.store(durable_dir=root, wal_fsync="never")
        _fill(P, ds1, "pts")
        b1 = reg.get(ds1)
        ds1.close()
        ds2 = P.store(durable_dir=root, wal_fsync="never")
        b2 = reg.get(ds2)
        try:
            assert b2 is b1 and b2.store is ds2
            got = b2.query(P.Query("pts", "BBOX(geom, -180, -90, 180, 90)"))
            depths = reg.queue_depths()
        finally:
            ds2.close()
        return (P.scanreg.store_identity(ds2)[0], got.n, sorted(got.ids),
                depths)
    want, got = both(run)
    assert got == want and got[1] == 200


@pytest.mark.parametrize("budget_ms,static,want", [
    (25.0, 32, 2), (10_000.0, 32, 32), (0.001, 32, 1), (None, 32, 32)])
def test_latency_derived_caps_equal_reference(budget_ms, static, want):
    def run(P):
        ds = P.store()
        _fill(P, ds, "pts")
        b = P.batcher.QueryBatcher(ds, max_batch=static, linger_us=0,
                                   latency_budget_ms=budget_ms,
                                   registry=P.metrics.MetricsRegistry())
        shape = b._shape_key("pts", 8)
        cold = b.effective_max_batch("pts")
        b._observe_cost("pts", shape, 0.010)
        return shape[1:], cold, b.effective_max_batch("pts")
    j, t = both(run)
    assert t == j
    assert t[1] == static and t[2] == want


def test_linger_gauge_keyed_per_type():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        ds = P.store()
        _fill(P, ds, "ships", seed=1)
        _fill(P, ds, "planes", seed=2)
        b = P.batcher.QueryBatcher(ds, max_batch=4, linger_us=100,
                                   registry=reg)
        b.query(P.Query("ships", "BBOX(geom, -10, -10, 10, 10)"))
        b.query(P.Query("planes", "BBOX(geom, -10, -10, 10, 10)"))
        return sorted(k for k in reg.snapshot()["gauges"]
                      if k.startswith("batcher.linger"))
    want, got = both(run)
    assert got == want == ["batcher.linger_effective_us.planes",
                           "batcher.linger_effective_us.ships"]


# -- the hooked modules' annotations ------------------------------------------

def test_retry_and_fsync_annotations_equal_reference(sampled, tmp_path):
    """RetryPolicy annotates each retry on the current span, and the
    write-ahead log's group commit annotates its fsync (lsn, batch) under
    the stall watchdog, as the JAX modules do."""
    import geomesa_tpu.wal.log as j_wal
    import geomesa_tpu_torch.wal.log as t_wal

    def run(P, wal_mod):
        reg = P.metrics.MetricsRegistry()
        pol = P.policy.RetryPolicy(max_attempts=3, base_s=0.0, cap_s=0.0,
                                   sleep=lambda s: None, registry=reg)
        calls = [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise ConnectionError("flap")
            return "ok"
        log = wal_mod.WriteAheadLog(str(tmp_path / P.name), fsync="always",
                                    registry=reg)
        try:
            with P.obs.tracer.span("web", "w", root=True) as w:
                assert pol.call(flaky, name="leg") == "ok"
                log.append(1, b"payload")
        finally:
            log.close()
        spans = P.obs.tracer.get(w.trace_id)
        notes = [{k: v for k, v in a.items() if k not in ("t_ms", "ms")}
                 for a in spans[0]["annotations"]]
        keys = sorted(k for k in P.obs.watchdog._history)
        return notes, keys, reg.snapshot()["counters"]
    want, got = run(J, j_wal), run(T, t_wal)
    assert got[:2] == want[:2]
    assert [n["text"] for n in got[0]] == ["retry", "retry", "wal.fsync"]
    assert got[1] == ["wal.fsync"]
    assert got[2]["resilience.retries"] == want[2]["resilience.retries"] == 2


def test_standing_dispatch_reports_to_runtime():
    """A standing-filter dispatch probes its shape class and notes its
    dispatch (domain standing) under the watchdog key dispatch.cq, with
    the JAX set's class key and counts."""
    import geomesa_tpu.scan.standing as j_standing
    import geomesa_tpu_torch.scan.standing as t_standing

    def run(P, mod, **kw):
        sft = P.parse_spec("pts", SPEC)
        fs = mod.StandingFilterSet(sft, registry=P.metrics.MetricsRegistry(),
                                   **kw)
        for name, ecql in (("a", "BBOX(geom, -50, -40, 50, 40)"),
                           ("b", "name = 'n1' AND BBOX(geom, 0, 0, 90, 60)")):
            fs.register(name, P.Query("pts", ecql).filter)
        ds = seeded_store(P)
        batch = ds.query(P.Query("pts", "INCLUDE")).batch
        hits = [fs.dispatch(batch) for _ in range(2)]
        snap = P.obs.runtime.snapshot()
        return ({k: sorted(map(int, v)) for k, v in hits[0].items()},
                snap["compile"]["standing"],
                {c: d["count"] for c, d in snap["dispatch"]["standing"]
                 .items()},
                sorted(P.obs.watchdog._history))
    want = run(J, j_standing)
    got = run(T, t_standing, device="cpu")
    assert got == want
    (cls,) = got[1]
    assert got[1][cls] == {"hits": 1, "misses": 1}
    assert got[3] == ["dispatch.cq"]
