"""The port's metrics registry against the JAX package's on the same
inputs. Tolerance: exact (keys, counts and the rounded quantiles)."""

import math

import pytest

from geomesa_tpu.metrics import registry as jreg
from geomesa_tpu_torch.metrics import registry as treg


@pytest.mark.parametrize("raw", [
    "ships", "my type\nname", 'a"b{c}', "x" * 100, "", "ais:2016/07",
    "tab\there"])
def test_sanitize_key_matches(raw):
    assert treg.sanitize_key(raw) == jreg.sanitize_key(raw)


@pytest.mark.parametrize("labels", [
    None, {}, {"type": "ships"}, {"b k": 'v"1', "a": "line\nbreak"}])
def test_labeled_key_matches(labels):
    assert (treg.labeled_key("store.scan", labels)
            == jreg.labeled_key("store.scan", labels))


def test_snapshot_matches():
    regs = treg.MetricsRegistry(), jreg.MetricsRegistry()
    durations = [1e-6 * 1.7 ** i for i in range(30)] + [0.0, 3.0, 3.0]
    for r in regs:
        r.counter("batcher.queries", 4)
        r.counter("batcher.queries")
        r.counter("store.scan", 2, labels={"type": "ais"})
        r.gauge("batcher.coalesce_ratio", 0.25)
        r.gauge("ewma", math.inf)
        for d in durations:
            r.observe("batcher.linger", d)
    got, want = (r.snapshot() for r in regs)
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"] == {
        "batcher.coalesce_ratio": 0.25, "ewma": None}
    # the timers' sparse cumulative buckets included (the registry is
    # whole since the serving planes)
    assert got["timers"] == want["timers"]


def test_time_records_one_duration():
    r = treg.MetricsRegistry()
    for _ in range(3):
        with r.time("op", labels={"type": "ais"}):
            pass
    t = r.snapshot()["timers"]['op{type="ais"}']
    assert t["count"] == 3 and 0 <= t["p50_ms"] <= t["max_ms"]
