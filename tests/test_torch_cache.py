"""The port's materialized pushdown cache (``cache/``) against the JAX
package's on the CPU: the canonical plan keys, the store's caching
wrappers on density, BIN, Arrow and stats (payloads on a miss and on a
hit, across writes and deletes), the pushdown versions (durable and not,
through a reopen), ``cache_status()``, single flight, the LRU byte
budget, the invalidation race, the refresher, the audit records and
spans of a cached call, and the stores that reach the cache through the
in-memory stores they wrap.

Each scenario runs the same calls in both packages. Tolerance: exact.
Keys, bytes, versions, counters and statuses are equal; density grids
are compared with ``np.array_equal``; audit events are equal in every
field but their times and trace ids."""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import geomesa_tpu.audit as j_audit
import geomesa_tpu.cache as j_cache
import geomesa_tpu.obs as j_obs
import geomesa_tpu.stats.serialize as j_serialize
from geomesa_tpu.features import FeatureBatch as JFeatureBatch
from geomesa_tpu.features import parse_spec as j_parse_spec
from geomesa_tpu.store.fs import FileSystemDataStore as JFs
from geomesa_tpu.store.live import LiveDataStore as JLive
from geomesa_tpu.store.memory import InMemoryDataStore as JStore
import geomesa_tpu_torch.audit as t_audit
import geomesa_tpu_torch.cache as t_cache
import geomesa_tpu_torch.obs as t_obs
import geomesa_tpu_torch.stats.serialize as t_serialize
from geomesa_tpu_torch.features import FeatureBatch as TFeatureBatch
from geomesa_tpu_torch.features import parse_spec as t_parse_spec
from geomesa_tpu_torch.filters import ast as t_ast
from geomesa_tpu_torch.store.fs import FileSystemDataStore as TFs
from geomesa_tpu_torch.store.live import LiveDataStore as TLive
from geomesa_tpu_torch.store.memory import InMemoryDataStore as TStore

pytestmark = pytest.mark.cache

J = types.SimpleNamespace(
    name="jax", cache=j_cache, audit=j_audit, obs=j_obs,
    serialize=j_serialize, FeatureBatch=JFeatureBatch,
    parse_spec=j_parse_spec, store=lambda **kw: JStore(**kw),
    live=lambda **kw: JLive(**kw), fs=lambda root: JFs(root))
T = types.SimpleNamespace(
    name="torch", cache=t_cache, audit=t_audit, obs=t_obs,
    serialize=t_serialize, FeatureBatch=TFeatureBatch,
    parse_spec=t_parse_spec, store=lambda **kw: TStore(device="cpu", **kw),
    live=lambda **kw: TLive(device="cpu", **kw),
    fs=lambda root: TFs(root, device="cpu"))
PKGS = (J, T)

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"
BB = (-100.0, 25.0, -60.0, 50.0)
WORLD = (-180.0, -90.0, 180.0, 90.0)


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    for P in PKGS:
        for prop in (P.cache.CACHE_ENABLED, P.cache.CACHE_MAX_BYTES,
                     P.cache.CACHE_REFRESH_INTERVAL_S):
            prop.thread_local_set(None)
            prop.set(None)
        P.obs.trace.TRACE_SAMPLE.set(None)
        P.obs.tracer.clear()


def make_batch(P, sft, i0, n, seed=7):
    rng = np.random.default_rng(seed + i0)
    return P.FeatureBatch.from_dict(
        sft, [f"p{i}" for i in range(i0, i0 + n)],
        {"name": [f"n{i % 7}" for i in range(i0, i0 + n)],
         "age": np.arange(i0, i0 + n),
         "dtg": rng.integers(0, 10**12, n),
         "geom": (rng.uniform(BB[0], BB[2], n),
                  rng.uniform(BB[1], BB[3], n))})


def make_store(P, n=200, type_name="pts", seed=7, **kw):
    sft = P.parse_spec(type_name, SPEC)
    ds = P.store(**kw)
    ds.create_schema(sft)
    ds.write(type_name, make_batch(P, sft, 0, n, seed))
    return ds, sft


def cache_off(P, off: bool = True):
    P.cache.CACHE_ENABLED.thread_local_set("false" if off else None)


def counters(ds) -> tuple:
    c = ds.result_cache
    return (c.hits, c.misses, c.evictions, c.singleflight_waits,
            c.refreshes, c.invalidations)


# -- keys ---------------------------------------------------------------------

ECQL_VARIANTS = [
    None, "INCLUDE", "include", "  INCLUDE  ", "EXCLUDE",
    "age   <  5 AND name = 'x'", "age < 5 and name = 'x'",
    "AGE < 5", "age < 5.0", "age < 5e0", "age<5", "age <= -0.25",
    "age BETWEEN 1 AND 9", "age between 1.0 and 9.00",
    "name IN ('a', 'b')", "name in ('a','b')", "name LIKE 'n%'",
    "name ILIKE 'N%'", "NOT (age > 3)", "not(age>3)", "age IS NULL",
    "age IS NOT NULL", "BBOX(geom, -80, 30, -60, 45)",
    "bbox(geom,-80.0,30.0,-60.0,45.0)",
    "BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
    "2016-08-07T00:00:00Z/2016-08-14T00:00:00Z",
    "dtg AFTER 2017-01-01T00:00:00Z", "dtg BEFORE 2017-01-01T00:00:00.000Z",
    "dtg BETWEEN 100 AND 200",
    "INTERSECTS(geom, POLYGON((0 0, 1 0, 1 1, 0 1, 0 0)))",
    "DWITHIN(geom, POINT(1 2), 10, kilometers)",
    "IN ('p1', 'p2')", "(age < 5 OR age > 50) AND name <> 'n1'",
]


@pytest.mark.parametrize("ecql", ECQL_VARIANTS)
def test_keys_equal_reference(ecql):
    """The four plan keys equal the JAX package's, string for string."""
    def keys(P):
        c = P.cache
        return (c.canonical_filter(ecql)[1],
                c.density_key(ecql, BB, 256, 128)[1],
                c.density_key(ecql, (0, 0.5, 1e-7, 3), 7, 9, "age")[1],
                c.stats_key(ecql, " MinMax(age) ")[1],
                c.bin_key(ecql, track="name", label="age", sort=True)[1],
                c.bin_key(ecql)[1],
                c.arrow_key(ecql, "age")[1], c.arrow_key(ecql)[1])
    want, got = both(keys)
    assert got == want


class TestKeys:
    def test_whitespace_and_case_variants_collapse(self):
        _, a = t_cache.canonical_filter("age   <  5 AND name = 'x'")
        _, b = t_cache.canonical_filter("age < 5 and name = 'x'")
        assert a == b

    def test_none_is_include(self):
        _, a = t_cache.canonical_filter(None)
        _, b = t_cache.canonical_filter("INCLUDE")
        assert a == b

    def test_distinct_plans_get_distinct_keys(self):
        _, k1 = t_cache.density_key("INCLUDE", BB, 256, 256)
        _, k2 = t_cache.density_key("INCLUDE", BB, 256, 128)
        _, k3 = t_cache.density_key("INCLUDE", (0, 0, 1, 1), 256, 256)
        _, k4 = t_cache.density_key("age < 5", BB, 256, 256)
        assert len({k1, k2, k3, k4}) == 4
        _, s1 = t_cache.stats_key(None, "Count()")
        _, s2 = t_cache.stats_key(None, "MinMax(age)")
        assert s1 != s2
        _, b1 = t_cache.bin_key(None, track="name")
        _, b2 = t_cache.bin_key(None, track="name", sort=True)
        assert b1 != b2

    def test_key_carries_the_parsed_ast(self):
        flt, _ = t_cache.density_key("age < 5", BB, 64, 64)
        assert isinstance(flt, t_ast.Filter)


# -- the store's caching wrappers ---------------------------------------------

def payloads(P, ds, ecql="age < 150"):
    """The four pushdowns' payloads as bytes-comparable values."""
    return (np.asarray(ds.density("pts", ecql, BB, 32, 32), np.float32),
            bytes(ds.bin_query("pts", "INCLUDE", track="name")),
            bytes(ds.arrow_ipc("pts", "INCLUDE")),
            P.serialize.serialize_stat(ds.stats_query("pts", "MinMax(age)")),
            P.serialize.serialize_stat(ds.stats_query(
                "pts", "Count();Enumeration(name)", "age >= 40")))


def _same_payloads(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and a[1:] == b[1:]


class TestStoreCaching:
    def test_density_hits_after_first_compute(self):
        def run(P):
            ds, _ = make_store(P)
            g1 = ds.density("pts", "INCLUDE", BB, 32, 32)
            h0 = ds.result_cache.hits
            g2 = ds.density("pts", "INCLUDE", BB, 32, 32)
            assert ds.result_cache.hits == h0 + 1
            assert g1.tobytes() == g2.tobytes()
            return g1, counters(ds)
        (gj, cj), (gt, ct) = both(run)
        assert np.array_equal(gt, gj) and ct == cj

    def test_hits_hand_out_private_copies(self):
        def run(P):
            ds, _ = make_store(P)
            ds.density("pts", "INCLUDE", BB, 16, 16)       # install
            g = ds.density("pts", "INCLUDE", BB, 16, 16)   # hit: a copy
            g[:] = -1.0
            again = ds.density("pts", "INCLUDE", BB, 16, 16)
            assert float(again.min()) >= 0.0
            return again
        gj, gt = both(run)
        assert np.array_equal(gt, gj)

    def test_stats_hits_decode_fresh_objects(self):
        def run(P):
            ds, _ = make_store(P)
            s1 = ds.stats_query("pts", "Count()")
            s2 = ds.stats_query("pts", "Count()")
            assert s1 is not s2
            assert s1.to_json() == s2.to_json()
            s1.observe(make_batch(P, ds.get_schema("pts"), 900, 5))
            return ds.stats_query("pts", "Count()").to_json()
        want, got = both(run)
        assert got == want

    def test_all_four_pushdowns_byte_exact_vs_fresh(self):
        def run(P):
            ds, _ = make_store(P)
            cached = payloads(P, ds)
            cached2 = payloads(P, ds)
            cache_off(P)
            try:
                fresh = payloads(P, ds)
            finally:
                cache_off(P, False)
            assert _same_payloads(cached, cached2)
            assert _same_payloads(cached, fresh)
            return cached, counters(ds)
        (pj, cj), (pt, ct) = both(run)
        assert _same_payloads(pt, pj) and ct == cj

    def test_payloads_across_writes_and_deletes(self):
        """Miss, hit; write, miss, hit; delete, miss, hit; remove and
        re-create: every payload equals the JAX store's, every hit its
        miss, and the counters move together."""
        def run(P):
            ds, sft = make_store(P)
            out = []

            def step():
                miss = payloads(P, ds)
                hit = payloads(P, ds)
                assert _same_payloads(miss, hit)
                out.append((miss, counters(ds)))
            step()
            ds.write("pts", make_batch(P, sft, 1000, 37))
            step()
            ds.delete("pts", [f"p{i}" for i in range(0, 1037, 3)])
            step()
            ds.delete("pts", ["p1001", "nope"])
            step()
            ds.remove_schema("pts")
            ds.create_schema(P.parse_spec("pts", SPEC))
            ds.write("pts", make_batch(P, ds.get_schema("pts"), 50, 80, 3))
            step()
            return out
        want, got = both(run)
        assert len(got) == len(want) == 5
        for (pg, cg), (pw, cw) in zip(got, want):
            assert _same_payloads(pg, pw)
            assert cg == cw

    def test_write_and_delete_advance_the_version(self, tmp_path):
        def run(P):
            ds, sft = make_store(P, durable_dir=str(tmp_path / P.name),
                                 wal_fsync="never")
            v0 = ds.pushdown_version("pts")
            assert v0 == ds.journal.wal.last_lsn
            ds.density("pts", "INCLUDE", BB, 16, 16)
            m0 = ds.result_cache.misses
            ds.write("pts", make_batch(P, sft, 1000, 3))
            assert ds.pushdown_version("pts") > v0
            ds.density("pts", "INCLUDE", BB, 16, 16)
            assert ds.result_cache.misses == m0 + 1
            v1 = ds.pushdown_version("pts")
            ds.delete("pts", ["p1000"])
            assert ds.pushdown_version("pts") > v1
            out = (v0, v1, ds.pushdown_version("pts"), counters(ds))
            ds.close()
            return out
        want, got = both(run)
        assert got == want

    def test_remove_schema_drops_entries(self):
        def run(P):
            ds, _ = make_store(P)
            ds.density("pts", "INCLUDE", BB, 16, 16)
            assert ds.result_cache.status()["types"].get("pts")
            ds.remove_schema("pts")
            assert "pts" not in ds.result_cache.status()["types"]
            return ds.cache_status()
        want, got = both(run)
        assert got == want

    def test_types_are_isolated(self):
        def run(P):
            ds, _ = make_store(P)
            sft2 = P.parse_spec("other", SPEC)
            ds.create_schema(sft2)
            ds.write("other", make_batch(P, sft2, 0, 50))
            ds.density("pts", "INCLUDE", BB, 16, 16)
            ds.density("other", "INCLUDE", BB, 16, 16)
            h0 = ds.result_cache.hits
            ds.write("other", make_batch(P, sft2, 500, 3))
            ds.density("pts", "INCLUDE", BB, 16, 16)
            assert ds.result_cache.hits == h0 + 1
            assert ds.invalidate_cache("other") == 1
            assert ds.result_cache.status()["types"].get("pts") == 1
            return ds.cache_status()
        want, got = both(run)
        assert got == want

    def test_lru_byte_budget_evicts(self):
        def run(P):
            ds, _ = make_store(P)
            # each 32x32 f32 grid is 4 KiB; the budget fits two
            P.cache.CACHE_MAX_BYTES.thread_local_set(str(9 * 1024))
            try:
                for i in range(4):
                    ds.density("pts", f"age < {100 + i}", BB, 32, 32)
                st = ds.result_cache.status()
                assert st["entries"] <= 2
                assert st["bytes"] <= 9 * 1024
                assert st["evictions"] >= 2
                # the two newest survive: the oldest key recomputes
                h0 = ds.result_cache.hits
                ds.density("pts", "age < 103", BB, 32, 32)
                ds.density("pts", "age < 100", BB, 32, 32)
                assert ds.result_cache.hits == h0 + 1
                return ds.cache_status()
            finally:
                P.cache.CACHE_MAX_BYTES.thread_local_set(None)
        want, got = both(run)
        assert got == want

    def test_oversize_payload_is_served_not_kept(self):
        def run(P):
            ds, _ = make_store(P)
            P.cache.CACHE_MAX_BYTES.thread_local_set("1000")
            try:
                g = ds.density("pts", "INCLUDE", BB, 32, 32)
                return g, ds.cache_status()
            finally:
                P.cache.CACHE_MAX_BYTES.thread_local_set(None)
        (gj, sj), (gt, st) = both(run)
        assert np.array_equal(gt, gj) and st == sj
        assert st["entries"] == 0

    def test_kill_switch_disables_memoization(self):
        def run(P):
            ds, _ = make_store(P)
            cache_off(P)
            try:
                ds.density("pts", "INCLUDE", BB, 16, 16)
                ds.density("pts", "INCLUDE", BB, 16, 16)
                st = ds.result_cache.status()
                assert st["entries"] == 0 and st["hits"] == 0
                return st
            finally:
                cache_off(P, False)
        want, got = both(run)
        assert got == want

    def test_kill_switch_is_per_thread(self):
        """Off for one thread only: another thread's calls still
        memoize (config 12's exactness gate turns it off this way)."""
        def run(P):
            ds, _ = make_store(P)
            cache_off(P)
            try:
                ds.density("pts", "INCLUDE", BB, 16, 16)
                t = threading.Thread(target=lambda: [ds.density(
                    "pts", "INCLUDE", BB, 16, 16) for _ in range(2)])
                t.start()
                t.join(30)
                assert not t.is_alive()
            finally:
                cache_off(P, False)
            return counters(ds)
        want, got = both(run)
        assert got == want and got[:2] == (1, 1)


@pytest.mark.parametrize("durable", [False, True])
def test_pushdown_versions_equal_reference(tmp_path, durable):
    """The per-type version sequence through create, write, delete,
    remove, a second type, a failed delete and (durable) a reopen equals
    the JAX store's, and so does ``cache_status()`` after it."""
    def run(P):
        kw = ({"durable_dir": str(tmp_path / P.name), "wal_fsync": "never"}
              if durable else {})
        ds = P.store(**kw)
        seq = []

        def note():
            seq.append({tn: ds.pushdown_version(tn)
                        for tn in ("pts", "other", "gone")})
        sft = P.parse_spec("pts", SPEC)
        ds.create_schema(sft)
        note()
        ds.write("pts", make_batch(P, sft, 0, 40))
        note()
        ds.density("pts", "INCLUDE", BB, 8, 8)
        ds.stats_query("pts", "Count()")
        ds.write("pts", make_batch(P, sft, 40, 10))
        note()
        ds.delete("pts", ["p3", "p4"])
        note()
        other = P.parse_spec("other", SPEC)
        ds.create_schema(other)
        ds.write("other", make_batch(P, other, 0, 5))
        note()
        with pytest.raises(KeyError):
            ds.delete("missing", ["p1"])
        ds.remove_schema("gone")
        note()
        ds.density("pts", "INCLUDE", BB, 8, 8)
        ds.bin_query("pts", "age > 10")
        ds.remove_schema("other")
        note()
        status = ds.cache_status()
        if durable:
            ds.close()
            ds = P.store(**kw)
            note()
            ds.density("pts", "INCLUDE", BB, 8, 8)
            ds.density("pts", "INCLUDE", BB, 8, 8)
            ds.write("pts", make_batch(P, sft, 90, 2))
            note()
            status = (status, ds.cache_status())
            ds.close()
        return seq, status
    want, got = both(run)
    assert got == want
    if durable:
        # the version is the WAL LSN: it never moves back across a reopen
        last = [s["pts"] for s in got[0]]
        assert last == sorted(last)


# -- single flight ------------------------------------------------------------

class TestSingleFlight:
    def test_concurrent_misses_compute_once(self):
        def run(P):
            computed = []
            release = threading.Event()

            def compute():
                computed.append(1)
                release.wait(5.0)
                return b"payload"

            cache = P.cache.ResultCache(lambda tn: 1)
            results = [None] * 6

            def go(i):
                results[i] = cache.get_or_compute("t", "k", compute)

            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 5
            while cache.singleflight_waits < 5 and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            release.set()
            for t in threads:
                t.join(timeout=5)
            assert len(computed) == 1
            assert all(r == b"payload" for r in results)
            return cache.status()
        want, got = both(run)
        assert got == want and got["singleflight_waits"] == 5

    def test_leader_error_propagates_and_clears_flight(self):
        def run(P):
            cache = P.cache.ResultCache(lambda tn: 1)

            def boom():
                raise RuntimeError("device fell over")

            with pytest.raises(RuntimeError):
                cache.get_or_compute("t", "k", boom)
            assert cache.get_or_compute("t", "k", lambda: b"ok") == b"ok"
            return cache.status()
        want, got = both(run)
        assert got == want

    def test_mid_compute_write_never_serves_stale(self):
        def run(P):
            version = [1]
            cache = P.cache.ResultCache(lambda tn: version[0])

            def compute():
                version[0] += 1   # a write lands while we compute
                return b"old-state"

            assert cache.get_or_compute("t", "k", compute) == b"old-state"
            assert cache.get_or_compute("t", "k", lambda: b"new") == b"new"
            return cache.status()
        want, got = both(run)
        assert got == want

    def test_store_herd_computes_once_outside_the_lock(self):
        """8 threads ask one cold tile: one ``_density_uncached`` runs,
        7 followers wait on its flight (never on the store's lock), and
        every caller gets the grid."""
        def run(P):
            ds, _ = make_store(P, n=500)
            calls, gate = [], threading.Event()
            real = ds._density_uncached

            def gated(*a, **k):
                calls.append(1)
                gate.wait(10.0)
                return real(*a, **k)
            ds._density_uncached = gated
            out = [None] * 8
            barrier = threading.Barrier(8)

            def go(i):
                barrier.wait(10.0)
                out[i] = ds.density("pts", "INCLUDE", WORLD, 24, 12)
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 10
            while ds.result_cache.singleflight_waits < 7 and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            # the leader is parked inside its compute: the followers are
            # waiting on its flight, not on the store's lock
            assert ds._op_lock.acquire(timeout=5.0)
            ds._op_lock.release()
            gate.set()
            for t in threads:
                t.join(10.0)
            assert not any(t.is_alive() for t in threads)
            assert len(calls) == 1
            for g in out[1:]:
                assert g.tobytes() == out[0].tobytes() and g is not out[0]
            return out[0], counters(ds)
        (gj, cj), (gt, ct) = both(run)
        assert np.array_equal(gt, gj) and ct == cj
        assert ct[1] == 1 and ct[3] == 7


class TestInvalidationRace:
    def test_reader_never_older_than_current_version_memory(self):
        """A writer advances the version while readers hammer one tile;
        every grid's mass lies between the row counts before and after
        its request."""
        ds, sft = make_store(T, n=50)
        stop = threading.Event()
        errors = []

        def writer():
            i = 0
            while not stop.is_set() and i < 30:
                ds.write("pts", make_batch(T, sft, 1000 + i, 1))
                i += 1
                time.sleep(0.002)

        def reader():
            while not stop.is_set():
                before = ds.count("pts")
                g = ds.density("pts", "INCLUDE", WORLD, 8, 8)
                after = ds.count("pts")
                mass = int(round(float(np.sum(g))))
                if not (before - 1 <= mass <= after + 1):
                    errors.append((before, mass, after))

        w = threading.Thread(target=writer)
        rs = [threading.Thread(target=reader) for _ in range(3)]
        w.start()
        for r in rs:
            r.start()
        w.join(60)
        stop.set()
        for r in rs:
            r.join(60)
        assert not w.is_alive() and not any(r.is_alive() for r in rs)
        assert not errors, errors[:3]
        assert ds.count("pts") == 80


# -- the refresher ------------------------------------------------------------

class TestRefresher:
    def test_run_once_rematerializes_hot_stale_entries(self):
        def run(P):
            ds, sft = make_store(P)
            for _ in range(5):
                ds.density("pts", "INCLUDE", BB, 16, 16)
            ds.density("pts", "age < 9", BB, 16, 16)
            ds.write("pts", make_batch(P, sft, 2000, 2))   # stale now
            r = P.cache.CacheRefresher(ds, interval_s=0, top_k=4)
            out = r.run_once()
            assert out["refreshed"] >= 1
            m0 = ds.result_cache.misses
            g = ds.density("pts", "INCLUDE", BB, 16, 16)   # already fresh
            assert ds.result_cache.misses == m0
            assert r.status()["running"] is False
            st = r.status()
            st.pop("last_seconds")
            return out["refreshed"], st, g, counters(ds)
        want, got = both(run)
        assert got[:2] == want[:2] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])

    def test_fresh_entries_are_skipped(self):
        def run(P):
            ds, _ = make_store(P)
            ds.density("pts", "INCLUDE", BB, 16, 16)
            return P.cache.CacheRefresher(ds, interval_s=0).run_once()[
                "refreshed"]
        assert both(run) == (0, 0)

    def test_dropped_schema_is_reclaimed(self):
        def run(P):
            ds, sft = make_store(P)
            other = P.parse_spec("other", SPEC)
            ds.create_schema(other)
            ds.write("other", make_batch(P, other, 0, 20))
            ds.density("other", "INCLUDE", BB, 16, 16)
            ds._types.pop("other")     # gone under the cache's feet
            ds._bump_pushdown_version("other")
            n = ds.result_cache.refresh_hot(4)
            return n, ds.cache_status()
        want, got = both(run)
        assert got == want and got[1]["entries"] == 0

    def test_background_loop_starts_and_stops(self):
        ds, sft = make_store(T)
        ds.density("pts", "INCLUDE", BB, 16, 16)
        r = t_cache.CacheRefresher(ds, interval_s=0.02, top_k=4).start()
        try:
            assert r.status()["running"] is True
            ds.write("pts", make_batch(T, sft, 3000, 2))
            deadline = time.monotonic() + 5
            while r.runs == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert r.runs >= 1
        finally:
            r.stop()
        assert r.status()["running"] is False

    def test_refresher_requires_a_cache(self):
        with pytest.raises(ValueError):
            t_cache.CacheRefresher(object())

    def test_property_cadence(self):
        t_cache.CACHE_REFRESH_INTERVAL_S.thread_local_set("0.05")
        try:
            ds, _ = make_store(T)
            r = t_cache.CacheRefresher(ds)
        finally:
            t_cache.CACHE_REFRESH_INTERVAL_S.thread_local_set(None)
        assert (r.interval_s, r.top_k) == (0.05, 8)
        assert t_cache.CacheRefresher(ds).interval_s == 0.0


# -- audit records and spans of cached calls ----------------------------------

def _fields(e):
    d = dataclasses.asdict(e)
    d["trace_id"] = d["trace_id"] is not None
    for k in ("date_ms", "plan_time_ms", "scan_time_ms"):
        assert d.pop(k) >= 0
    return d


def test_cached_calls_audit_and_spans_equal_reference():
    """A miss writes the records and spans of the query it runs (one
    store-scan span and one audit record for density, as the JAX store's
    query() does); a hit writes none. Equal to the JAX store's, call by
    call."""
    calls = [
        lambda ds: ds.density("pts", "age < 120", BB, 16, 16),
        lambda ds: ds.bin_query("pts", "age > 20", track="name"),
        lambda ds: ds.stats_query("pts", "Count()", "age > 20"),
        lambda ds: ds.stats_query("pts", "Count()"),
        lambda ds: ds.arrow_ipc("pts", "BBOX(geom, -90, 30, -70, 45)"),
    ]

    def run(P):
        P.obs.trace.TRACE_SAMPLE.set("1")
        log = P.audit.AuditLogger()
        ds, _ = make_store(P, audit=log)
        out = []
        for call in calls:
            for _ in range(2):      # a miss, then a hit
                n0 = len(log.query())
                P.obs.tracer.clear()
                with P.obs.tracer.span("request", "pushdown", root=True):
                    call(ds)
                kinds = sorted(k for t in P.obs.tracer.traces()
                               for k in t["kinds"])
                out.append(([_fields(e) for e in log.query()[n0:]], kinds))
        return out
    want, got = both(run)
    assert got == want
    assert [len(ev) for ev, _ in got] == [1, 0, 1, 0, 1, 0, 0, 0, 1, 0]
    assert got[0][1] == ["request", "store-scan"]
    assert got[1][1] == ["request"]


# -- stores that wrap an in-memory store --------------------------------------

def test_live_store_reaches_the_cache_through_its_memory_store():
    def run(P):
        live = P.live()
        sft = P.parse_spec("pts", SPEC)
        live.create_schema(sft)
        live.write("pts", make_batch(P, sft, 0, 60))
        a = live.bin_query("pts", "age > 10", track="name")
        b = live.bin_query("pts", "age > 10", track="name")
        assert a == b
        live.write("pts", make_batch(P, sft, 100, 5))
        c = live.bin_query("pts", "age > 10", track="name")
        return a, c, counters(live._mem)
    want, got = both(run)
    assert got == want and got[2][:2] == (1, 2)


def test_file_store_reaches_the_cache_through_its_loads(tmp_path):
    def run(P):
        fs = P.fs(str(tmp_path / P.name))
        sft = P.parse_spec("pts", SPEC)
        fs.create_schema(sft)
        fs.write("pts", make_batch(P, sft, 0, 80))
        a = fs.bin_query("pts", "age > 10", track="name")
        b = fs.bin_query("pts", "age > 10", track="name")
        st = fs._state("pts")
        mem = fs._load(st, fs._files_for(st, None))
        return a == b, counters(mem)
    want, got = both(run)
    assert got == want and got[1][:2] == (1, 1)
