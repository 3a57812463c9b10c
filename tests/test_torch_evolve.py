"""The port's online schema evolution (``geomesa_tpu_torch.evolve``)
against the JAX package's on the CPU.

Every class of ``tests/test_evolve.py`` but the CLI's runs here: each
scenario runs in both packages (``both(fn)``) on stores built from the
same numpy seed (the port's on ``device="cpu"``), keeps the reference
test's own assertions, and returns its outcome: canonical rows (ids and
every attribute's value as text), schemas and ``index_version``, the
evolver's ``status()`` and ``history`` with times left out, and error
types by name. The two outcomes must be equal; no comparison here has a
tolerance. Cross-package cases reopen an evolved durable directory in
the other package, both ways.

The ``gpu`` test at the end runs an online reindex of a CUDA store
under reader threads (``python -m pytest --noconftest -m gpu
tests/test_torch_evolve.py``)."""

import importlib
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"
TIMES = {"ts_ms", "flip_ms", "started_ms"}


def _ns(pkg, cpu):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    evolve = m("evolve")
    store = m("store.memory").InMemoryDataStore

    def make(**kw):
        if cpu:
            kw.setdefault("device", "cpu")
        return store(**kw)

    return types.SimpleNamespace(
        pkg=pkg, m=m, store=make, Evolver=evolve.Evolver,
        SchemaEvolutionError=evolve.SchemaEvolutionError,
        EVOLVE_ENABLED=evolve.EVOLVE_ENABLED,
        FeatureBatch=m("features").FeatureBatch,
        parse_spec=m("features").parse_spec)


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


@pytest.fixture
def evolve_on():
    for P in PKGS:
        P.EVOLVE_ENABLED.set("true")
    yield
    for P in PKGS:
        P.EVOLVE_ENABLED.set(None)


def make_batch(P, sft, ids, rng=None, name=None):
    rng = rng or np.random.default_rng(7)
    n = len(ids)
    cols = {
        "name": np.array([name if name is not None else f"n{i % 5}"
                          for i in range(n)], dtype=object),
        "age": np.arange(n, dtype=np.int64),
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))}
    if "score" in [a.name for a in sft.attributes]:
        cols["score"] = np.full(n, 0.75)    # an evolved schema's column
    return P.FeatureBatch.from_dict(sft, np.array(ids, dtype=object), cols)


def make_store(P, n=120, durable_dir=None):
    sft = P.parse_spec("t", SPEC)
    ds = (P.store(durable_dir=str(durable_dir), wal_fsync="never")
          if durable_dir is not None else P.store())
    ds.create_schema(sft)
    ds.write("t", make_batch(P, sft, [f"f{i}" for i in range(n)]))
    return ds, sft


def snap(ds, tn="t"):
    """Canonical content: sorted (id, attr=value...) rows."""
    res = ds.query("INCLUDE", tn)
    b = res.batch
    sft = ds.get_schema(tn)
    rows = []
    for i in range(b.n):
        rows.append((str(b.ids[i]),)
                    + tuple(f"{a.name}={b.col(a.name).value(i)}"
                            for a in sft.attributes))
    return sorted(rows)


def timeless(obj):
    if isinstance(obj, dict):
        return {k: timeless(v) for k, v in obj.items() if k not in TIMES}
    if isinstance(obj, (list, tuple)):
        return [timeless(v) for v in obj]
    return obj


def outcome(ds, tn="t"):
    """Rows, schema and the evolver's state with times left out."""
    st = ds.evolver.status()
    return {"rows": snap(ds, tn), "spec": ds.get_schema(tn).to_spec(),
            "version": ds.get_schema(tn).index_version,
            "status": timeless(st), "history": timeless(ds.evolver.history)}


def raised(fn) -> str | None:
    """The name of the error ``fn()`` raises, with its text (None: no
    error)."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the error is the outcome
        return f"{type(e).__name__}: {e}"
    return None


def other_version(ds):
    return 1 if ds.get_schema("t").index_version != 1 else 2


def _crash_at(evolver, tag):
    def hook(t):
        if t == tag:
            raise RuntimeError(f"injected crash @ {t}")
    evolver.fault_hook = hook


def test_exports_equal_reference():
    j = importlib.import_module("geomesa_tpu.evolve")
    t = importlib.import_module("geomesa_tpu_torch.evolve")
    assert j.__all__ == t.__all__
    assert j.Evolver.PHASES == t.Evolver.PHASES
    for name in ("EVOLVE_ENABLED", "EVOLVE_CATCHUP_ROUNDS",
                 "EVOLVE_CATCHUP_SETTLE", "EVOLVE_GATE_TIMEOUT_S"):
        assert getattr(j, name).name == getattr(t, name).name
        assert getattr(j, name).default == getattr(t, name).default


# -- kill switch ------------------------------------------------------------

@needs_jax
class TestKillSwitch:
    def test_disabled_refuses_every_verb(self):
        def run(P):
            ds, _ = make_store(P, 10)
            ev = ds.evolver
            out = [raised(lambda: ev.reindex("t", 1)),
                   raised(lambda: ev.update_schema(
                       "t", [{"op": "drop", "name": "name"}])),
                   raised(ev.resume), raised(ev.abort)]
            assert "disabled" in out[0] and "disabled" in out[1]
            assert all(o.startswith("SchemaEvolutionError") for o in out)
            assert ev.status()["enabled"] is False
            assert ev.status()["active"] is None
            return out, outcome(ds)
        j, t = both(run)
        assert t == j

    def test_off_bit_identical_to_untouched_store(self):
        def run(P):
            ds, sft = make_store(P, 60)
            twin = P.store()
            twin.create_schema(sft)
            twin.write("t", make_batch(P, sft, [f"f{i}" for i in range(60)]))
            err = raised(lambda: ds.evolver.reindex("t", 1))
            assert err.startswith("SchemaEvolutionError")
            assert ds._evolve_feeds == {}
            assert ds.get_schema("t").index_version \
                == twin.get_schema("t").index_version
            assert snap(ds) == snap(twin)
            # the write path after the refusal: the same rows as the twin
            more = make_batch(P, sft, ["g1", "g2"])
            ds.write("t", more)
            twin.write("t", more)
            ds.delete("t", ["f3"])
            twin.delete("t", ["f3"])
            assert snap(ds) == snap(twin)
            assert ds.pushdown_version("t") == twin.pushdown_version("t")
            return err, snap(ds), str(ds.query("age < 5", "t").ids.tolist())
        j, t = both(run)
        assert t == j


# -- update_schema validation + transforms ----------------------------------

@needs_jax
class TestUpdateSchema:
    def test_add_with_default_backfill(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 40)
            entry = ds.evolver.update_schema("t", [
                {"op": "add", "name": "score", "type": "Double",
                 "default": 1.5}])
            assert entry["op"] == "update"
            assert entry["changes"]["adds"] == ["score"]
            sft = ds.get_schema("t")
            assert [a.name for a in sft.attributes][-1] == "score"
            b = ds.query("INCLUDE", "t").batch
            assert b.n == 40
            assert all(b.col("score").value(i) == 1.5 for i in range(40))
            return timeless(entry), outcome(ds)
        j, t = both(run)
        assert t == j

    def test_add_null_backfill(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 10)
            ds.evolver.update_schema("t", [
                {"op": "add", "name": "tag", "type": "String"}])
            b = ds.query("INCLUDE", "t").batch
            assert all(b.col("tag").value(i) is None for i in range(10))
            return outcome(ds)
        j, t = both(run)
        assert t == j

    def test_widen_preserves_values(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 25)
            before = [r[0] for r in snap(ds)]
            ds.evolver.update_schema("t", [
                {"op": "widen", "name": "age", "type": "Long"}])
            sft = ds.get_schema("t")
            assert {a.name: a.type.name for a in sft.attributes}["age"] \
                == "Long"
            b = ds.query("INCLUDE", "t").batch
            got = {str(b.ids[i]): b.col("age").value(i) for i in range(b.n)}
            assert sorted(got) == before
            assert got["f7"] == 7
            return outcome(ds), str(b.col("age").values.dtype)
        j, t = both(run)
        assert t == j

    def test_drop_removes_attribute_only(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 30)
            before = {r[0]: r for r in
                      ((s[0],) + s[2:] for s in snap(ds))}  # minus name
            ds.evolver.update_schema("t", [{"op": "drop", "name": "name"}])
            sft = ds.get_schema("t")
            assert "name" not in [a.name for a in sft.attributes]
            after = {r[0]: r for r in snap(ds)}
            assert after == before
            return outcome(ds)
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("changes,msg", [
        ([], "non-empty"),
        ([{"op": "nope", "name": "x"}], "unknown change op"),
        ([{"op": "add", "name": "age"}], "already exists"),
        ([{"op": "add", "name": "g2", "type": "Point"}],
         "cannot backfill"),
        ([{"op": "add", "name": "l", "type": "List[Integer]"}],
         "cannot backfill"),
        ([{"op": "widen", "name": "name", "type": "Double"}],
         "cannot widen"),
        ([{"op": "widen", "name": "age", "type": "Integer"}],
         "cannot widen"),
        ([{"op": "widen", "name": "ghost", "type": "Long"}],
         "no attribute"),
        ([{"op": "drop", "name": "geom"}], "default geometry"),
        ([{"op": "drop", "name": "ghost"}], "no attribute"),
        ([{"op": "add", "name": "x", "type": "Integer"},
          {"op": "drop", "name": "x"}], "changed and dropped"),
        ([{"op": "drop"}], "needs a 'name'"),
        (["drop name"], "expected a mapping"),
    ])
    def test_validation_refuses_typed(self, evolve_on, changes, msg):
        def run(P):
            ds, _ = make_store(P, 5)
            before = snap(ds)
            err = raised(lambda: ds.evolver.update_schema("t", changes))
            assert err.startswith("SchemaEvolutionError") and msg in err
            assert snap(ds) == before       # nothing half-applied
            return err, outcome(ds)
        j, t = both(run)
        assert t == j

    def test_reindex_noop_and_bad_targets(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 5)
            cur = ds.get_schema("t").index_version
            noop = ds.evolver.reindex("t", cur)
            assert noop["noop"] is True
            bad = raised(lambda: ds.evolver.reindex("t", 99))
            ghost = raised(lambda: ds.evolver.reindex("ghost", 1))
            assert bad.startswith("ValueError")
            assert ghost.startswith("KeyError")
            return noop, bad, ghost, outcome(ds)
        j, t = both(run)
        assert t == j


# -- online reindex + dual feed ---------------------------------------------

@needs_jax
class TestOnlineReindex:
    def test_reindex_both_flavors(self, evolve_on, tmp_path):
        def run(P):
            out = []
            for ds, _ in (make_store(P, 80),
                          make_store(P, 80,
                                     durable_dir=tmp_path / P.pkg / "w")):
                before = snap(ds)
                v = other_version(ds)
                entry = ds.evolver.reindex("t", v)
                assert entry["to_version"] == v
                assert entry["rows"] == 80
                assert ds.get_schema("t").index_version == v
                assert snap(ds) == before   # same data, new layout
                out.append((timeless(entry), outcome(ds)))
                ds.close()
            return out
        j, t = both(run)
        assert t == j

    def test_durable_reindex_survives_reopen(self, evolve_on, tmp_path):
        def run(P):
            root = tmp_path / P.pkg / "w"
            ds, _ = make_store(P, 50, durable_dir=root)
            v = other_version(ds)
            ds.evolver.reindex("t", v)
            before = snap(ds)
            ds.close()
            re = P.store(durable_dir=str(root), wal_fsync="never")
            assert re.get_schema("t").index_version == v
            assert snap(re) == before
            out = outcome(re)
            re.close()
            return out
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("durable", [False, True])
    def test_dual_feed_catches_mid_build_mutations(self, evolve_on,
                                                   tmp_path, durable):
        def run(P):
            ds, sft = make_store(
                P, 60,
                durable_dir=(tmp_path / P.pkg / "w") if durable else None)
            fed = {}

            def hook(tag):
                # a write and a delete after catch-up settled, before the
                # flip: the final barrier replay must carry both
                if tag == "catchup.done" and not fed:
                    fed["done"] = True
                    ds.write("t", make_batch(P, sft, ["late1", "late2"]))
                    ds.delete("t", ["f3"])

            ds.evolver.fault_hook = hook
            entry = ds.evolver.reindex("t", other_version(ds))
            ds.evolver.fault_hook = None
            assert entry["rows"] == 60 + 2 - 1
            ids = set(ds.query("INCLUDE", "t").ids.tolist())
            assert {"late1", "late2"} <= ids and "f3" not in ids
            out = timeless(entry), outcome(ds)
            ds.close()
            return out
        j, t = both(run)
        assert t == j

    def test_mid_drop_write_conflict_typed(self, evolve_on):
        def run(P):
            ds, sft = make_store(P, 30)
            seen = {}

            def hook(tag):
                if tag != "catchup.done" or seen:
                    return
                seen["done"] = True
                try:
                    ds.write("t", make_batch(P, sft, ["bad1"], name="boom"))
                except P.SchemaEvolutionError as e:
                    seen["refused"] = str(e)
                b = make_batch(P, sft, ["ok1"])
                b.columns["name"] = type(b.columns["name"])(
                    "name", np.full(1, -1, np.int32),
                    np.empty(0, dtype=object))
                ds.write("t", b)

            ds.evolver.fault_hook = hook
            ds.evolver.update_schema("t", [{"op": "drop", "name": "name"}])
            ds.evolver.fault_hook = None
            assert "dropped" in seen["refused"]
            ids = set(ds.query("INCLUDE", "t").ids.tolist())
            assert "ok1" in ids and "bad1" not in ids
            return seen["refused"], outcome(ds)
        j, t = both(run)
        assert t == j

    def test_concurrent_readers_exact_or_typed(self, evolve_on, tmp_path):
        def run(P):
            ds, sft = make_store(P, 300, durable_dir=tmp_path / P.pkg / "w")
            expected = set(ds.query("name = 'n2'", "t").ids.tolist())
            stop = threading.Event()
            errs = {"mismatch": 0, "typed": 0, "other": 0}

            def reader():
                while not stop.is_set():
                    try:
                        got = set(ds.query("name = 'n2'", "t").ids.tolist())
                    except P.SchemaEvolutionError:
                        errs["typed"] += 1
                        continue
                    except Exception:   # noqa: BLE001 - counted
                        errs["other"] += 1
                        continue
                    if got != expected:
                        errs["mismatch"] += 1

            threads = [threading.Thread(target=reader, daemon=True)
                       for _ in range(4)]
            for th in threads:
                th.start()
            ds.evolver.reindex("t", other_version(ds))
            stop.set()
            for th in threads:
                th.join(timeout=30)
            assert errs["mismatch"] == 0 and errs["other"] == 0
            out = outcome(ds), sorted(expected)
            ds.close()
            return out
        j, t = both(run)
        assert t == j

    def test_verb_exclusion_while_in_flight(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 20)
            ev = ds.evolver

            def hook(tag):
                if tag == "snapshot.done":
                    raise RuntimeError("injected crash @ snapshot.done")

            ev.fault_hook = hook
            crash = raised(lambda: ev.reindex("t", other_version(ds)))
            assert "injected" in crash
            ev.fault_hook = None
            mid = timeless(ev.status())
            second = raised(lambda: ev.update_schema(
                "t", [{"op": "drop", "name": "name"}]))
            assert "in flight" in second
            ev.resume()
            assert ev._active is None
            return crash, mid, second, outcome(ds)
        j, t = both(run)
        assert t == j

    def test_old_schema_batch_refused_after_flip(self, evolve_on):
        """A writer's batch built on the schema before a reindex compares
        unequal to the evolved schema (its index version differs) and
        is refused with ValueError before the journal, as the
        reference's; a batch on the re-read schema is written."""
        def run(P):
            ds, sft = make_store(P, 20)
            old = ds.get_schema("t")
            ds.evolver.reindex("t", other_version(ds))
            assert old != ds.get_schema("t")
            err = raised(lambda: ds.write(
                "t", make_batch(P, old, ["stale1"])))
            assert err.startswith("ValueError")
            ds.write("t", make_batch(P, ds.get_schema("t"), ["fresh1"]))
            return err, outcome(ds)
        j, t = both(run)
        assert t == j


# -- crash safety: every named kill point -----------------------------------

@needs_jax
class TestCrashSafety:
    @pytest.mark.parametrize("tag", T.Evolver.PHASES)
    def test_kill_point_then_resume(self, evolve_on, tag):
        def run(P):
            ds, _ = make_store(P, 50)
            before = snap(ds)
            ev = ds.evolver
            _crash_at(ev, tag)
            crash = raised(lambda: ev.update_schema("t", [
                {"op": "add", "name": "score", "type": "Double",
                 "default": 2.0}]))
            assert "injected crash" in crash
            evo = ev._active
            assert evo is not None
            mid = timeless(ev.status())
            fenced = None
            if evo.phase == "done":
                pass                        # flip landed; bookkeeping left
            elif evo.blocking:
                fenced = raised(lambda: ds.query("INCLUDE", "t"))
                assert fenced.startswith("SchemaEvolutionError")
            else:
                assert snap(ds) == before
            ev.fault_hook = None
            entry = ev.resume()
            assert entry["op"] == "update"
            assert ev._active is None
            b = ds.query("INCLUDE", "t").batch
            assert b.n == 50
            assert all(b.col("score").value(i) == 2.0 for i in range(50))
            assert len([h for h in ev.history if h["op"] == "update"]) == 1
            return crash, mid, fenced, timeless(entry), outcome(ds)
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("tag", T.Evolver.PHASES)
    def test_durable_kill_point_resume_reopen(self, evolve_on, tmp_path,
                                              tag):
        def run(P):
            root = tmp_path / P.pkg / tag
            ds, _ = make_store(P, 40, durable_dir=root)
            v = other_version(ds)
            ev = ds.evolver
            _crash_at(ev, tag)
            crash = raised(lambda: ev.reindex("t", v))
            assert "injected crash" in crash
            ev.fault_hook = None
            ev.resume()
            assert ds.get_schema("t").index_version == v
            before = snap(ds)
            live = outcome(ds)
            ds.close()
            re = P.store(durable_dir=str(root), wal_fsync="never")
            assert re.get_schema("t").index_version == v
            assert snap(re) == before
            out = crash, live, snap(re), re.get_schema("t").to_spec()
            re.close()
            return out
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("tag", ["feed.installed", "catchup.done",
                                     "flip.barrier", "flip.swap"])
    def test_kill_point_then_abort(self, evolve_on, tag):
        def run(P):
            ds, _ = make_store(P, 35)
            before = snap(ds)
            old_v = ds.get_schema("t").index_version
            ev = ds.evolver
            _crash_at(ev, tag)
            crash = raised(lambda: ev.reindex("t", 1 if old_v != 1 else 2))
            ev.fault_hook = None
            evo = ev._active
            entry = ev.abort()
            assert entry["op"] == "abort"
            assert ev._active is None
            assert ds._evolve_feeds == {}
            assert evo.phase == "aborted"
            assert ds.get_schema("t").index_version == old_v
            assert snap(ds) == before       # pre-evolve state restored
            aborted = outcome(ds)
            ev.reindex("t", 1 if old_v != 1 else 2)
            assert snap(ds) == before
            return crash, timeless(entry), aborted, outcome(ds)
        j, t = both(run)
        assert t == j

    def test_abort_after_flip_refuses(self, evolve_on):
        def run(P):
            ds, _ = make_store(P, 10)
            ev = ds.evolver
            _crash_at(ev, "flip.done")
            crash = raised(lambda: ev.reindex("t", other_version(ds)))
            ev.fault_hook = None
            refused = raised(ev.abort)
            assert "already flipped" in refused
            ev.resume()                      # bookkeeping-only close-out
            assert ev._active is None
            return crash, refused, outcome(ds)
        j, t = both(run)
        assert t == j

    @pytest.mark.slow
    def test_randomized_kill_point_soak(self, evolve_on, tmp_path):
        """Crash at a random kill point, randomly resume or abort,
        interleave acked writes, repeat: after every round the contents
        match the oracle, and both packages take the same path."""
        def run(P):
            rng = np.random.default_rng(11)
            ds, sft = make_store(P, 100, durable_dir=tmp_path / P.pkg / "s")
            oracle = {r[0]: r for r in snap(ds)}
            ev = ds.evolver
            trail = []
            for round_no in range(10):
                tag = P.Evolver.PHASES[rng.integers(len(P.Evolver.PHASES))]
                cur = ds.get_schema("t").index_version
                _crash_at(ev, tag)
                crashed = raised(lambda: ev.reindex(
                    "t", 1 if cur != 1 else 2)) is not None
                ev.fault_hook = None
                verb = None
                if crashed and ev._active is not None:
                    verb = "resume" if rng.random() < 0.5 else "abort"
                    getattr(ev, verb)()
                assert {r[0] for r in snap(ds)} == set(oracle)
                wid = f"soak{round_no}"
                ds.write("t", make_batch(P, ds.get_schema("t"), [wid],
                                         name="soak"))
                oracle[wid] = None
                trail.append((tag, crashed, verb,
                              ds.get_schema("t").index_version))
            assert {r[0] for r in snap(ds)} == set(oracle)
            out = trail, outcome(ds)
            ds.close()
            return out
        j, t = both(run)
        assert t == j


def test_abort_frees_the_shadow_and_flip_frees_the_old_state(evolve_on):
    """The port drops its references to the copy that loses: after an
    abort the evolution holds no shadow; after a flip that crashed at
    its last kill point the live evolution no longer anchors the
    superseded state (nothing can un-swap a done evolution)."""
    import gc
    import weakref
    ds, _ = make_store(T, 40)
    ev = ds.evolver
    _crash_at(ev, "catchup.done")
    assert raised(lambda: ev.reindex("t", other_version(ds)))
    shadow = weakref.ref(ev._active.shadow)
    evo = ev._active
    ev.fault_hook = None
    ev.abort()
    gc.collect()
    assert evo.shadow is None and shadow() is None
    old = weakref.ref(ds._types["t"])
    _crash_at(ev, "flip.done")
    assert raised(lambda: ev.reindex("t", other_version(ds)))
    ev.fault_hook = None
    assert ev._active.phase == "done" and ev._active.old_state is None
    gc.collect()
    assert old() is None
    ev.resume()
    assert ev._active is None


def test_shadow_on_the_store_device(evolve_on):
    """The shadow is built by the store's ``_new_state`` on the store's
    own device (a CPU store shadows on the CPU)."""
    ds, _ = make_store(T, 30)
    seen = {}

    def hook(tag):
        if tag == "catchup.done":
            evo = ds.evolver._active
            seen["device"] = evo.shadow.device
            seen["cols"] = evo.shadow.scan_data.xhi.device
    ds.evolver.fault_hook = hook
    ds.evolver.reindex("t", other_version(ds))
    assert seen["device"] == ds.device == torch.device("cpu")
    assert seen["cols"].type == "cpu"


# -- REST and remote surfaces -----------------------------------------------

def _request(port, method, path, data=None, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@needs_jax
class TestWebSurfaces:
    TOKEN = "s3kr1t"

    @staticmethod
    def _serve(P, n=40, token=None):
        ds, _ = make_store(P, n)
        return P.m("web").GeoMesaWebServer(ds, auth_token=token).start()

    def test_blocking_reindex_endpoint_contract(self):
        def run(P):
            srv = self._serve(P, token=self.TOKEN)
            try:
                p = srv.port
                out = [_request(p, "POST", "/rest/reindex/t"),
                       _request(p, "POST", "/rest/reindex/t",
                                token="wrong"),
                       _request(p, "POST", "/rest/reindex/t?version=1",
                                token=self.TOKEN),
                       _request(p, "POST", "/rest/reindex/ghost",
                                token=self.TOKEN),
                       _request(p, "POST", "/rest/reindex/t?version=99",
                                token=self.TOKEN)]
                assert [o[0] for o in out] == [403, 403, 200, 404, 400]
                assert out[0][1] == {"error": "forbidden"}
                assert out[2][1] == {"reindexed": "t", "index_version": 1}
                assert srv.store.get_schema("t").index_version == 1
                return out
            finally:
                srv.stop()
        j, t = both(run)
        assert t == j

    def test_evolve_endpoints_gated_and_typed(self, evolve_on):
        def run(P):
            srv = self._serve(P, token=self.TOKEN)
            try:
                p = srv.port
                out = [_request(p, "GET", "/rest/evolve")]
                assert out[0][0] == 200 and out[0][1]["enabled"] is True
                assert out[0][1]["phases"] == list(P.Evolver.PHASES)
                for verb in ("reindex", "update", "resume", "abort"):
                    out.append(_request(p, "POST", f"/rest/evolve/{verb}"))
                    assert out[-1][0] == 403
                out.append(_request(p, "POST", "/rest/evolve/reindex",
                                    token=self.TOKEN))
                assert out[-1][0] == 400
                out.append(_request(
                    p, "POST", "/rest/evolve/reindex?type=t&version=1",
                    token=self.TOKEN))
                assert out[-1][0] == 200 and out[-1][1]["to_version"] == 1
                out.append(_request(
                    p, "POST", "/rest/evolve/update",
                    data=json.dumps({"type": "t", "changes": [
                        {"op": "add", "name": "score", "type": "Double",
                         "default": 3.5}]}).encode(),
                    token=self.TOKEN))
                assert out[-1][0] == 200
                assert out[-1][1]["changes"]["adds"] == ["score"]
                out.append(_request(p, "POST", "/rest/evolve/resume",
                                    token=self.TOKEN))
                assert out[-1][0] == 409
                assert out[-1][1]["retryable"] is False
                out.append(_request(p, "GET", "/rest/evolve"))
                assert [h["op"] for h in out[-1][1]["history"]] \
                    == ["reindex", "update"]
                return timeless(out), snap(srv.store)
            finally:
                srv.stop()
        j, t = both(run)
        assert t == j

    def test_evolve_disabled_maps_to_409(self):
        def run(P):
            srv = self._serve(P, token=self.TOKEN)
            try:
                st, body = _request(
                    srv.port, "POST",
                    "/rest/evolve/reindex?type=t&version=1",
                    token=self.TOKEN)
                assert st == 409
                assert "disabled" in body["error"]
                assert body["retryable"] is False
                return st, body
            finally:
                srv.stop()
        j, t = both(run)
        assert t == j

    def test_remote_store_passthroughs(self, evolve_on):
        def run(P):
            Remote = P.m("store.remote").RemoteDataStore
            srv = self._serve(P, token=self.TOKEN)
            try:
                ds = Remote("127.0.0.1", srv.port, auth_token=self.TOKEN)
                out = [ds.evolve_status()["enabled"]]
                assert out[0] is True
                out.append(ds.evolve("reindex", type="t", version=1))
                assert out[-1]["to_version"] == 1
                out.append(ds.evolve("update", type="t", changes=[
                    {"op": "drop", "name": "name"}]))
                assert out[-1]["changes"]["drops"] == ["name"]
                out.append(ds.reindex("t", 2))
                assert out[-1] == {"reindexed": "t", "index_version": 2}
                bare = Remote("127.0.0.1", srv.port)
                out.append(raised(lambda: bare.evolve("abort")))
                out.append(raised(lambda: bare.reindex("t", 1)))
                assert "forbidden" in out[-1] and "forbidden" in out[-2]
                return timeless(out), snap(srv.store)
            finally:
                srv.stop()
        j, t = both(run)
        assert t == j


# -- across packages --------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("verb", ["reindex", "update"])
def test_evolved_durable_directory_reopens_across_packages(
        evolve_on, tmp_path, writer, reader, verb):
    """A durable directory evolved by one package (its checkpoint
    carries the evolved schema) reopens in the other with that schema
    and those rows, ids in order; a write after the reopen lands on the
    evolved schema."""
    W = J if writer == "jax" else T
    R = J if reader == "jax" else T
    root = tmp_path / "w"
    ds, sft = make_store(W, 60, durable_dir=root)
    ds.delete("t", ["f4", "f9"])
    if verb == "reindex":
        ds.evolver.reindex("t", other_version(ds))
    else:
        ds.evolver.update_schema("t", [
            {"op": "add", "name": "score", "type": "Double", "default": 0.25},
            {"op": "widen", "name": "age", "type": "Long"}])
    ds.write("t", make_batch(W, ds.get_schema("t"), ["late"]))
    want = (snap(ds), ds.get_schema("t").to_spec(),
            [str(i) for i in ds.query("age < 30", "t").ids])
    ds.close()
    re = R.store(durable_dir=str(root), wal_fsync="never")
    try:
        got = (snap(re), re.get_schema("t").to_spec(),
               [str(i) for i in re.query("age < 30", "t").ids])
        assert got == want
        re.write("t", make_batch(R, re.get_schema("t"), ["after"]))
        assert "after" in set(re.query("INCLUDE", "t").ids.tolist())
    finally:
        re.close()


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_online_reindex_on_cuda_under_readers(tmp_path, monkeypatch):
    """An online reindex of a durable CUDA store to version 1 under
    reader threads: the shadow is built on the card, every read is exact
    or typed, and the BBOX+time ids after the flip equal a float64 brute
    force over the written rows."""
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.utils.device import cuda_index, device_scope
    monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", "0")   # a kernel tier
    rng = np.random.default_rng(3)
    n = 200_000
    sft = T.parse_spec("t", SPEC)
    ds = T.m("store.memory").InMemoryDataStore(
        durable_dir=str(tmp_path / "w"), wal_fsync="never")
    ds.create_schema(sft)
    x = rng.uniform(-100, -60, n)
    y = rng.uniform(25, 50, n)
    ms = rng.integers(0, 10**12, n)
    ids = np.array([f"f{i}" for i in range(n)], dtype=object)
    ds.write("t", T.FeatureBatch.from_dict(sft, ids, {
        "name": np.array([f"n{i % 5}" for i in range(n)], dtype=object),
        "age": np.arange(n), "dtg": ms, "geom": (x, y)}))
    ecql = ("BBOX(geom, -90, 30, -70, 45) AND "
            "dtg DURING 1990-01-01T00:00:00Z/2010-01-01T00:00:00Z")
    lo = np.datetime64("1990-01-01T00:00:00", "ms").astype(np.int64)
    hi = np.datetime64("2010-01-01T00:00:00", "ms").astype(np.int64)
    want = set(ids[(x >= -90) & (x <= -70) & (y >= 30) & (y <= 45)
                   & (ms > lo) & (ms < hi)])
    expected = set(ds.query("name = 'n2'", "t").ids.tolist())
    stop = threading.Event()
    errs = {"mismatch": 0, "typed": 0, "other": 0}
    index = cuda_index(ds)

    def reader():
        with device_scope(index):
            while not stop.is_set():
                try:
                    got = set(ds.query("name = 'n2'", "t").ids.tolist())
                except T.SchemaEvolutionError:
                    errs["typed"] += 1
                    continue
                except Exception:   # noqa: BLE001 - counted
                    errs["other"] += 1
                    continue
                if got != expected:
                    errs["mismatch"] += 1

    seen = {}

    def hook(tag):
        if tag == "catchup.done":
            seen["shadow"] = ds.evolver._active.shadow.scan_data.xhi.device
    T.EVOLVE_ENABLED.set("true")
    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    try:
        for th in threads:
            th.start()
        ds.evolver.fault_hook = hook
        ds.evolver.reindex("t", 1)
    finally:
        ds.evolver.fault_hook = None
        stop.set()
        for th in threads:
            th.join(timeout=60)
        T.EVOLVE_ENABLED.set(None)
    assert seen["shadow"].type == "cuda"
    assert errs == {"mismatch": 0, "typed": errs["typed"], "other": 0}
    assert ds.get_schema("t").index_version == 1
    kernels.reset_launches()
    got = set(ds.query(ecql, "t").ids.tolist())
    assert got == want
    assert kernels.launches["scan_mask"] + kernels.launches[
        "scan_mask_gather"] >= 1
    ds.close()
