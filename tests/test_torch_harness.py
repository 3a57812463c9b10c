"""The port's crash-consistency harness (``integrity/harness.py``) and
the integrity package's surface against the JAX package's on the CPU.

``TestChaosAcceptance``, the slow soak and ``TestIntegritySurface`` of
``tests/test_integrity.py`` run here, each scenario in both packages
(``both(fn)``): the port's stores on ``device="cpu"``, the reference's
assertions kept, and the outcomes held equal: the harness's report and
violations, the faults it injected (operation, file under the root,
kind), the recovered ids, the recovery report's checkpoint fallback,
error types by name. No comparison here has a tolerance.

``CrashHarness`` and ``run_crash_workload`` take ``device`` (None: the
card, which raises without one). The ``gpu`` test at the end runs two
harness rounds on a durable CUDA store (``python -m pytest --noconftest
-m gpu tests/test_torch_harness.py``)."""

import importlib
import os
import types

import numpy as np
import pytest
import torch

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


def _ns(pkg, cpu):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    integ = m("integrity")
    store = m("store.memory").InMemoryDataStore

    def make(**kw):
        if cpu:
            kw.setdefault("device", "cpu")
        return store(**kw)

    def harness_kw():
        return {"device": "cpu"} if cpu else {}

    return types.SimpleNamespace(
        pkg=pkg, m=m, store=make, integ=integ, harness_kw=harness_kw,
        FaultDisk=integ.FaultDisk, flip_bit=integ.flip_bit,
        DurabilityError=m("wal").DurabilityError,
        checkpoint_dirs=m("wal.snapshot").checkpoint_dirs,
        FeatureBatch=m("features.batch").FeatureBatch,
        parse_spec=m("features.sft").parse_spec)


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


def make_batch(P, sft, ids, seed=7):
    rng = np.random.default_rng(seed)
    n = len(ids)
    return P.FeatureBatch.from_dict(sft, ids, {
        "name": [f"n{i % 5}" for i in range(n)],
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


def durable_mem(P, root, **kw):
    kw.setdefault("wal_fsync", "never")
    return P.store(durable_dir=str(root), **kw)


def _ids(ds, tn="t"):
    res = ds.query("INCLUDE", tn)
    return sorted([] if res.batch is None else map(str, res.ids))


# -- chaos acceptance --------------------------------------------------------

@needs_jax
class TestChaosAcceptance:
    def test_acceptance_gate_1k_writes(self, tmp_path):
        """A 1k-feature acked workload surviving a checkpoint bit-flip at
        rest, a torn checkpoint write and one injected fsync failure: no
        acked write lost, the poisoned store serves reads and refuses
        writes typed, recovery falls back to the PRIOR checkpoint."""
        def run(P):
            root = tmp_path / P.pkg / "d"
            ds = durable_mem(P, root, wal_fsync="always")
            sft = P.parse_spec("t", SPEC)
            ds.create_schema(sft)
            acked = []

            def write_rows(prefix, n, per_batch=20):
                for lo in range(0, n, per_batch):
                    ids = [f"{prefix}{i}" for i in range(lo, lo + per_batch)]
                    ds.write("t", make_batch(P, sft, ids, seed=lo))
                    acked.extend(ids)

            write_rows("a", 200)
            info_a = ds.checkpoint()
            write_rows("b", 200)
            info_b = ds.checkpoint()
            assert info_b["lsn"] > info_a["lsn"]
            P.flip_bit(os.path.join(P.checkpoint_dirs(str(root))[-1][1],
                                    "t.bin"))
            write_rows("c", 300)
            disk = P.FaultDisk().add("write", match="snapshots", kind="torn")
            with disk, pytest.raises(OSError) as torn:
                ds.checkpoint()
            write_rows("d", 300)
            assert len(acked) == 1000
            disk = P.FaultDisk().add("fsync", match="log", kind="fsync")
            with disk, pytest.raises(P.DurabilityError):
                ds.write("t", make_batch(P, sft, ["never-acked"], seed=77))
            assert ds.journal.poisoned
            assert _ids(ds) == sorted(acked)
            with pytest.raises(P.DurabilityError) as refused:
                ds.write("t", make_batch(P, sft, ["still-refused"], seed=78))
            ds.journal.abort()
            re = durable_mem(P, root, wal_fsync="always")
            rep = re.journal.last_report
            assert rep.checkpoints_skipped == 1
            assert rep.checkpoint_lsn == info_a["lsn"]
            got = _ids(re)
            assert set(acked) <= set(got) <= set(acked) | {"never-acked"}
            assert "still-refused" not in got
            assert len(got) == len(set(got))
            assert not re.journal.poisoned
            re.close()
            return (info_a["lsn"], info_b["lsn"], type(torn.value).__name__,
                    type(refused.value).__name__, rep.checkpoints_skipped,
                    rep.checkpoint_lsn, got)
        j, t = both(run)
        assert t == j

    def test_harness_randomized_short(self, tmp_path):
        """A short deterministic slice of the randomized kill-point loop:
        the same seed takes the same faults in both packages and reports
        the same acked and issued counts."""
        def run(P):
            out = P.integ.run_crash_workload(
                str(tmp_path / P.pkg / "h"), rounds=3, writes_per_round=12,
                seed=1234, **P.harness_kw())
            assert out["ok"], out["violations"]
            assert out["rounds"] == 3
            assert out["faults_injected"] >= 1
            assert out["acked"] <= out["issued"]
            return out
        j, t = both(run)
        assert t == j

    @pytest.mark.parametrize("seed", [3, 99])
    def test_harness_faults_and_survivors_equal(self, tmp_path, seed):
        """The harness object itself: the faults (operation, file under
        the root, kind), the acked ids and what a final reopen holds, equal across the
        packages for the same seed."""
        def run(P):
            root = tmp_path / P.pkg / "h"
            h = P.integ.CrashHarness(str(root), seed=seed, **P.harness_kw())
            report = h.run(rounds=4, writes_per_round=10)
            assert report["ok"], report["violations"]
            ds = P.store(durable_dir=str(root), wal_fsync="always")
            try:
                survivors = _ids(ds, "crash")
            finally:
                ds.close()
            assert set(h.acked) <= set(survivors) <= h.issued
            faults = [(op, os.path.relpath(path, root), kind)
                      for op, path, kind in h.faults]
            return report, faults, h.acked, survivors
        j, t = both(run)
        assert t == j


@needs_jax
@pytest.mark.slow
def test_crash_harness_soak(tmp_path):
    """Long randomized crash-consistency soak: many seeds, many rounds;
    every acked write survives every kill-point in both packages."""
    def run(P):
        out = []
        for seed in (1, 7, 42, 1234):
            rep = P.integ.run_crash_workload(
                str(tmp_path / P.pkg / f"s{seed}"), rounds=8,
                writes_per_round=25, seed=seed, **P.harness_kw())
            assert rep["ok"], (seed, rep["violations"])
            assert rep["faults_injected"] >= 1
            out.append(rep)
        return out
    j, t = both(run)
    assert t == j


# -- package surface ------------------------------------------------------

@needs_jax
class TestIntegritySurface:
    def test_integrity_report_shape(self, tmp_path):
        def run(P):
            root = tmp_path / P.pkg / "d"
            ds = durable_mem(P, root)
            sft = P.parse_spec("t", SPEC)
            ds.create_schema(sft)
            ds.write("t", make_batch(P, sft, ["a"]))
            ds.checkpoint()
            ds.close()
            rep = P.integ.integrity_report(str(root))
            assert rep["ok"] and rep["wal"]["ok"]
            assert [c["ok"] for c in rep["checkpoints"]] == [True]
            return rep["ok"], rep["wal"]["ok"], [c["ok"] for c in
                                                 rep["checkpoints"]]
        j, t = both(run)
        assert t == j

    def test_lazy_exports(self):
        def run(P):
            integ = P.integ
            for name in ("CrashPoint", "Fault", "FaultDisk", "flip_bit",
                         "verify_checkpoint", "verify_wal", "ids_digest",
                         "quarantine", "Scrubber", "integrity_report",
                         "CrashHarness", "run_crash_workload"):
                assert callable(getattr(integ, name)), name
            with pytest.raises(AttributeError):
                integ.no_such_symbol
            return sorted(integ.__all__)
        j, t = both(run)
        assert t == j


def test_harness_without_device_means_the_card(tmp_path):
    """No ``device``: the harness runs on CUDA, and without a card it
    raises at construction, before it touches the root."""
    if torch.cuda.is_available():
        h = T.integ.CrashHarness(str(tmp_path / "h"))
        assert h.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.integ.CrashHarness(str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.integ.run_crash_workload(str(tmp_path / "w"), rounds=1)
    assert not (tmp_path / "h").exists() and not (tmp_path / "w").exists()


def test_harness_stores_on_its_device(tmp_path, monkeypatch):
    """Every store the harness opens is on its device."""
    seen = []
    cls = T.m("store.memory").InMemoryDataStore
    orig = cls.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(self.device)
    monkeypatch.setattr(cls, "__init__", spy)
    rep = T.integ.run_crash_workload(str(tmp_path / "h"), rounds=2,
                                     writes_per_round=6, seed=5,
                                     device="cpu")
    assert rep["ok"], rep["violations"]
    assert seen and all(d == torch.device("cpu") for d in seen)


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_crash_harness_on_cuda(tmp_path):
    """Two harness rounds on a durable store on the card: no violation,
    and every recovered store is on CUDA."""
    rep = T.integ.run_crash_workload(str(tmp_path / "h"), rounds=2,
                                     writes_per_round=20, seed=11)
    assert rep["ok"], rep["violations"]
    assert rep["rounds"] == 2 and rep["faults_injected"] >= 1
