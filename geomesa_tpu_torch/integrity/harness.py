"""Crash-consistency harness: randomized kill-points over real ingest.

The ALICE methodology (Pillai et al., OSDI '14) distilled to this
stack: run an acked-write workload against a durable store, kill it at
a randomly chosen storage operation (torn write / EIO / fsync failure
via :mod:`.faultfs`), reopen from disk, and check the durability
contract rather than any particular execution:

- **no acked loss** — every write acked before the kill is present
  after recovery (``wal_fsync="always"`` makes ack durable);
- **no garbage** — nothing the workload never wrote appears;
- **no duplicates** — replay idempotence holds across re-application;
- **at-most-once tail** — the single in-flight unacked write may
  survive (frame hit the file before the cut) or vanish, never
  partially.

A poisoned WAL (injected fsync failure) is part of the contract too:
the store must keep serving reads, refuse writes with
``DurabilityError``, and a fresh store on the same root must recover
everything acked before the poison.

Every store the harness opens is an ``InMemoryDataStore`` on ``device``
(None: the CUDA card, which raises without one; pass ``"cpu"`` to run
on the host).
"""

from __future__ import annotations

import random

from .faultfs import CrashPoint, FaultDisk

__all__ = ["CrashHarness", "run_crash_workload"]

_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"


def _make_batch(sft, ids, seed=7):
    import numpy as np

    from ..features.batch import FeatureBatch
    rng = np.random.default_rng(seed)
    n = len(ids)
    return FeatureBatch.from_dict(sft, ids, {
        "name": [f"n{i % 5}" for i in range(n)],
        "dtg": rng.integers(0, 10**12, n),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


class CrashHarness:
    """Randomized kill-point runner over one durable root.

    Each round opens a fresh store on ``root`` (recovery), checks the
    invariants against everything acked so far, then ingests
    single-feature writes with one randomly armed storage fault. The
    fault either unwinds the workload (simulated crash — the store is
    abandoned via ``journal.abort()``, never closed cleanly) or
    poisons the WAL (fsync), in which case read-only degradation is
    asserted in place. Violations accumulate in ``self.violations``;
    an empty list after ``run()`` is the pass condition."""

    _KINDS = ("torn", "eio", "fsync", "enospc")

    def __init__(self, root: str, seed: int = 0, type_name: str = "crash",
                 checkpoint_every: int = 3, device=None):
        from ..utils.device import resolve_device
        self.root = str(root)
        # resolved here: a harness without a card fails at construction
        self.device = resolve_device(device)
        self.rng = random.Random(seed)
        self.type_name = type_name
        self.checkpoint_every = int(checkpoint_every)
        self.acked: list[str] = []
        self.issued: set[str] = set()
        self.violations: list[str] = []
        self.faults: list[tuple[str, str, str]] = []
        self.rounds_run = 0

    # -- pieces ------------------------------------------------------------

    def _open(self):
        from ..features.sft import parse_spec
        from ..store.memory import InMemoryDataStore
        ds = InMemoryDataStore(device=self.device, durable_dir=self.root,
                               wal_fsync="always")
        if self.type_name not in ds.get_type_names():
            ds.create_schema(parse_spec(self.type_name, _SPEC))
        return ds

    def _surviving_ids(self, ds) -> list[str]:
        res = ds.query("INCLUDE", self.type_name)
        return [] if res.batch is None else list(map(str, res.ids))

    def check_invariants(self, ds, where: str):
        ids = self._surviving_ids(ds)
        got = set(ids)
        if len(ids) != len(got):
            self.violations.append(f"{where}: duplicate rows after recovery")
        lost = [i for i in self.acked if i not in got]
        if lost:
            self.violations.append(
                f"{where}: {len(lost)} acked write(s) lost, e.g. {lost[:3]}")
        garbage = got - self.issued
        if garbage:
            self.violations.append(
                f"{where}: {len(garbage)} garbage row(s), "
                f"e.g. {sorted(garbage)[:3]}")

    def _arm(self, disk: FaultDisk):
        """One random fault at a random kill-point: skip 0..N matching
        storage ops before firing, so the cut lands anywhere in the
        round's write sequence."""
        kind = self.rng.choice(self._KINDS)
        op = "fsync" if kind == "fsync" else "write"
        disk.add(op, match="log", kind=kind,
                 skip=self.rng.randrange(0, 12))

    # -- driver ------------------------------------------------------------

    def run(self, rounds: int = 5, writes_per_round: int = 20) -> dict:
        from ..features.sft import parse_spec  # noqa: F401 (fail fast)
        from ..wal import DurabilityError
        for rnd in range(rounds):
            self.rounds_run += 1
            ds = self._open()
            try:
                self.check_invariants(ds, f"round {rnd} reopen")
                sft = ds.get_schema(self.type_name)
                disk = FaultDisk()
                self._arm(disk)
                poisoned = False
                with disk:
                    for i in range(writes_per_round):
                        fid = f"r{rnd}-{i}"
                        batch = _make_batch(sft, [fid],
                                            seed=rnd * 1000 + i)
                        self.issued.add(fid)
                        try:
                            ds.write(self.type_name, batch)
                        except (CrashPoint, DurabilityError, OSError):
                            poisoned = ds.journal.poisoned
                            break
                        self.acked.append(fid)
                        if (self.checkpoint_every
                                and i % self.checkpoint_every == 2
                                and self.rng.random() < 0.3):
                            try:
                                ds.checkpoint()
                            except (CrashPoint, DurabilityError,
                                    OSError):
                                poisoned = ds.journal.poisoned
                                break
                self.faults.extend(disk.injected)
                if poisoned:
                    # degraded mode: reads fine, writes typed-refused
                    self.check_invariants(ds, f"round {rnd} poisoned reads")
                    try:
                        ds.write(self.type_name,
                                 _make_batch(sft, [f"r{rnd}-poisoned"]))
                        self.violations.append(
                            f"round {rnd}: poisoned store accepted a write")
                    except DurabilityError:
                        pass
            finally:
                # simulated crash: drop the store without clean close
                ds.journal.abort()
        # final reopen with no faults armed
        ds = self._open()
        try:
            self.check_invariants(ds, "final reopen")
        finally:
            ds.close()
        return self.report()

    def report(self) -> dict:
        return {"ok": not self.violations, "rounds": self.rounds_run,
                "acked": len(self.acked), "issued": len(self.issued),
                "faults_injected": len(self.faults),
                "violations": list(self.violations)}


def run_crash_workload(root: str, rounds: int = 5,
                       writes_per_round: int = 20, seed: int = 0,
                       device=None) -> dict:
    """One-call wrapper: build a harness on ``device`` (None: the card),
    run it, return the report."""
    h = CrashHarness(root, seed=seed, device=device)
    return h.run(rounds=rounds, writes_per_round=writes_per_round)
