"""Background scrubber: periodic re-verification + quarantine.

Silent corruption is only caught by reading the data back; the
scrubber walks a durable root on a cadence (``geomesa.scrub.interval.s``)
and re-verifies WAL segment CRCs and checkpoint digests. Corrupt
checkpoints are quarantined (renamed ``*.corrupt`` so recovery falls
back to the next intact snapshot) when ``geomesa.integrity.quarantine``
is on; corrupt mid-history WAL segments are reported and counted but
NEVER renamed — pulling a segment out of the log would silently turn a
detected gap into an undetected one (replay must stop at the corrupt
frame, not skip past it).

On a replica the scrubber doubles as anti-entropy (Dynamo's Merkle
sweep, one level simpler): it asks the primary for a per-type
row-count + content digest (the shipper's ``digest`` op), compares the
replica's own state, and triggers a re-bootstrap on divergence — but
only when both sides agree the replica is fully caught up, so a
legitimate streaming lag is never misread as corruption.
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics
from ..utils.properties import SystemProperty
from .verify import ids_digest, quarantine, verify_checkpoint, verify_wal

__all__ = ["Scrubber", "integrity_report", "SCRUB_INTERVAL_S",
           "INTEGRITY_QUARANTINE"]

# scrub cadence (seconds) for the background loop
SCRUB_INTERVAL_S = SystemProperty("geomesa.scrub.interval.s", "60")
# rename corrupt artifacts to *.corrupt (off: detect + report only)
INTEGRITY_QUARANTINE = SystemProperty("geomesa.integrity.quarantine",
                                      "true")


def integrity_report(root: str) -> dict:
    """Read-only verification sweep over a durable root (``log/`` +
    ``snapshots/``): the GET /rest/integrity and ``tools integrity
    verify`` payload. Never quarantines."""
    import os

    from ..wal.snapshot import checkpoint_dirs
    wal = verify_wal(os.path.join(root, "log"))
    ckpts = []
    for lsn, path in checkpoint_dirs(root):
        rep = verify_checkpoint(path)
        rep["dir"] = os.path.basename(path)
        ckpts.append(rep)
    return {"root": root, "ok": wal["ok"] and all(c["ok"] for c in ckpts),
            "wal": wal, "checkpoints": ckpts}


class Scrubber:
    """Periodic integrity verifier for a durable root and/or a replica.

    ``Scrubber(journal=ds.journal).start()`` scrubs a primary's WAL +
    checkpoints; ``Scrubber(replica=r)`` adds the anti-entropy digest
    comparison against ``r``'s primary. ``run_once()`` is the
    synchronous unit (POST /rest/integrity/scrub calls it directly)."""

    def __init__(self, journal=None, replica=None,
                 interval_s: float | None = None,
                 quarantine_corrupt: bool | None = None,
                 registry=metrics):
        if journal is None and replica is None:
            raise ValueError("scrubber needs a journal and/or a replica")
        self.journal = journal
        self.replica = replica
        self.interval_s = float(
            interval_s if interval_s is not None
            else (SCRUB_INTERVAL_S.as_float() or 60.0))
        self.quarantine_corrupt = bool(
            quarantine_corrupt if quarantine_corrupt is not None
            else INTEGRITY_QUARANTINE.as_bool())
        self.registry = registry
        self.runs = 0
        self.last_report: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Scrubber":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="integrity-scrubber")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                # a scrub pass must never take the process down
                self.registry.counter("integrity.scrub.crashes")

    # -- one pass ----------------------------------------------------------

    def run_once(self) -> dict:
        t0 = time.perf_counter()
        out: dict = {"ok": True, "quarantined": [], "unreferenced": []}
        if self.journal is not None:
            self._scrub_root(out)
        if self.replica is not None:
            self._scrub_replica(out)
        out["seconds"] = round(time.perf_counter() - t0, 4)
        self.runs += 1
        self.last_report = out
        self.registry.counter("integrity.scrub.runs")
        self.registry.gauge("integrity.scrub.seconds", out["seconds"])
        if not out["ok"]:
            self.registry.counter("integrity.scrub.errors")
        return out

    def _scrub_root(self, out: dict):
        import os

        from ..wal.snapshot import checkpoint_dirs
        root = self.journal.root
        wal = verify_wal(os.path.join(root, "log"))
        out["wal"] = wal
        if not wal["ok"]:
            out["ok"] = False
            self.registry.counter("integrity.corrupt.wal.segments",
                                  len(wal["corrupt_segments"]))
        ckpts = []
        for lsn, path in checkpoint_dirs(root):
            rep = verify_checkpoint(path)
            rep["dir"] = os.path.basename(path)
            ckpts.append(rep)
            if rep["unreferenced"]:
                # crashed-attempt debris inside the dir: flag only
                out["unreferenced"].extend(
                    os.path.join(os.path.basename(path), f)
                    for f in rep["unreferenced"])
            if not rep["ok"]:
                out["ok"] = False
                self.registry.counter("integrity.corrupt.checkpoints")
                if self.quarantine_corrupt:
                    moved = quarantine(path, self.registry)
                    if moved is not None:
                        rep["quarantined_to"] = os.path.basename(moved)
                        out["quarantined"].append(os.path.basename(moved))
        # abandoned .tmp staging dirs (crash mid-checkpoint): flag too
        snapdir = os.path.join(root, "snapshots")
        try:
            for d in sorted(os.listdir(snapdir)):
                if d.endswith(".tmp"):
                    out["unreferenced"].append(d)
        except OSError:
            pass
        if out["unreferenced"]:
            self.registry.counter("integrity.unreferenced",
                                  len(out["unreferenced"]))
        out["checkpoints"] = ckpts

    def _scrub_replica(self, out: dict):
        from ..replication.sync import ReplClient
        rep = self.replica
        anti: dict = {"checked": False, "mismatch": []}
        out["anti_entropy"] = anti
        if not rep.attached:
            return
        try:
            client = ReplClient(rep.host, rep.port,
                                timeout_s=rep.timeout_s)
            try:
                remote = client.digest()
            finally:
                client.close()
        except (ConnectionError, TimeoutError, OSError) as e:
            anti["error"] = repr(e)
            return
        if remote.get("error"):
            anti["error"] = remote["error"]
            return
        # only a quiescent, fully caught-up replica is comparable: the
        # primary must not have advanced while computing, and the
        # replica must have applied everything shipped
        if not (remote.get("last_lsn_pre") == remote.get("last_lsn")
                == rep.applied_lsn and rep.applied_lsn > 0):
            anti["skipped"] = "replica lagging or primary in flux"
            return
        anti["checked"] = True
        for name, want in remote.get("types", {}).items():
            try:
                rows, digest = ids_digest(rep, name)
            except KeyError:
                rows, digest = -1, ""
            if rows != int(want["rows"]) or digest != want["digest"]:
                anti["mismatch"].append(name)
        missing = set(t for t in rep.get_type_names()
                      if t not in remote.get("types", {}))
        anti["mismatch"].extend(sorted(missing))
        if anti["mismatch"]:
            out["ok"] = False
            self.registry.counter("integrity.antientropy.mismatches")
            self.registry.counter("integrity.antientropy.rebootstraps")
            anti["rebootstrap"] = True
            rep.request_rebootstrap()

    # -- status ------------------------------------------------------------

    def status(self) -> dict:
        return {"runs": self.runs, "interval_s": self.interval_s,
                "quarantine": self.quarantine_corrupt,
                "running": (self._thread is not None
                            and self._thread.is_alive()),
                "last_report": self.last_report}
