"""Storage fault tolerance: fault injection (``faultfs``), end-to-end
verification of the durable artifacts (``verify``), the scrubber with
its read-only integrity report (``scrub``) and the crash-consistency
harness (``harness``).

Only :mod:`.faultfs` is imported eagerly: the WAL and the atomic file
writes route their writes and fsyncs through it on every call, so it
must be cheap and dependency-free. Everything else pulls in the wal and
store packages and is exposed lazily, so this package imports from
inside them without a cycle.
"""

from . import faultfs
from .faultfs import CrashPoint, Fault, FaultDisk, flip_bit

__all__ = [
    "faultfs", "FaultDisk", "Fault", "CrashPoint", "flip_bit",
    # lazy (PEP 562):
    "sha256_hex", "file_sha256", "verify_checkpoint", "verify_wal",
    "ids_digest", "quarantine",
    "Scrubber", "integrity_report",
    "CrashHarness", "run_crash_workload",
]

_LAZY = {
    "sha256_hex": "verify", "file_sha256": "verify",
    "verify_checkpoint": "verify", "verify_wal": "verify",
    "ids_digest": "verify", "quarantine": "verify",
    "Scrubber": "scrub", "integrity_report": "scrub",
    "CrashHarness": "harness", "run_crash_workload": "harness",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
