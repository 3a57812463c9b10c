"""Storage fault tolerance: fault injection (``faultfs``) and end-to-end
verification of the durable artifacts (``verify``).

Only :mod:`.faultfs` is imported eagerly: the WAL and the atomic file
writes route their writes and fsyncs through it on every call, so it
must be cheap and dependency-free. The verify functions pull in the wal
and store packages and are exposed lazily, so this package imports from
inside them without a cycle. The scrubber and the crash harness come
with the cluster tier (ROADMAP.md section 6).
"""

from . import faultfs
from .faultfs import CrashPoint, Fault, FaultDisk, flip_bit

__all__ = [
    "faultfs", "FaultDisk", "Fault", "CrashPoint", "flip_bit",
    # lazy (PEP 562):
    "sha256_hex", "file_sha256", "verify_checkpoint", "verify_wal",
    "ids_digest", "quarantine",
]

_LAZY = frozenset({"sha256_hex", "file_sha256", "verify_checkpoint",
                   "verify_wal", "ids_digest", "quarantine"})


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from . import verify
    return getattr(verify, name)
