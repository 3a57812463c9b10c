"""Runtime telemetry: plan shape classes, dispatches, device memory,
transfer bytes.

The serving layer keeps several shape-class tables (the query batcher's
fused-scan plans, the standing-filter sets' launch shapes, the join
prewarm) whose misses mark a first dispatch of a shape: in the port a
first launch of a class pays its allocations and the kernel library's
load, not a trace. This collector is the one place those tables report
to: per-domain, per-shape-class miss-vs-hit counts, fused-dispatch wall
timers, host<->device transfer bytes, and sampled device memory
(current, high-water mark, live allocation count/bytes).

Everything lands twice: in the labeled metrics registry
(``runtime.compile{domain,class,outcome}`` counters,
``runtime.dispatch{domain,class}`` timers, ``runtime.device.bytes``
gauges, ``runtime.h2d.bytes``/``runtime.d2h.bytes`` counters) for
scraping, and in an internal table the ``/rest/runtime`` snapshot
serves directly.

Device memory sampling NEVER initializes CUDA: it reads
``torch.cuda.memory_stats`` only once this process has initialized
CUDA itself (``torch.cuda.is_initialized()``), so a CPU-only process
records nothing. Once it reads, it reports the caching allocator's
numbers for every card (``cuda:<i>``) or raises; it never reports
zeros in their place.

Kill switch: ``geomesa.runtime.enabled`` (default true) — re-read per
call, so on/off overhead runs and a live operator both work without
restarts.
"""

from __future__ import annotations

import sys
import threading
import time

from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

__all__ = ["RuntimeCollector", "runtime", "RUNTIME_ENABLED"]

RUNTIME_ENABLED = SystemProperty("geomesa.runtime.enabled", "true")


def _cls(shape) -> str:
    """A shape class (tuple of type/version/pow2 caps, or anything
    else a cache keys on) as a bounded metric-safe label value."""
    if isinstance(shape, (tuple, list)):
        return sanitize_key("/".join(str(x) for x in shape))
    return sanitize_key(str(shape))


class RuntimeCollector:
    def __init__(self, registry=metrics):
        self._registry = registry
        self._lock = threading.Lock()
        # (domain, class) -> [hits, misses]
        self._compiles: dict[tuple[str, str], list] = {}
        # (domain, class) -> [count, total_s, max_s]
        self._dispatches: dict[tuple[str, str], list] = {}
        self._h2d_bytes = 0
        self._d2h_bytes = 0
        self._mem: dict[str, dict] = {}     # device label -> stats
        self._live_buffers = 0
        self._live_bytes = 0
        self._live_bytes_hwm = 0
        self._mem_samples = 0
        self._mem_sampled_at: float | None = None

    @staticmethod
    def enabled() -> bool:
        return str(RUNTIME_ENABLED.get()).lower() in ("true", "1", "yes")

    # -- cache + dispatch hooks --------------------------------------------

    def note_plan_probe(self, domain: str, shape, hit: bool):
        """One shape-class cache probe: a miss is a predicted compile."""
        if not self.enabled():
            return
        cls = _cls(shape)
        with self._lock:
            row = self._compiles.setdefault((domain, cls), [0, 0])
            row[0 if hit else 1] += 1
        self._registry.counter(
            "runtime.compile",
            labels={"domain": domain, "class": cls,
                    "outcome": "hit" if hit else "miss"})

    def note_dispatch(self, domain: str, shape, seconds: float,
                      h2d_bytes: int = 0, d2h_bytes: int = 0):
        """One device dispatch: wall seconds + transfer bytes."""
        if not self.enabled():
            return
        cls = _cls(shape)
        with self._lock:
            row = self._dispatches.setdefault((domain, cls),
                                              [0, 0.0, 0.0])
            row[0] += 1
            row[1] += seconds
            row[2] = max(row[2], seconds)
            self._h2d_bytes += int(h2d_bytes)
            self._d2h_bytes += int(d2h_bytes)
        self._registry.observe("runtime.dispatch", seconds,
                               labels={"domain": domain, "class": cls})
        if h2d_bytes:
            self._registry.counter("runtime.h2d.bytes", int(h2d_bytes))
        if d2h_bytes:
            self._registry.counter("runtime.d2h.bytes", int(d2h_bytes))

    # -- device memory -----------------------------------------------------

    def sample_device_memory(self):
        """Sample each card's allocator statistics, if this process has
        initialized CUDA (a telemetry thread must never be the thing
        that initializes a device): bytes in use, the allocator's peak,
        and the live allocation count."""
        if not self.enabled():
            return
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return
        per_dev: dict[str, dict] = {}
        live_n = live_b = 0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            # an allocator that never allocated on card i has no
            # statistics yet: it holds nothing there
            in_use = int(stats["allocated_bytes.all.current"]) if stats else 0
            peak = int(stats["allocated_bytes.all.peak"]) if stats else 0
            per_dev[f"cuda:{i}"] = {"bytes_in_use": in_use,
                                    "peak_bytes_in_use": peak}
            live_n += int(stats["allocation.all.current"]) if stats else 0
            live_b += in_use
        with self._lock:
            for label, st in per_dev.items():
                prev = self._mem.get(label, {})
                st["hwm_bytes"] = max(st["peak_bytes_in_use"],
                                      int(prev.get("hwm_bytes", 0)))
                self._mem[label] = st
            self._live_buffers = live_n
            self._live_bytes = live_b
            self._live_bytes_hwm = max(self._live_bytes_hwm, live_b)
            self._mem_samples += 1
            self._mem_sampled_at = time.time()
        reg = self._registry
        for label, st in per_dev.items():
            reg.gauge("runtime.device.bytes", st["bytes_in_use"],
                      labels={"device": label})
            reg.gauge("runtime.device.bytes.peak", st["peak_bytes_in_use"],
                      labels={"device": label})
        reg.gauge("runtime.device.live_buffers", live_n)
        reg.gauge("runtime.device.live_bytes", live_b)

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /rest/runtime`` document (JSON-safe)."""
        with self._lock:
            compiles: dict[str, dict] = {}
            for (domain, cls), (hits, misses) in self._compiles.items():
                compiles.setdefault(domain, {})[cls] = {
                    "hits": hits, "misses": misses}
            dispatches: dict[str, dict] = {}
            for (domain, cls), (n, tot, mx) in self._dispatches.items():
                dispatches.setdefault(domain, {})[cls] = {
                    "count": n,
                    "total_ms": round(tot * 1e3, 3),
                    "mean_ms": round(tot / n * 1e3, 3) if n else 0.0,
                    "max_ms": round(mx * 1e3, 3)}
            return {
                "enabled": self.enabled(),
                "compile": compiles,
                "dispatch": dispatches,
                "transfer": {"h2d_bytes": self._h2d_bytes,
                             "d2h_bytes": self._d2h_bytes},
                "device_memory": {
                    "devices": {k: dict(v) for k, v in self._mem.items()},
                    "live_buffers": self._live_buffers,
                    "live_bytes": self._live_bytes,
                    "live_bytes_hwm": self._live_bytes_hwm,
                    "samples": self._mem_samples,
                    "sampled_at": self._mem_sampled_at,
                },
            }

    def clear(self):
        with self._lock:
            self._compiles.clear()
            self._dispatches.clear()
            self._h2d_bytes = self._d2h_bytes = 0
            self._mem.clear()
            self._live_buffers = self._live_bytes = 0
            self._live_bytes_hwm = 0
            self._mem_samples = 0
            self._mem_sampled_at = None


runtime = RuntimeCollector()
