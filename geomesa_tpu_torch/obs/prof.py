"""Always-on sampling profiler + stall-capturing watchdog.

**Profiler.** A daemon thread snapshots every thread's Python stack
via ``sys._current_frames()`` at ``geomesa.prof.hz`` (default 19 —
prime, so the sampler cannot phase-lock with periodic work) and folds
the stacks into a bounded trie keyed by ``file:function`` frames.
``collapsed()`` renders the aggregate in collapsed-stack format
(one line per observed stack, root-first frames joined by ``;``, a
space, then the sample count) — the exact input flamegraph.pl /
speedscope / Grafana flame panels eat. The trie is capped at
``geomesa.prof.max.nodes`` (8192); past the cap, new frames collapse
into a ``<trunc>`` child so memory stays bounded under pathological
stack diversity. Overhead is one GIL-held stack walk per tick. About
once a second the thread also samples the card's memory
(``runtime.sample_device_memory``).

**Watchdog.** Every dispatch / WAL fsync / scatter leg / ingest group
commit registers itself (op key, owning thread, start time, trace
span) for the duration of the call. Each profiler tick — or an
explicit ``check(now)`` with a fake clock — compares open ops against
``geomesa.prof.watchdog.factor`` x their op-class p99 (learned from
completed ops; ``geomesa.prof.watchdog.min.ms`` floors it). An op
past its threshold gets its owning thread's LIVE stack captured into
the op's trace span (``watchdog.stall`` annotation + ``stalled``
attr), and the span's trace is force-kept even at sample rate 0 — a
stalled query in the ring says *where it was stuck*, not just that it
was slow.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

from ..metrics import metrics, sanitize_key
from ..metrics.registry import _Timer
from ..utils.properties import SystemProperty

__all__ = ["ContinuousProfiler", "StallWatchdog", "profiler", "watchdog",
           "PROF_HZ", "PROF_MAX_NODES", "WATCHDOG_FACTOR",
           "WATCHDOG_MIN_MS"]

PROF_HZ = SystemProperty("geomesa.prof.hz", "19")
PROF_MAX_NODES = SystemProperty("geomesa.prof.max.nodes", "8192")
WATCHDOG_FACTOR = SystemProperty("geomesa.prof.watchdog.factor", "8")
WATCHDOG_MIN_MS = SystemProperty("geomesa.prof.watchdog.min.ms", "100")

_MAX_DEPTH = 64


def _frame_label(frame) -> str:
    co = frame.f_code
    return f"{os.path.basename(co.co_filename)}:{co.co_name}"


def _walk_stack(frame) -> list[str]:
    """Root-first frame labels, depth-capped."""
    out: list[str] = []
    f = frame
    while f is not None and len(out) < _MAX_DEPTH:
        out.append(_frame_label(f))
        f = f.f_back
    out.reverse()
    return out


class _TrieNode:
    __slots__ = ("children", "count")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.count = 0


class ContinuousProfiler:
    """Bounded-trie sampling profiler. ``start``/``stop`` are
    refcounted (every web server holds a reference while serving), so
    two servers in one process share one sampler thread."""

    def __init__(self, registry=metrics):
        self._registry = registry
        self._lock = threading.Lock()
        self._root = _TrieNode()
        self._nodes = 1
        self._samples = 0
        self._truncated = 0
        self._refs = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def hz() -> float:
        try:
            return max(float(PROF_HZ.get() or 0.0), 0.0)
        except (TypeError, ValueError):
            return 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with self._lock:
            self._refs += 1
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="geomesa-prof")
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._refs = max(self._refs - 1, 0)
            if self._refs > 0 or self._thread is None:
                return
            t = self._thread
            self._thread = None
            self._stop.set()
        t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _run(self):
        last_mem = 0.0
        while not self._stop.is_set():
            hz = self.hz()   # live: hz=0 parks the thread, not kills it
            if hz <= 0:
                self._stop.wait(0.25)
                continue
            self.sample_once()
            watchdog.check()
            now = time.monotonic()
            if now - last_mem >= 1.0:
                # device memory at ~1Hz: the allocator's statistics are
                # a dict walk, more than a tick needs
                last_mem = now
                from .runtime import runtime
                runtime.sample_device_memory()
            self._stop.wait(1.0 / hz)

    # -- sampling ----------------------------------------------------------

    def sample_once(self):
        me = threading.get_ident()
        frames = sys._current_frames()  # noqa: SLF001 — the documented API
        with self._lock:
            for tid, frame in frames.items():
                if tid == me:
                    continue
                self._insert(_walk_stack(frame))
            self._samples += 1
        self._registry.counter("prof.samples")

    def _insert(self, stack: list[str]):
        try:
            cap = int(PROF_MAX_NODES.get() or 8192)
        except (TypeError, ValueError):
            cap = 8192
        node = self._root
        for label in stack:
            child = node.children.get(label)
            if child is None:
                if self._nodes >= cap:
                    self._truncated += 1
                    child = node.children.get("<trunc>")
                    if child is None:
                        child = _TrieNode()
                        node.children["<trunc>"] = child
                        self._nodes += 1
                    node = child
                    break
                child = _TrieNode()
                node.children[label] = child
                self._nodes += 1
            node = child
        node.count += 1

    # -- export ------------------------------------------------------------

    def collapsed(self) -> str:
        """Collapsed-stack text: ``frame;frame;frame N`` per line."""
        lines: list[str] = []
        with self._lock:
            stack = [(self._root, [])]
            while stack:
                node, prefix = stack.pop()
                for label, ch in sorted(node.children.items(),
                                        reverse=True):
                    p = prefix + [label]
                    if ch.count:
                        lines.append(";".join(p) + f" {ch.count}")
                    stack.append((ch, p))
        return "\n".join(lines) + ("\n" if lines else "")

    def stats(self) -> dict:
        with self._lock:
            return {"running": self._thread is not None,
                    "hz": self.hz(),
                    "samples": self._samples,
                    "nodes": self._nodes,
                    "truncated": self._truncated}

    def clear(self):
        with self._lock:
            self._root = _TrieNode()
            self._nodes = 1
            self._samples = 0
            self._truncated = 0


class StallWatchdog:
    """Detects watched operations open past N x their op-class p99 and
    captures the owning thread's live stack into the op's trace span.

    ``watch(key, span=...)`` is the instrumentation contract: a cheap
    context manager that registers the op on entry and, on exit, folds
    the duration into the key's latency history (the p99 source).
    ``check(now)`` is driven by the profiler thread in production and
    called directly with a fake clock in tests."""

    _HISTORY_MIN = 4     # cold keys use the floored minimum instead

    def __init__(self, registry=metrics, clock=time.monotonic):
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._active: dict[int, dict] = {}
        self._next_id = 0
        self._history: dict[str, _Timer] = {}
        self._stalls: deque = deque(maxlen=32)
        self.stall_count = 0

    # -- instrumentation contract ------------------------------------------

    def watch(self, key: str, span=None):
        wd = self

        class _Watch:
            __slots__ = ("token",)

            def __enter__(self):
                self.token = wd._register(key, span)
                return self

            def __exit__(self, *exc):
                wd._finish(self.token)

        return _Watch()

    def _register(self, key: str, span) -> int:
        with self._lock:
            self._next_id += 1
            token = self._next_id
            self._active[token] = {
                "key": key, "span": span,
                "tid": threading.get_ident(),
                "t0": self._clock(), "captured": False}
            return token

    def _finish(self, token: int):
        with self._lock:
            op = self._active.pop(token, None)
            if op is None:
                return
            dt = self._clock() - op["t0"]
            self._history.setdefault(op["key"], _Timer()).update(dt)

    # -- detection ---------------------------------------------------------

    def threshold_s(self, key: str) -> float:
        """factor x the key's learned p99, floored at the min-ms knob;
        keys with too little history use the floor alone (scaled by
        the factor) so a cold tier still catches gross stalls."""
        try:
            factor = max(float(WATCHDOG_FACTOR.get() or 8.0), 0.0)
        except (TypeError, ValueError):
            factor = 8.0
        floor = (WATCHDOG_MIN_MS.as_float() or 100.0) / 1e3
        t = self._history.get(key)
        if t is None or t.count < self._HISTORY_MIN:
            return max(floor * max(factor, 1.0), floor)
        return max(t.quantile_s(0.99) * factor, floor)

    def check(self, now: float | None = None) -> list[dict]:
        """Scan open ops; capture (once per op) any past threshold.
        Returns the newly captured stall records."""
        try:
            if float(WATCHDOG_FACTOR.get() or 8.0) <= 0:
                return []
        except (TypeError, ValueError):
            pass
        if now is None:
            now = self._clock()
        with self._lock:
            candidates = [(tok, dict(op))
                          for tok, op in self._active.items()
                          if not op["captured"]]
        if not candidates:
            return []
        frames = sys._current_frames()  # noqa: SLF001
        captured: list[dict] = []
        for token, op in candidates:
            elapsed = now - op["t0"]
            thr = self.threshold_s(op["key"])
            if elapsed <= thr:
                continue
            frame = frames.get(op["tid"])
            stack = _walk_stack(frame) if frame is not None else []
            record = {"key": op["key"], "thread_id": op["tid"],
                      "elapsed_s": round(elapsed, 6),
                      "threshold_s": round(thr, 6),
                      "stack": stack}
            with self._lock:
                live = self._active.get(token)
                if live is None or live["captured"]:
                    continue   # finished or raced with another check
                live["captured"] = True
                self._stalls.append(record)
                self.stall_count += 1
            self._registry.counter(
                "prof.watchdog.stalls",
                labels={"op": sanitize_key(op["key"])})
            span = op["span"]
            if span is not None:
                try:
                    span.annotate("watchdog.stall",
                                  elapsed_ms=round(elapsed * 1e3, 3),
                                  threshold_ms=round(thr * 1e3, 3),
                                  stack=";".join(stack))
                    span.set_attr(stalled=True)
                    # force-keep: a stalled trace must land in the
                    # ring even at sample rate 0
                    state = getattr(span, "_state", None)
                    if state is not None:
                        state.sampled = True
                except Exception:  # noqa: BLE001 — null spans etc.
                    pass
            captured.append(record)
        return captured

    # -- surfaces ----------------------------------------------------------

    def stalls(self) -> list[dict]:
        with self._lock:
            return list(self._stalls)

    def stats(self) -> dict:
        with self._lock:
            return {"active": len(self._active),
                    "stall_count": self.stall_count,
                    "keys_learned": len(self._history),
                    "recent": list(self._stalls)}

    def clear(self):
        with self._lock:
            self._active.clear()
            self._history.clear()
            self._stalls.clear()
            self.stall_count = 0


profiler = ContinuousProfiler()
watchdog = StallWatchdog()
