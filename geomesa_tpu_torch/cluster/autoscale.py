"""SLO-driven autoscaler: close the loop from hot-shard signal to
online split.

The health plane (``obs/slo.py``) detects an error-budget burn; the breaker
board already tracks per-group leg latency EWMAs. This module
subscribes to both and turns a *sustained* hot-shard signal into a
``Resharder.split`` of the hot group's range — the reference's
"operator watches the dashboard and splits the tablet" loop with the
operator removed.

Decision rule per tick (``run_once``):

- a group is HOT when its leg p99 is at least
  ``geomesa.reshard.hot.factor`` x the median of the other groups'
  p99s (relative, so a uniformly slow cluster never splits — a split
  cannot help symmetric load);
- the signal must SUSTAIN for ``geomesa.reshard.hot.sustain.s``
  before acting (a single slow scatter is noise) — unless the SLO
  engine's fast burn is already firing, in which case the budget is
  actively draining and the sustain window is waived;
- execution is guarded: ``geomesa.reshard.enabled`` (kill switch),
  ``geomesa.reshard.auto`` (default FALSE — the loop only *proposes*
  until an operator opts in), the resharder's cooldown
  (``geomesa.reshard.cooldown.s``) and in-flight limit.

Every tick returns (and stores) a decision dict, so tests and the
bench drive the loop with an injected clock and assert on what it
decided, not on wall time.
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics
from ..utils.properties import SystemProperty
from .reshard import RESHARD_ENABLED, ReshardError

__all__ = ["Autoscaler", "RESHARD_AUTO", "RESHARD_HOT_FACTOR",
           "RESHARD_HOT_SUSTAIN_S", "RESHARD_INTERVAL_S"]

# act on decisions (default: observe + propose only)
RESHARD_AUTO = SystemProperty("geomesa.reshard.auto", "false")
# hot threshold: group p99 >= factor x median(other groups' p99)
RESHARD_HOT_FACTOR = SystemProperty("geomesa.reshard.hot.factor", "3.0")
# how long the hot signal must persist before acting
RESHARD_HOT_SUSTAIN_S = SystemProperty("geomesa.reshard.hot.sustain.s",
                                       "10")
# background loop tick interval
RESHARD_INTERVAL_S = SystemProperty("geomesa.reshard.interval.s", "5")
# absolute p99 floor below which a group is never "hot" (relative
# skew between two sub-millisecond groups is noise, not load)
RESHARD_HOT_MIN_MS = SystemProperty("geomesa.reshard.hot.min.ms", "5")


class Autoscaler:
    """Watches one cluster's per-group latency plane (+ the SLO burn
    engine) and proposes/executes splits through its ``Resharder``.
    ``clock`` is injectable; tests drive ``run_once(now=...)``."""

    def __init__(self, coord, resharder=None, slo=None,
                 clock=time.monotonic, registry=metrics):
        self._coord = coord
        self._resharder = resharder
        self._slo = slo
        self._clock = clock
        self._registry = registry
        self._hot_since: dict[str, float] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.last_decision: dict | None = None

    def _get_resharder(self):
        if self._resharder is None:
            self._resharder = self._coord.resharder
        return self._resharder

    def _slo_fast_burning(self, now: float) -> bool:
        """True when any route's fast burn is firing — the error
        budget is draining NOW, so the sustain window is waived."""
        engine = self._slo
        if engine is None:
            try:
                from ..obs.slo import slo_engine
                engine = slo_engine
            except Exception:  # noqa: BLE001 — advisory signal
                return False
        try:
            routes = engine.evaluate()
        except Exception:  # noqa: BLE001 — advisory signal
            return False
        return any(st.get("fast_firing") for st in (routes or {}).values())

    # -- the control loop --------------------------------------------------

    def observe(self) -> dict[str, float | None]:
        """Per-group leg p99 seconds (None before any observation)."""
        b = self._coord._breakers
        return {name: b.latency_p99_s(name) for name in self._coord._names}

    def run_once(self, now: float | None = None) -> dict:
        """One control tick: observe, detect, guard, (maybe) act.
        Returns the decision record."""
        now = self._clock() if now is None else float(now)
        decision: dict = {"ts": now, "action": "none", "executed": False}
        if not RESHARD_ENABLED.as_bool():
            decision["blocked"] = "geomesa.reshard.enabled=false"
            self.last_decision = decision
            return decision
        lat = self.observe()
        decision["p99_s"] = {k: (round(v, 6) if v is not None else None)
                             for k, v in lat.items()}
        hot = self._detect_hot(lat, now)
        if hot is None:
            self.last_decision = decision
            return decision
        name, p99, sustained_s = hot
        burning = self._slo_fast_burning(now)
        sustain_need = RESHARD_HOT_SUSTAIN_S.as_float() or 0.0
        decision.update({"action": "split", "group": name,
                         "hot_p99_s": round(p99, 6),
                         "sustained_s": round(sustained_s, 3),
                         "slo_fast_burning": burning})
        if sustained_s < sustain_need and not burning:
            decision["blocked"] = (f"sustain {sustained_s:.1f}s < "
                                   f"{sustain_need:g}s")
            self.last_decision = decision
            return decision
        self._registry.counter("cluster.reshard.auto.proposed")
        if not RESHARD_AUTO.as_bool():
            decision["blocked"] = "geomesa.reshard.auto=false (propose-only)"
            self.last_decision = decision
            return decision
        try:
            entry = self._get_resharder().split(name, reason="auto")
        except ReshardError as e:
            decision["blocked"] = str(e)
        else:
            decision["executed"] = True
            decision["result"] = entry
            self._hot_since.pop(name, None)
            self._registry.counter("cluster.reshard.auto.fired")
        self.last_decision = decision
        return decision

    def _detect_hot(self, lat: dict, now: float):
        """The hottest sustained group, or None. Tracks first-seen
        timestamps per group so sustain survives across ticks."""
        import statistics
        sampled = {k: v for k, v in lat.items() if v is not None}
        floor_s = (RESHARD_HOT_MIN_MS.as_float() or 0.0) / 1e3
        factor = RESHARD_HOT_FACTOR.as_float() or 3.0
        hot_name, hot_p99 = None, 0.0
        if len(sampled) >= 2:
            for name, p99 in sampled.items():
                others = [v for k, v in sampled.items() if k != name]
                med = statistics.median(others)
                if (p99 >= floor_s and med >= 0.0
                        and p99 >= factor * max(med, 1e-9)
                        and p99 > hot_p99):
                    hot_name, hot_p99 = name, p99
        # sustain bookkeeping: groups that cooled off reset
        for name in list(self._hot_since):
            if name != hot_name:
                del self._hot_since[name]
        if hot_name is None:
            return None
        since = self._hot_since.setdefault(hot_name, now)
        return hot_name, hot_p99, now - since

    # -- background loop ---------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        from ..utils.device import cuda_index, device_scope
        index = cuda_index(self._coord)

        def loop():
            with device_scope(index):
                while not self._stop.is_set():
                    try:
                        self.run_once()
                    except Exception:  # noqa: BLE001 — the loop survives
                        self._registry.counter("cluster.reshard.auto.errors")
                    self._stop.wait(RESHARD_INTERVAL_S.as_float() or 5.0)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cluster-autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
        self._thread = None

    def status(self) -> dict:
        return {"enabled": bool(RESHARD_ENABLED.as_bool()),
                "auto": bool(RESHARD_AUTO.as_bool()),
                "running": self._thread is not None
                and self._thread.is_alive(),
                "hot_factor": RESHARD_HOT_FACTOR.as_float(),
                "hot_sustain_s": RESHARD_HOT_SUSTAIN_S.as_float(),
                "p99_s": self.observe(),
                "last_decision": self.last_decision}
