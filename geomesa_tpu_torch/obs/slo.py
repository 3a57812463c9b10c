"""SLO burn-rate engine: multi-window multi-burn-rate alerting.

Declarative service-level objectives per route/surface (availability
and a latency objective), evaluated the way the SRE workbook's
multiwindow multi-burn-rate recipe prescribes:

- **burn rate** = (observed bad fraction) / (error budget), where the
  budget is ``1 - objective``. Burn 1.0 spends exactly the budget over
  the SLO period; burn 14.4 spends 2% of a 30-day budget in one hour.
- **fast burn** (page): burn >= 14.4 on BOTH the 5m and 1h windows —
  the short window makes the alert reset quickly once the bleeding
  stops, the long window keeps a blip from paging.
- **slow burn** (ticket): burn >= 1.0 on BOTH the 6h and 3d windows —
  a sustained trickle that will exhaust the budget, invisible to the
  fast rule.

Events are folded into two bucket rings per series (1s x 1h fine ring
for the fast windows, 60s x 3d coarse ring for the slow ones), so
``record`` is O(1) and a window sum is a bounded slot scan. The clock
is injectable and every entry point takes an explicit ``now`` — the
burn math is testable against synthetic streams with zero sleeps.

Closing the loop (``geomesa.slo.react``, default OFF): while any fast
burn fires, admission tightens — the shared retry/hedge budgets scale
down (``geomesa.retry.budget.scale``), the batcher linger ceiling
drops, and ingest shedding gets more sensitive. The pre-reaction
override state of every touched knob is saved and restored EXACTLY
when the burn clears.

Knobs: ``geomesa.slo.enabled``, ``geomesa.slo.availability.target``
(0.999), ``geomesa.slo.latency.ms`` (500) + ``geomesa.slo.latency.target``
(0.99), ``geomesa.slo.windows.fast`` ("300:3600:14.4"),
``geomesa.slo.windows.slow`` ("21600:259200:1.0"),
``geomesa.slo.min.events`` (12), ``geomesa.slo.react`` (false),
``geomesa.slo.react.factor`` (4), ``geomesa.slo.max.routes`` (64).

``status()`` is the ``/rest/slo`` document; ``slo.burn``/``slo.alert``
gauges carry the same state, and alert transitions count
``slo.alerts.fired`` / ``.cleared``.
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics, sanitize_key
from ..utils.properties import SystemProperty

__all__ = ["SloEngine", "slo_engine", "SLO_ENABLED", "SLO_REACT",
           "SLO_AVAILABILITY_TARGET", "SLO_LATENCY_MS",
           "SLO_LATENCY_TARGET", "SLO_WINDOWS_FAST", "SLO_WINDOWS_SLOW",
           "SLO_MIN_EVENTS", "SLO_REACT_FACTOR", "SLO_MAX_ROUTES"]

SLO_ENABLED = SystemProperty("geomesa.slo.enabled", "true")
SLO_AVAILABILITY_TARGET = SystemProperty(
    "geomesa.slo.availability.target", "0.999")
SLO_LATENCY_MS = SystemProperty("geomesa.slo.latency.ms", "500")
SLO_LATENCY_TARGET = SystemProperty("geomesa.slo.latency.target", "0.99")
# "short:long:threshold" (seconds, seconds, burn multiple)
SLO_WINDOWS_FAST = SystemProperty("geomesa.slo.windows.fast",
                                  "300:3600:14.4")
SLO_WINDOWS_SLOW = SystemProperty("geomesa.slo.windows.slow",
                                  "21600:259200:1.0")
# a rule needs this many events in its SHORT window before it may
# fire: one failed request out of one must not page anybody
SLO_MIN_EVENTS = SystemProperty("geomesa.slo.min.events", "12")
SLO_REACT = SystemProperty("geomesa.slo.react", "false")
SLO_REACT_FACTOR = SystemProperty("geomesa.slo.react.factor", "4")
SLO_MAX_ROUTES = SystemProperty("geomesa.slo.max.routes", "64")


def _parse_windows(raw, default: tuple[float, float, float]):
    try:
        s, l, b = str(raw).split(":")
        s, l, b = float(s), float(l), float(b)
        if s <= 0 or l < s or b <= 0:
            return default
        return (s, l, b)
    except (TypeError, ValueError, AttributeError):
        return default


class _Ring:
    """Fixed ring of time buckets, each ``res_s`` wide, holding
    (total, errors, slow) event counts. Slots are lazily invalidated:
    a write into a slot whose bucket epoch moved on resets it, so no
    sweeper thread is needed and a fake clock works unmodified."""

    __slots__ = ("res", "n", "epoch", "total", "err", "slow")

    def __init__(self, res_s: int, slots: int):
        self.res = int(res_s)
        self.n = int(slots)
        self.epoch = [-1] * self.n
        self.total = [0] * self.n
        self.err = [0] * self.n
        self.slow = [0] * self.n

    def span_s(self) -> float:
        return float(self.res * self.n)

    def add(self, now: float, err: int, slow: int):
        b = int(now // self.res)
        i = b % self.n
        if self.epoch[i] != b:
            self.epoch[i] = b
            self.total[i] = 0
            self.err[i] = 0
            self.slow[i] = 0
        self.total[i] += 1
        self.err[i] += err
        self.slow[i] += slow

    def sums(self, now: float, window_s: float) -> tuple[int, int, int]:
        b_now = int(now // self.res)
        b_min = int((now - window_s) // self.res)
        tot = err = slow = 0
        for i in range(self.n):
            e = self.epoch[i]
            if b_min < e <= b_now:
                tot += self.total[i]
                err += self.err[i]
                slow += self.slow[i]
        return tot, err, slow


class _Series:
    """One tracked route/surface: its objectives, its event rings, and
    its alert state machine (fast + slow burn rules, each needing both
    of its windows over threshold to FIRE and only the short window
    under threshold to CLEAR)."""

    def __init__(self, route: str):
        self.route = route
        self.fine = _Ring(1, 3600)       # covers fast windows (<= 1h)
        self.coarse = _Ring(60, 4320)    # covers slow windows (<= 3d)
        self.fast_firing = False
        self.slow_firing = False
        self.fast_since: float | None = None
        self.slow_since: float | None = None
        self.events = 0

    def record(self, now: float, ok: bool, latency_s: float,
               lat_thresh_s: float):
        err = 0 if ok else 1
        slow = 1 if latency_s > lat_thresh_s else 0
        self.fine.add(now, err, slow)
        self.coarse.add(now, err, slow)
        self.events += 1

    def _ring_for(self, window_s: float) -> _Ring:
        return self.fine if window_s <= self.fine.span_s() else self.coarse

    def burn(self, now: float, window_s: float, kind: str,
             budget: float) -> tuple[float, int]:
        """(burn rate, events in window) for one window/objective."""
        tot, err, slow = self._ring_for(window_s).sums(now, window_s)
        if tot == 0:
            return 0.0, 0
        bad = err if kind == "availability" else slow
        return (bad / tot) / max(budget, 1e-9), tot

    def evaluate(self, now: float, fast: tuple, slow: tuple,
                 budgets: dict[str, float], min_events: int) -> dict:
        fs, fl, fb = fast
        ss, sl, sb = slow
        burns: dict[str, dict[str, float]] = {}
        fast_fire = fast_hold = False
        slow_fire = slow_hold = False
        for kind, budget in budgets.items():
            b_fs, n_fs = self.burn(now, fs, kind, budget)
            b_fl, _ = self.burn(now, fl, kind, budget)
            b_ss, n_ss = self.burn(now, ss, kind, budget)
            b_sl, _ = self.burn(now, sl, kind, budget)
            burns[kind] = {f"{int(fs)}s": round(b_fs, 4),
                           f"{int(fl)}s": round(b_fl, 4),
                           f"{int(ss)}s": round(b_ss, 4),
                           f"{int(sl)}s": round(b_sl, 4)}
            if b_fs >= fb and b_fl >= fb and n_fs >= min_events:
                fast_fire = True
            if b_fs >= fb:
                fast_hold = True   # short window still burning: no clear
            if b_ss >= sb and b_sl >= sb and n_ss >= min_events:
                slow_fire = True
            if b_ss >= sb:
                slow_hold = True
        transitions = []
        if not self.fast_firing and fast_fire:
            self.fast_firing, self.fast_since = True, now
            transitions.append(("fast-burn", "fired"))
        elif self.fast_firing and not fast_hold:
            self.fast_firing, self.fast_since = False, None
            transitions.append(("fast-burn", "cleared"))
        if not self.slow_firing and slow_fire:
            self.slow_firing, self.slow_since = True, now
            transitions.append(("slow-burn", "fired"))
        elif self.slow_firing and not slow_hold:
            self.slow_firing, self.slow_since = False, None
            transitions.append(("slow-burn", "cleared"))
        alert = ("fast-burn" if self.fast_firing
                 else "slow-burn" if self.slow_firing else "ok")
        return {"alert": alert, "fast_firing": self.fast_firing,
                "slow_firing": self.slow_firing, "burn": burns,
                "events": self.events, "_transitions": transitions}


class _Reaction:
    """The admission-tightening loop behind ``geomesa.slo.react``.

    Engage saves the process-wide override state of every knob it will
    touch (``SystemProperty.get_override`` — the override LAYER, not
    the resolved value), then tightens; restore puts each override
    back exactly, including the not-set state."""

    def __init__(self, registry=metrics):
        self._registry = registry
        self._saved: dict[str, str | None] | None = None
        self._lock = threading.Lock()

    @property
    def engaged(self) -> bool:
        return self._saved is not None

    def _knobs(self):
        # lazy imports: the serving-layer modules import obs for
        # tracing, so obs.slo must not import them at module load. The
        # ingest shed threshold lives in utils.properties, beside the
        # pipeline that reads it.
        from ..resilience.policy import RETRY_BUDGET_SCALE
        from ..scan.batcher import BATCH_LINGER_MICROS
        from ..utils.properties import INGEST_SHED_QUEUE_DEPTH
        return (RETRY_BUDGET_SCALE, BATCH_LINGER_MICROS,
                INGEST_SHED_QUEUE_DEPTH)

    def apply(self, firing: bool):
        react = str(SLO_REACT.get()).lower() in ("true", "1", "yes")
        with self._lock:
            if firing and react and self._saved is None:
                self._engage()
            elif self._saved is not None and (not firing or not react):
                self._restore()

    def _engage(self):
        try:
            factor = max(float(SLO_REACT_FACTOR.get() or 4.0), 1.0)
        except (TypeError, ValueError):
            factor = 4.0
        scale_p, linger_p, shed_p = self._knobs()
        self._saved = {p.name: p.get_override()
                       for p in (scale_p, linger_p, shed_p)}
        scale_p.set(f"{1.0 / factor:g}")
        linger = linger_p.as_float() or 2000.0
        linger_p.set(f"{linger / factor:g}")
        shed = shed_p.as_int() or 64
        shed_p.set(str(max(1, int(shed // factor))))
        self._registry.counter("slo.react.engaged")
        self._registry.gauge("slo.react.active", 1)

    def _restore(self):
        for prop in self._knobs():
            if prop.name in self._saved:
                prop.set(self._saved[prop.name])
        self._saved = None
        self._registry.counter("slo.react.restored")
        self._registry.gauge("slo.react.active", 0)


class SloEngine:
    """Per-route SLO tracker + burn-rate evaluator. ``record`` is the
    hot path (two ring adds under one lock); evaluation piggybacks on
    records at most every ``_EVAL_EVERY_S`` or runs explicitly via
    ``evaluate(now)`` (the fake-clock test entry point)."""

    _EVAL_EVERY_S = 0.5

    def __init__(self, clock=time.time, registry=metrics, reaction=None):
        self._clock = clock
        self._registry = registry
        self._lock = threading.RLock()
        self._series: dict[str, _Series] = {}
        self._reaction = reaction if reaction is not None \
            else _Reaction(registry)
        self._last_eval = float("-inf")

    @staticmethod
    def enabled() -> bool:
        return str(SLO_ENABLED.get()).lower() in ("true", "1", "yes")

    # -- recording ---------------------------------------------------------

    def record(self, route: str, ok: bool, latency_s: float,
               now: float | None = None, tenant: str | None = None):
        if not self.enabled():
            return
        if now is None:
            now = self._clock()
        lat_s = (SLO_LATENCY_MS.as_float() or 500.0) / 1e3
        route = sanitize_key(route)
        with self._lock:
            self._record_locked(route, now, ok, latency_s, lat_s)
            if tenant is not None:
                # per-tenant SLO series ride the same route rings under
                # a derived name; the max-routes cap (collapse to
                # "other") bounds tenant-driven cardinality
                self._record_locked(
                    f"{route}.tenant.{sanitize_key(str(tenant))}",
                    now, ok, latency_s, lat_s)
            due = now - self._last_eval >= self._EVAL_EVERY_S
        if due:
            self.evaluate(now)

    def _record_locked(self, route: str, now: float, ok: bool,
                       latency_s: float, lat_s: float):
        s = self._series.get(route)
        if s is None:
            try:
                cap = int(SLO_MAX_ROUTES.get() or 64)
            except (TypeError, ValueError):
                cap = 64
            if len(self._series) >= cap:
                route = "other"
            s = self._series.setdefault(route, _Series(route))
        s.record(now, ok, latency_s, lat_s)

    # -- evaluation --------------------------------------------------------

    def _budgets(self) -> dict[str, float]:
        avail = SLO_AVAILABILITY_TARGET.as_float() or 0.999
        lat = SLO_LATENCY_TARGET.as_float() or 0.99
        return {"availability": max(1.0 - avail, 1e-9),
                "latency": max(1.0 - lat, 1e-9)}

    def evaluate(self, now: float | None = None) -> dict:
        """Run every series' state machine at ``now`` and publish the
        gauges; returns the per-route states."""
        if now is None:
            now = self._clock()
        fast = _parse_windows(SLO_WINDOWS_FAST.get(), (300.0, 3600.0, 14.4))
        slow = _parse_windows(SLO_WINDOWS_SLOW.get(),
                              (21600.0, 259200.0, 1.0))
        min_events = SLO_MIN_EVENTS.as_int()
        if min_events is None:
            min_events = 12
        budgets = self._budgets()
        out: dict[str, dict] = {}
        any_fast = False
        with self._lock:
            self._last_eval = now
            for route, s in self._series.items():
                st = s.evaluate(now, fast, slow, budgets, min_events)
                any_fast |= st["fast_firing"]
                for kind, wins in st["burn"].items():
                    for win, val in wins.items():
                        self._registry.gauge(
                            "slo.burn", val,
                            labels={"route": route, "slo": kind,
                                    "window": win})
                self._registry.gauge(
                    "slo.alert",
                    2 if st["fast_firing"] else
                    1 if st["slow_firing"] else 0,
                    labels={"route": route})
                for rule, what in st.pop("_transitions"):
                    self._registry.counter(
                        f"slo.alerts.{what}",
                        labels={"route": route, "rule": rule})
                out[route] = st
        self._reaction.apply(any_fast)
        return out

    # -- surfaces ----------------------------------------------------------

    def status(self, now: float | None = None) -> dict:
        """The ``GET /rest/slo`` document: objectives, window config,
        reaction state, and every route's live burn/alert state."""
        fast = _parse_windows(SLO_WINDOWS_FAST.get(), (300.0, 3600.0, 14.4))
        slow = _parse_windows(SLO_WINDOWS_SLOW.get(),
                              (21600.0, 259200.0, 1.0))
        routes = self.evaluate(now) if self.enabled() else {}
        return {
            "enabled": self.enabled(),
            "objectives": {
                "availability_target":
                    SLO_AVAILABILITY_TARGET.as_float() or 0.999,
                "latency_ms": SLO_LATENCY_MS.as_float() or 500.0,
                "latency_target": SLO_LATENCY_TARGET.as_float() or 0.99,
            },
            "windows": {"fast": list(fast), "slow": list(slow)},
            "react": {
                "configured":
                    str(SLO_REACT.get()).lower() in ("true", "1", "yes"),
                "engaged": self._reaction.engaged,
            },
            "routes": routes,
        }

    def clear(self):
        """Drop all series and disengage any reaction (test/bench
        hygiene between phases)."""
        with self._lock:
            self._series.clear()
            self._last_eval = float("-inf")
        self._reaction.apply(False)


slo_engine = SloEngine()
