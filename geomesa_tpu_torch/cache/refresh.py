"""Background hot-tile refresher.

After writes advance a type's version, the hottest cached tiles are
stale, and steady-state viewers would each pay one cold recompute. The
refresher re-materializes the top-K hottest stale entries on a cadence
(``geomesa.cache.refresh.interval.s``; 0 disables the loop), so the
serving path stays all hits under sustained writes. ``run_once()`` is
the synchronous unit (tests and operators call it directly).
"""

from __future__ import annotations

import threading
import time

from ..metrics import metrics
from ..utils.properties import SystemProperty

__all__ = ["CacheRefresher", "CACHE_REFRESH_INTERVAL_S",
           "CACHE_REFRESH_TOP_K"]

# refresh cadence (seconds) for the background loop; 0 = off
CACHE_REFRESH_INTERVAL_S = SystemProperty("geomesa.cache.refresh.interval.s",
                                          "0")
# how many of the hottest entries one pass re-materializes
CACHE_REFRESH_TOP_K = SystemProperty("geomesa.cache.refresh.top.k", "8")


class CacheRefresher:
    """Periodic re-materializer for a store's ``result_cache``.

    ``CacheRefresher(store).start()`` refreshes on the property's
    cadence; ``run_once()`` is one synchronous pass."""

    def __init__(self, store=None, cache=None, interval_s: float | None = None,
                 top_k: int | None = None, registry=metrics):
        if cache is None:
            cache = getattr(store, "result_cache", None)
        if cache is None:
            raise ValueError("cache refresher needs a store exposing "
                             "result_cache (or an explicit cache)")
        self.cache = cache
        self.interval_s = float(
            interval_s if interval_s is not None
            else (CACHE_REFRESH_INTERVAL_S.as_float() or 0.0))
        self.top_k = int(top_k if top_k is not None
                         else (CACHE_REFRESH_TOP_K.as_int() or 8))
        self.registry = registry
        self.runs = 0
        self.last_refreshed = 0
        self.last_seconds = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CacheRefresher":
        if self.interval_s <= 0:
            return self   # loop disabled; run_once() stays available
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cache-refresher")
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
                # a refresh pass must never take the process down
                self.registry.counter("cache.refresh.crashes")

    # -- one pass ----------------------------------------------------------

    def run_once(self) -> dict:
        t0 = time.perf_counter()
        n = self.cache.refresh_hot(self.top_k)
        self.runs += 1
        self.last_refreshed = n
        self.last_seconds = round(time.perf_counter() - t0, 4)
        return {"refreshed": n, "runs": self.runs, "top_k": self.top_k,
                "seconds": self.last_seconds}

    def status(self) -> dict:
        return {"running": bool(self._thread is not None
                                and self._thread.is_alive()),
                "interval_s": self.interval_s,
                "top_k": self.top_k,
                "runs": self.runs,
                "last_refreshed": self.last_refreshed,
                "last_seconds": self.last_seconds}
