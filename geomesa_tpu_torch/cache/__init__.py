"""LSN-keyed materialized pushdown-result cache.

The write-ahead log gives every durable store an exact version counter
(``Journal.wal.last_lsn``; a store-local mutation counter otherwise), so
pushdown results (density grids, stat sketches, BIN buffers, Arrow IPC
payloads) can be memoized provably fresh: an entry is keyed
``(type_name, canonical plan key)`` and stamped with the type's version
at compute time. A write advancing the version makes stale entries
unreachable by key; an unchanged version returns the memoized payload
without touching the device.
"""

from .keys import (arrow_key, bin_key, canonical_filter, density_key,
                   stats_key)
from .refresh import (CACHE_REFRESH_INTERVAL_S, CACHE_REFRESH_TOP_K,
                      CacheRefresher)
from .result_cache import CACHE_ENABLED, CACHE_MAX_BYTES, ResultCache

__all__ = [
    "ResultCache", "CacheRefresher",
    "canonical_filter", "density_key", "stats_key", "bin_key", "arrow_key",
    "CACHE_ENABLED", "CACHE_MAX_BYTES",
    "CACHE_REFRESH_INTERVAL_S", "CACHE_REFRESH_TOP_K",
]
