"""Enrichment caches: lookup tables usable from transform expressions
(geomesa-convert EnrichmentCache analog — the reference backs these with
redis/simple maps; here a process-local registry keyed by name).

    register_cache("vessels", {"123": {"flag": "US", "class": "cargo"}})
    # in a transform:  cacheLookup('vessels', $1, 'flag')
"""

from __future__ import annotations

import csv
from typing import Any

__all__ = ["register_cache", "get_cache", "clear_caches", "load_csv_cache",
           "EnrichmentCache"]

_CACHES: dict[str, "EnrichmentCache"] = {}


class EnrichmentCache:
    def __init__(self, data: dict[str, dict[str, Any]]):
        self._data = dict(data)

    def lookup(self, key, field: str | None = None):
        row = self._data.get(str(key))
        if row is None:
            return None
        if field is None:
            return row
        return row.get(field) if isinstance(row, dict) else row

    def __len__(self) -> int:
        return len(self._data)


def register_cache(name: str, data: dict) -> EnrichmentCache:
    cache = data if isinstance(data, EnrichmentCache) \
        else EnrichmentCache(data)
    _CACHES[name] = cache
    return cache


def get_cache(name: str) -> EnrichmentCache:
    if name not in _CACHES:
        raise KeyError(f"no enrichment cache {name!r} registered")
    return _CACHES[name]


def clear_caches():
    _CACHES.clear()


def load_csv_cache(name: str, path: str, key_column: str) -> EnrichmentCache:
    """Register a cache from a CSV with a header row."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    return register_cache(name, {str(r[key_column]): r for r in rows})


def cache_lookup(name, key, field=None):
    """The cacheLookup() DSL function."""
    return get_cache(str(name)).lookup(key, None if field is None
                                       else str(field))
