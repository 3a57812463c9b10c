"""Metadata catalog: durable key-value schema/state registry.

Analog of GeoMesaMetadata (geomesa-index-api/.../metadata/
GeoMesaMetadata.scala:17 — typed key-value rows per feature type:
schema spec, index config, stats, table names) with the reference's
backends collapsed to two: in-memory (InMemoryMetadata of the test
datastore) and a JSON file directory (ZookeeperMetadata /
AccumuloBackedMetadata analog for a single-controller deployment).
Both cache reads (CachedLazyMetadata semantics) and support scan-by-
prefix.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator

__all__ = ["MetadataCatalog", "InMemoryMetadata", "FileMetadata"]

SCHEMA_KEY = "schema"        # GeoMesaMetadata.ATTRIBUTES_KEY analog
STATS_KEY_PREFIX = "stats"
VERSION_KEY = "version"


class MetadataCatalog:
    """Interface: per-type key-value metadata."""

    def read(self, type_name: str, key: str) -> str | None:
        raise NotImplementedError

    def insert(self, type_name: str, key: str, value: str):
        raise NotImplementedError

    def insert_many(self, type_name: str, kvs: dict):
        for k, v in kvs.items():
            self.insert(type_name, k, v)

    def remove(self, type_name: str, key: str):
        raise NotImplementedError

    def delete(self, type_name: str):
        """Drop all keys for a type."""
        raise NotImplementedError

    def get_type_names(self) -> list[str]:
        raise NotImplementedError

    def scan(self, type_name: str, prefix: str) -> Iterator[tuple[str, str]]:
        raise NotImplementedError

    def read_required(self, type_name: str, key: str) -> str:
        v = self.read(type_name, key)
        if v is None:
            raise KeyError(f"no metadata {key!r} for type {type_name!r}")
        return v


class InMemoryMetadata(MetadataCatalog):
    def __init__(self):
        self._data: dict[str, dict[str, str]] = {}
        self._lock = threading.Lock()

    def read(self, type_name, key):
        return self._data.get(type_name, {}).get(key)

    def insert(self, type_name, key, value):
        with self._lock:
            self._data.setdefault(type_name, {})[key] = str(value)

    def remove(self, type_name, key):
        with self._lock:
            self._data.get(type_name, {}).pop(key, None)

    def delete(self, type_name):
        with self._lock:
            self._data.pop(type_name, None)

    def get_type_names(self):
        return sorted(self._data)

    def scan(self, type_name, prefix):
        for k, v in sorted(self._data.get(type_name, {}).items()):
            if k.startswith(prefix):
                yield k, v


class FileMetadata(MetadataCatalog):
    """One JSON file per type under a root dir; writes are atomic
    (tmp + rename) and re-read when the mtime changes."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._cache: dict[str, tuple[tuple[int, int, int], dict]] = {}
        self._lock = threading.Lock()

    def _path(self, type_name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in type_name)
        return os.path.join(self.root, f"{safe}.json")

    def _load(self, type_name: str) -> dict:
        path = self._path(type_name)
        try:
            st = os.stat(path)
        except OSError:
            return {}
        # ns mtime + size + inode: a same-tick cross-process replace
        # (os.replace swaps in a new inode) still invalidates the cache
        stamp = (st.st_mtime_ns, st.st_size, st.st_ino)
        cached = self._cache.get(type_name)
        if cached and cached[0] == stamp:
            return cached[1]
        with open(path) as fh:
            data = json.load(fh)
        self._cache[type_name] = (stamp, data)
        return data

    def _store(self, type_name: str, data: dict):
        path = self._path(type_name)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self._cache.pop(type_name, None)

    def read(self, type_name, key):
        return self._load(type_name).get(key)

    def insert(self, type_name, key, value):
        with self._lock:
            data = dict(self._load(type_name))
            data[key] = str(value)
            self._store(type_name, data)

    def insert_many(self, type_name, kvs):
        with self._lock:
            data = dict(self._load(type_name))
            data.update({k: str(v) for k, v in kvs.items()})
            self._store(type_name, data)

    def remove(self, type_name, key):
        with self._lock:
            data = dict(self._load(type_name))
            if key in data:
                del data[key]
                self._store(type_name, data)

    def delete(self, type_name):
        with self._lock:
            path = self._path(type_name)
            if os.path.exists(path):
                os.remove(path)
            self._cache.pop(type_name, None)

    def get_type_names(self):
        return sorted(f[:-5] for f in os.listdir(self.root)
                      if f.endswith(".json"))

    def scan(self, type_name, prefix):
        for k, v in sorted(self._load(type_name).items()):
            if k.startswith(prefix):
                yield k, v
