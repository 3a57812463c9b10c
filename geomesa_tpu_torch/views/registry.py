"""Standing materialized views folded on every write-path commit.

``ViewRegistry`` hooks the store's mutation surface (``write`` /
``delete`` — the group-commit ingest pipeline and the base
``write_many`` both funnel through ``write``) with instance-attribute
wrappers: each commit's delta batch is WHERE-filtered and folded into
every registered view's per-group state under one fold lock, stamped
with the store's pushdown version/LSN, and the changed groups publish
as deltas on the ``view.<name>`` bus topic.

Reads serve through the store's LSN-keyed ``ResultCache`` at exact
versions, so the web tier gets ETag/304 for free. Durable stores
persist view state on every ``checkpoint()`` (a small O(groups) JSON
sidecar under the journal root, floats hex-encoded for bit exactness)
and restore it on reopen when the WAL LSN matches — a restart recovers
views without a full rebuild.

Kill switch: ``geomesa.views.enabled`` (default false). While off,
``register`` refuses and no hook ever installs — the write path is
bit-identical to a build without this module.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from ..filters import ast, evaluate
from ..index.api import Query
from ..metrics import metrics
from ..obs.trace import tracer
from ..utils.properties import SystemProperty
from .state import compile_view
from .subscribe import view_topic

__all__ = ["ViewRegistry", "MaterializedView", "VIEWS_ENABLED",
           "VIEW_RESERVOIR_K"]

VIEWS_ENABLED = SystemProperty("geomesa.views.enabled", "false")
VIEW_RESERVOIR_K = SystemProperty("geomesa.views.reservoir.k", "8")

_STATE_FILE = "views.json"


class MaterializedView:
    """One registered view: compiled state + maintenance counters."""

    def __init__(self, name: str, state):
        self.name = name
        self.state = state
        self.lsn = 0                # store version at the last fold
        self.folds = 0
        self.rows_folded = 0
        self.retraction_fallbacks = 0
        self.replays = 0
        self.pub_seq = 0            # per-view delta sequence (bus)

    def status(self, current_lsn: int | None = None) -> dict:
        out = {"name": self.name, "sql": self.state.sql,
               "table": self.state.table, "groups":
               len(self.state.groups), "lsn": self.lsn,
               "folds": self.folds, "rows_folded": self.rows_folded,
               "retraction_fallbacks": self.retraction_fallbacks,
               "replays": self.replays}
        if current_lsn is not None:
            out["lsn_lag"] = max(0, current_lsn - self.lsn)
        return out


class ViewRegistry:
    """Registry + write-path subscription for materialized views."""

    def __init__(self, store, bus=None, registry=metrics,
                 restore: bool = True):
        self.store = store
        self._explicit_bus = bus
        self._registry = registry
        self._views: dict[str, MaterializedView] = {}
        # one lock orders every fold, materialize and save; it nests
        # OUTSIDE the store's op lock (folds query the store)
        self._fold_lock = threading.RLock()
        self._orig: dict[str, object] = {}
        if restore and VIEWS_ENABLED.as_bool():
            self._restore()

    # -- plumbing -------------------------------------------------------------

    def _bus(self):
        if self._explicit_bus is not None:
            return self._explicit_bus
        bus = getattr(self.store, "bus", None)
        if bus is None:
            live = getattr(self.store, "_live", None)
            bus = getattr(live, "bus", None)
        return bus

    def _lsn(self, type_name: str) -> int:
        fn = getattr(self.store, "pushdown_version", None)
        return int(fn(type_name)) if fn is not None else 0

    def _journal(self):
        return getattr(self.store, "journal", None)

    def _state_path(self) -> str | None:
        j = self._journal()
        root = getattr(j, "root", None)
        return None if root is None else os.path.join(
            root, "views", _STATE_FILE)

    def _views_for(self, type_name: str) -> list[MaterializedView]:
        return [v for v in self._views.values()
                if v.state.table == type_name]

    # -- registration -----------------------------------------------------------

    def register(self, name: str, sql: str) -> MaterializedView:
        """Compile, build (one scan at the current LSN) and subscribe
        a view. Statement errors raise ``ValueError`` (``SqlError``)."""
        if not VIEWS_ENABLED.as_bool():
            raise ValueError("materialized views are disabled "
                             "(geomesa.views.enabled=false)")
        if not name or "/" in name or "." in name:
            raise ValueError(f"invalid view name {name!r}")
        with self._fold_lock:
            if name in self._views:
                raise ValueError(f"materialized view {name!r} exists")
            state = compile_view(
                self.store.get_schema(_table_of(sql)), sql)
            state.reservoir_k = VIEW_RESERVOIR_K.as_int()
            state.build(self.store)
            view = MaterializedView(name, state)
            view.lsn = self._lsn(state.table)
            self._views[name] = view
            self._install_hooks()
        self._registry.gauge("views.registered", len(self._views))
        return view

    def unregister(self, name: str) -> None:
        with self._fold_lock:
            if name not in self._views:
                raise KeyError(f"no such view: {name}")
            del self._views[name]
            if not self._views:
                self._uninstall_hooks()
            self._save_locked()
        self._registry.gauge("views.registered", len(self._views))

    def get(self, name: str) -> MaterializedView:
        v = self._views.get(name)
        if v is None:
            raise KeyError(f"no such view: {name}")
        return v

    def status(self) -> list[dict]:
        with self._fold_lock:
            return [v.status(self._lsn(v.state.table))
                    for _, v in sorted(self._views.items())]

    def refresh(self, name: str) -> dict:
        """Full re-execution (one scan) — the O(table) baseline the
        incremental folds replace; exposed for operators and benches."""
        with self._fold_lock:
            v = self.get(name)
            v.state.build(self.store)
            v.lsn = self._lsn(v.state.table)
            self._invalidate(v)
            return v.status(self._lsn(v.state.table))

    def close(self) -> None:
        with self._fold_lock:
            if self._views and self._state_path():
                self._save_locked()
            self._views.clear()
            self._uninstall_hooks()

    # -- reads ---------------------------------------------------------------------

    def result(self, name: str):
        """Materialize through the store's LSN-keyed result cache: an
        unchanged pushdown version serves the cached finalize (and the
        web tier's exact-version ETag/304)."""
        v = self.get(name)

        def compute():
            with self._fold_lock:
                before = v.replays
                v.replays += v.state.ensure_clean(self.store)
                if v.replays != before:
                    self._registry.counter(
                        "views.replays", v.replays - before)
                return v.state.result(self.store)

        rc = getattr(self.store, "result_cache", None)
        if rc is None:
            return compute()
        return rc.get_or_compute(
            v.state.table, f"view:{name}", compute,
            encode=lambda r: (list(r.names),
                              {k: c.copy() for k, c in r.columns.items()}),
            decode=lambda t: _decode_result(t))

    def _invalidate(self, view: MaterializedView) -> None:
        rc = getattr(self.store, "result_cache", None)
        if rc is not None:
            rc.invalidate(view.state.table)

    # -- write-path hooks -------------------------------------------------------------

    def _install_hooks(self) -> None:
        if self._orig:
            return
        store = self.store

        def hook(meth, wrapper):
            self._orig[meth] = getattr(store, meth)
            setattr(store, meth, wrapper)

        orig_write = store.write

        def write(type_name, batch, *a, **kw):
            with self._fold_lock:
                ret = orig_write(type_name, batch, *a, **kw)
                self._on_write(type_name, batch)
                return ret

        hook("write", write)
        orig_delete = store.delete

        def delete(type_name, ids, *a, **kw):
            with self._fold_lock:
                pre = self._pre_image(type_name, ids)
                ret = orig_delete(type_name, ids, *a, **kw)
                self._on_delete(type_name, pre)
                return ret

        hook("delete", delete)
        from ..store.api import DataStore
        if type(store).write_many is not DataStore.write_many:
            orig_wm = store.write_many

            def write_many(type_name, batches, *a, **kw):
                with self._fold_lock:
                    ret = orig_wm(type_name, batches, *a, **kw)
                    for b in batches:
                        batch = b[0] if isinstance(b, tuple) else b
                        self._on_write(type_name, batch)
                    return ret

            hook("write_many", write_many)
        if hasattr(store, "checkpoint"):
            orig_cp = store.checkpoint

            def checkpoint(*a, **kw):
                ret = orig_cp(*a, **kw)
                # save AFTER the mark: the stamp is the post-mark WAL
                # LSN, which a clean reopen reproduces exactly
                self.save()
                return ret

            hook("checkpoint", checkpoint)

    def _uninstall_hooks(self) -> None:
        for meth, orig in self._orig.items():
            setattr(self.store, meth, orig)
        self._orig = {}

    # -- folds ----------------------------------------------------------------------------

    def _on_write(self, type_name: str, batch) -> None:
        for v in self._views_for(type_name):
            with tracer.span("view-fold", v.name):
                mask = evaluate(v.state.where, batch)
                rows = np.flatnonzero(mask)
                changed = (v.state.fold_insert(batch, batch.ids, rows)
                           if len(rows) else set())
                self._stamp(v, type_name, len(rows))
                self._publish(v, changed, set())

    def _pre_image(self, type_name: str, ids):
        if not self._views_for(type_name):
            return None
        ids = tuple(str(i) for i in ids)
        if not ids:
            return None
        return self.store.query(
            Query(type_name, ast.FidFilter(ids)))

    def _on_delete(self, type_name: str, pre) -> None:
        if pre is None or pre.n == 0 or pre.batch is None:
            return
        for v in self._views_for(type_name):
            with tracer.span("view-fold", v.name):
                mask = evaluate(v.state.where, pre.batch)
                rows = np.flatnonzero(mask)
                if not len(rows):
                    self._stamp(v, type_name, 0)
                    continue
                changed, removed, fb = v.state.fold_delete(
                    pre.batch, pre.ids, rows)
                if fb:
                    v.retraction_fallbacks += fb
                    self._registry.counter(
                        "views.retraction.fallbacks", fb)
                self._stamp(v, type_name, len(rows))
                self._publish(v, changed, removed)

    def _stamp(self, v: MaterializedView, type_name: str,
               nrows: int) -> None:
        v.lsn = self._lsn(type_name)
        v.folds += 1
        v.rows_folded += nrows
        self._registry.counter("views.folds")
        if nrows:
            self._registry.counter("views.rows.folded", nrows)
        self._registry.gauge("views.staleness.lsn_lag", 0)

    # -- delta publishing ---------------------------------------------------------------------

    def _publish(self, v: MaterializedView, changed: set,
                 removed: set) -> None:
        if not changed and not removed:
            return
        bus = self._bus()
        if bus is None:
            return
        replays = v.state.ensure_clean(self.store)
        if replays:
            v.replays += replays
            self._registry.counter("views.replays", replays)
        rows = []
        for kt in sorted(changed & set(v.state.groups),
                         key=lambda k: tuple((x is None, x) for x in k)):
            g = v.state.groups[kt]
            rows.append({"key": [_enc_json(x) for x in kt],
                         "row": {n: _enc_json(x) for n, x
                                 in v.state.group_row(g).items()}})
        gone = [[_enc_json(x) for x in kt]
                for kt in sorted(removed,
                                 key=lambda k: tuple((x is None, x)
                                                     for x in k))]
        payload = {"view": v.name, "lsn": v.lsn, "seq": v.pub_seq,
                   "rows": rows, "removed": gone}
        from ..store.live import GeoMessage
        msg = GeoMessage("view", v.state.table, None,
                         ids=(json.dumps(payload),),
                         timestamp_ms=int(time.time() * 1000))
        try:
            bus.publish(view_topic(v.name), msg)
            v.pub_seq += 1
            self._registry.counter("views.deltas.published")
        except Exception:
            self._registry.counter("views.deltas.publish_errors")

    # -- durability ------------------------------------------------------------------------------

    def save(self) -> str | None:
        with self._fold_lock:
            return self._save_locked()

    def _save_locked(self) -> str | None:
        path = self._state_path()
        if path is None:
            return None
        j = self._journal()
        blobs = []
        for name, v in sorted(self._views.items()):
            v.replays += v.state.ensure_clean(self.store)
            blobs.append({"name": name, "sql": v.state.sql,
                          "lsn": v.lsn,
                          "stamp": int(j.wal.last_lsn),
                          "state": v.state.to_blob()})
        from ..store.filebus import write_json_atomic
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_json_atomic(path, {"views": blobs})
        return path

    def _restore(self) -> None:
        path = self._state_path()
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            self._registry.counter("views.recovery.corrupt")
            return
        j = self._journal()
        current = int(j.wal.last_lsn) if j is not None else -1
        with self._fold_lock:
            for blob in doc.get("views", []):
                name = blob["name"]
                try:
                    state = compile_view(
                        self.store.get_schema(_table_of(blob["sql"])),
                        blob["sql"])
                except (KeyError, ValueError):
                    self._registry.counter("views.recovery.dropped")
                    continue
                state.reservoir_k = VIEW_RESERVOIR_K.as_int()
                view = MaterializedView(name, state)
                if int(blob.get("stamp", -2)) == current:
                    state.from_blob(blob["state"])
                    view.lsn = int(blob["lsn"])
                    self._registry.counter("views.recovery.restored")
                else:
                    # writes landed after the last save: the sidecar
                    # is stale, rebuild from the recovered store
                    state.build(self.store)
                    view.lsn = self._lsn(state.table)
                    self._registry.counter("views.recovery.rebuilt")
                self._views[name] = view
            if self._views:
                self._install_hooks()
        self._registry.gauge("views.registered", len(self._views))


def _table_of(sql: str) -> str:
    from ..sql.parser import parse_sql
    return parse_sql(sql).table


def _decode_result(t):
    from ..sql.engine import SqlResult
    names, cols = t
    return SqlResult(list(names), {k: c.copy() for k, c in cols.items()})


def _enc_json(v):
    """JSON-safe scalar: numpy scalars unwrap, geometries go WKT."""
    if isinstance(v, np.generic):
        v = v.item()
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    from ..geometry.base import Geometry
    if isinstance(v, Geometry):
        from ..geometry import to_wkt
        return to_wkt(v)
    return repr(v)
