"""REST endpoints over a datastore (geomesa-web analog), the port's copy.

The same servlet surface as the reference (geomesa-web-core
SpringScalatraBootstrap.scala:69, DataEndpoint, GeoMesaStatsEndpoint
web/stats/GeoMesaStatsEndpoint.scala:30, QueryAuditEndpoint) on the
stdlib http server, no framework dependency, with the same routes,
status codes, headers and JSON bodies as ``geomesa_tpu.web.server``:

    GET  /rest/version
    GET  /rest/schemas                      -> ["type", ...]
    POST /rest/schemas/{type}   body=spec   -> create schema
    GET  /rest/schemas/{type}               -> {"name":..., "spec":...}
    DELETE /rest/schemas/{type}
    GET  /rest/query/{type}?cql=&maxFeatures=&sortBy=&sortOrder=
         &sampling=&sampleBy=&index=&auths=
         &format=json|geojson|arrow|arrow-stream|bin
    GET  /rest/count/{type}?cql=            POST /rest/write/{type}
    POST /rest/delete/{type}                GET  /rest/estimate/{type}
    GET  /rest/knn/{type}?x=&y=&k=          -> {"ids": [...],
                                                "distances": [...]}
    GET  /rest/stats/{type}?stat=MinMax(attr)&cql=
    GET  /rest/density/{type}?bbox=x0,y0,x1,y1&width=&height=&cql=
    GET  /rest/bin/{type}?cql=&track=&label=&sort=   -> BIN bytes
    GET  /rest/metrics, /rest/runtime, /rest/slo, /rest/qos,
         /rest/profile, /rest/trace[/{id}]
    GET  /rest/cache                        POST /rest/cache/invalidate
    GET  /rest/cq                           POST /rest/cq/register|unregister
    GET  /rest/sql?q=SELECT...  (or POST /rest/sql; ?mode=partial,
         POST /rest/sql/join-partial: the distributed legs)
    GET  /rest/audit?type=&since=
    GET  /rest/wal                          POST /rest/wal/checkpoint|truncate
    GET  /rest/integrity                    POST /rest/integrity/scrub
    POST /rest/reindex/{type}?version=
    GET  /rest/evolve                       POST /rest/evolve/reindex|update|
                                                 resume|abort
    GET  /rest/views[/{name}]               POST /rest/views/register|
                                                 unregister|refresh
    GET  /rest/replication, /rest/cluster, /rest/topology, /rest/reshard
         (404 on a store without the role)
    GET  /rest/health                       -> liveness (always 200)
    GET  /rest/ready                        -> readiness (503 if the
         store is unreachable or the server is shedding load)

The server serves the store it is given where its rows are: an
``InMemoryDataStore()`` keeps them on the CUDA card, and every request
thread runs with the store's card as its current CUDA device, so a
kernel a request launches goes to the card that holds the columns.
Nothing here moves a store or a tensor to the host; the host gets the
result's ids and columns as the store hands them back.

Conditional requests: GET /rest/density, /rest/stats and /rest/bin
carry an ETag derived from (canonical plan key, pushdown version) when
the store exposes an exact version (``pushdown_version``); a matching
If-None-Match gets 304 with no body. Stores without a single exact
version send no ETag.

Fault surface (resilience layer):

- `geomesa.web.max.inflight` (unset = unlimited) caps concurrent
  requests; excess requests are SHED with 503 + Retry-After before any
  handler runs, so a retried shed is duplicate-safe even for writes.
- Status codes distinguish retryability for clients: parse/plan errors
  (ValueError, CQL/filter parse) are 400 (don't retry), unknown types
  404, a poisoned journal 503, unexpected handler faults 500 (retryable
  on idempotent calls; counted in `resilience.web.errors`).
- A client that disconnects mid-response (BrokenPipeError) is counted
  (`resilience.web.client_disconnects`), not traceback-dumped.
"""

from __future__ import annotations

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from .. import __version__ as _version
from ..index.api import Query, QueryHints
from ..metrics import metrics
from ..utils.device import cuda_index, device_scope
from ..utils.properties import SystemProperty
from ..wal.log import DurabilityError

__all__ = ["GeoMesaWebServer"]

# opt-in shared bearer token for the mutating endpoints (POST
# /rest/write, POST /rest/delete, DELETE /rest/schemas). Unset -> those
# endpoints stay open (embedded/test deployments); set -> requests
# without `Authorization: Bearer <token>` get 403.
WEB_AUTH_TOKEN = SystemProperty("geomesa.web.auth.token", None)

# the endpoints the shared token gates: (method, first path segment) —
# POST /rest/wal/* are the WAL admin mutations (checkpoint/truncate);
# GET /rest/wal stays open (read-only stats)
_GATED = {("POST", "write"), ("POST", "delete"), ("DELETE", "schemas"),
          ("POST", "wal"), ("POST", "replication"), ("POST", "integrity"),
          ("POST", "cluster"), ("POST", "cache"), ("POST", "cq"),
          ("POST", "reshard"), ("POST", "views"), ("POST", "reindex"),
          ("POST", "evolve")}

# load-shedding gate: max concurrent in-flight requests (unset ->
# unlimited). Requests over the cap get 503 + Retry-After BEFORE any
# handler state changes, so clients may retry them safely.
WEB_MAX_INFLIGHT = SystemProperty("geomesa.web.max.inflight", None)
# label web.request series with the caller's principal digest (the
# first step toward per-tenant QoS accounting). Default off: it
# multiplies series cardinality by the tenant count — the registry's
# geomesa.metrics.max.series guard bounds the blast radius when on
WEB_METRICS_PRINCIPAL = SystemProperty("geomesa.metrics.principal",
                                       "false")
# the Retry-After hint (seconds) a shed response carries
WEB_RETRY_AFTER = SystemProperty("geomesa.web.retry.after.s", "1")

# route POST /rest/write through the process ingest pipeline: writes
# from concurrent clients coalesce into group commits (one WAL append /
# fsync decision per fused group), and admission control applies — a
# full in-flight-rows bucket or a deep read-batcher backlog answers
# 429 + Retry-After BEFORE the batch is staged, so a retry is
# duplicate-safe (ingest/pipeline.py)
WEB_INGEST_PIPELINE = SystemProperty("geomesa.ingest.web.pipeline", "true")


class GeoMesaWebServer:
    """Bind a datastore to an HTTP port. ``start()`` serves on a daemon
    thread (tests/notebooks); ``serve_forever()`` blocks (CLI).

    Concurrent ``/rest/query`` requests ride ThreadingHTTPServer's
    thread-per-request model into a QueryBatcher: requests for the same
    schema arriving within the linger window share ONE fused device
    scan (scan/batcher.py).

    ``GeoMesaWebServer(InMemoryDataStore())`` serves a store on the
    card; ``GeoMesaWebServer(InMemoryDataStore(device="cpu"))`` one on
    the host, when the caller asks for it."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 audit=None, auth_token: str | None = None,
                 batcher=None, max_inflight: int | None = None,
                 cq=None, views=None):
        from ..scan.registry import shared_batcher
        self.store = store
        # continuous-query publisher behind /rest/cq: pass one in, or
        # the first POST /rest/cq/register creates it lazily (needs a
        # store with a mutation bus)
        self.cq = cq
        self._owns_cq = False
        # materialized-view registry behind /rest/views: pass one in
        # (a store may only have ONE registry hooking its write path),
        # or the first /rest/views request creates it lazily
        self.views = views
        self._owns_views = False
        self._cuda_index = cuda_index(store)
        self.audit = audit if audit is not None \
            else getattr(store, "audit", None)
        self.auth_token = (auth_token if auth_token is not None
                           else WEB_AUTH_TOKEN.get())
        if batcher is None and hasattr(store, "query_batched"):
            # process-wide registry, not a private instance: embedded
            # callers using shared_batcher(store) coalesce into the
            # SAME fused dispatches as web requests and share one
            # warmed plan cache (scan/registry.py)
            batcher = shared_batcher(store)
        self.batcher = batcher
        self.max_inflight = (max_inflight if max_inflight is not None
                             else WEB_MAX_INFLIGHT.as_int())
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # lazy group-commit write plane (first POST /rest/write when
        # geomesa.ingest.web.pipeline is on)
        self._ingest_pipeline = None
        self._ingest_lock = threading.Lock()
        self._started_at = time.monotonic()
        # background hot-tile refresher: opt-in via the interval knob,
        # and only for stores that actually own a result cache (the
        # router/coordinator tiers delegate caching to their members)
        self.refresher = None
        from ..cache import CACHE_REFRESH_INTERVAL_S, CacheRefresher
        interval = CACHE_REFRESH_INTERVAL_S.as_float() or 0.0
        if interval > 0 and getattr(store, "result_cache", None) is not None:
            self.refresher = CacheRefresher(
                store, interval_s=interval).start()
        _load_arrow()
        handler = _make_handler(self)
        self._httpd = _Httpd((host, port), handler)
        self._thread: threading.Thread | None = None
        # the serving tier owns the health plane's sampler: refcounted,
        # so N servers in one process share ONE profiler thread
        # (geomesa.prof.hz=0 parks it). Released in stop().
        from ..obs.prof import profiler
        profiler.start()
        self._owns_prof = True

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "GeoMesaWebServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def stop(self):
        if self.refresher is not None:
            self.refresher.stop()
        if self._ingest_pipeline is not None:
            self._ingest_pipeline.close()
        if self._owns_cq and self.cq is not None:
            self.cq.close()
        if self._owns_views and self.views is not None:
            self.views.close()
        if self._owns_prof:
            self._owns_prof = False
            from ..obs.prof import profiler
            profiler.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- request handling (called from the handler) -----------------------

    def handle(self, method: str, path: str, params: dict, body: bytes,
               headers=None):
        """Route -> (status, content_type, payload[, extra headers])."""
        parts = [unquote(p) for p in path.strip("/").split("/") if p]
        if not parts or parts[0] != "rest":
            return 404, "application/json", _j({"error": "not found"})
        parts = parts[1:]
        # health surface bypasses auth AND the shed gate: probes must
        # see an overloaded-but-alive server, not a 503 liveness fail
        if method == "GET" and parts == ["health"]:
            return 200, "application/json", _j(
                {"status": "ok", "version": _version,
                 "uptime_s": round(time.monotonic() - self._started_at, 3),
                 "resilience": self._resilience_detail(),
                 "batcher": self._batcher_detail(),
                 "durability": self._durability_detail(),
                 "ingest": self._ingest_detail(),
                 "qos": self._qos_detail()})
        if method == "GET" and parts == ["ready"]:
            return self._ready()
        route = parts[0] if parts else ""
        if not self._acquire_slot():
            metrics.counter("resilience.web.sheds")
            # a shed IS an availability event on the route's SLO: the
            # caller got a 503, whatever the reason
            from ..obs.slo import slo_engine
            slo_engine.record(route, ok=False, latency_s=0.0)
            return (503, "application/json",
                    _j({"error": "overloaded: in-flight request cap "
                                 "reached", "retryable": True}),
                    {"Retry-After": self._retry_after()})
        # per-tenant shed gate (QoS on only): a tenant over ITS
        # in-flight cap gets 503 while every other tenant proceeds
        from ..tenants import tenant_registry, tenant_scope
        tenant = self._tenant(headers)
        if tenant is not None \
                and not tenant_registry.try_acquire_inflight(tenant):
            self._release_slot()
            from ..obs.slo import slo_engine
            slo_engine.record(route, ok=False, latency_s=0.0,
                              tenant=tenant)
            return (503, "application/json",
                    _j({"error": "overloaded: tenant in-flight cap "
                                 "reached", "retryable": True,
                        "tenant": tenant}),
                    {"Retry-After": self._retry_after()})
        slot_owned = True
        try:
            from ..audit import principal_scope
            from ..obs import TRACE_HEADER, tracer
            from ..obs.slo import slo_engine
            hdr = headers.get(TRACE_HEADER) if headers is not None \
                else None
            name = f"{method} /rest/{parts[0] if parts else ''}"
            # the web span is the local trace root; an incoming
            # X-GeoMesa-Trace header continues the caller's trace
            # (RemoteDataStore client leg, upstream coordinator)
            labels = {"route": route, "method": method}
            if str(WEB_METRICS_PRINCIPAL.get()).lower() in \
                    ("true", "1", "yes"):
                labels["principal"] = self._principal(headers) or "anon"
            t_req = time.perf_counter()
            with tracer.span("web", name, root=True, remote=hdr) as wsp, \
                    metrics.time("web.request", labels=labels):
                if tenant is not None:
                    wsp.set_attr(tenant=tenant)
                with principal_scope(self._principal(headers)), \
                        tenant_scope(tenant), self._device_scope():
                    out = self._handle_routed(method, parts, params,
                                              body, headers)
                wsp.set_attr(status=int(out[0]))
                slo_engine.record(route, ok=int(out[0]) < 500,
                                  latency_s=time.perf_counter() - t_req,
                                  tenant=tenant)
                if len(out) >= 3 and not isinstance(
                        out[2], (bytes, bytearray, str)):
                    # streaming payload: the generator outlives this
                    # frame, so the in-flight slot travels with it and
                    # releases when the stream finishes (or dies).
                    # (The web span closes at handoff — streamed
                    # byte time is not in the trace.)
                    wsp.annotate("streaming")
                    out = (*out[:2], self._slot_guard(out[2], tenant),
                           *out[3:])
                    slot_owned = False
                return out
        finally:
            if slot_owned:
                self._release_slot()
                if tenant is not None:
                    tenant_registry.release_inflight(tenant)

    def _device_scope(self):
        """The store's card as this request thread's current CUDA device
        (torch keeps the current device per thread, and a new request
        thread starts on device 0); a no-op for a store on the host."""
        return device_scope(self._cuda_index)

    @staticmethod
    def _principal(headers) -> str | None:
        """Audit principal from the Authorization header: a stable
        token digest, never the bearer token itself."""
        got = (headers or {}).get("Authorization", "") or ""
        if got.startswith("Bearer ") and got[7:]:
            import hashlib
            return "bearer:" + hashlib.sha1(
                got[7:].encode()).hexdigest()[:8]
        return None

    @staticmethod
    def _tenant(headers) -> str | None:
        """QoS tenant from the Authorization header via the
        ``geomesa.web.auth.tokens`` map; None when QoS is disabled (the
        bit-identical off path)."""
        from ..tenants import qos_enabled, tenant_registry
        if not qos_enabled():
            return None
        got = (headers or {}).get("Authorization", "") or ""
        token = got[7:] if got.startswith("Bearer ") else None
        return tenant_registry.resolve_token(token or None)

    @staticmethod
    def _retry_after() -> str:
        """The advertised Retry-After with bounded full jitter:
        U(0.5x, 1.5x) around ``geomesa.web.retry.after.s``, so a herd
        of shed clients doesn't retry in one synchronized wave."""
        try:
            base = float(WEB_RETRY_AFTER.get() or 1.0)
        except (TypeError, ValueError):
            base = 1.0
        base = max(base, 1e-3)
        return f"{random.uniform(0.5 * base, 1.5 * base):.4f}"

    def _handle_routed(self, method, parts, params, body, headers):
        if parts and (method, parts[0]) in _GATED \
                and not self._authorized(headers):
            return 403, "application/json", _j({"error": "forbidden"})
        try:
            return self._route(method, parts, params, body, headers)
        except KeyError as e:
            return 404, "application/json", _j({"error": str(e)})
        except DurabilityError as e:
            # the WAL poisoned itself (failed fsync/write): the
            # store is read-only degraded. 503 tells clients the
            # SERVER can't take writes — reads still work — and
            # retrying here is pointless until an operator recycles
            # the process
            metrics.counter("integrity.web.write_rejects")
            return (503, "application/json",
                    _j({"error": repr(e), "retryable": False,
                        "degraded": "read-only"}))
        except ValueError as e:
            # parse/plan errors (CQL/filter parse is a ValueError
            # subclass): the request is malformed, do NOT retry
            return 400, "application/json", _j({"error": repr(e)})
        except Exception as e:
            # unexpected server fault: 500 so clients know the
            # request (not the server's health) might still be fine
            metrics.counter("resilience.web.errors")
            return 500, "application/json", _j({"error": repr(e)})

    def _slot_guard(self, gen, tenant=None):
        """Hold the shed slot (and the tenant's in-flight slot) for a
        streaming response's lifetime."""
        try:
            yield from gen
        finally:
            self._release_slot()
            if tenant is not None:
                from ..tenants import tenant_registry
                tenant_registry.release_inflight(tenant)

    def _ready(self):
        """Readiness: the store answers and we're under the shed cap.
        Load balancers drain on 503 here while /rest/health stays 200."""
        with self._inflight_lock:
            inflight = self._inflight
        shedding = (self.max_inflight is not None
                    and inflight >= self.max_inflight)
        store_ok = True
        try:
            self.store.get_type_names()
        except Exception:
            store_ok = False
        ready = store_ok and not shedding
        body = _j({"ready": ready, "store_ok": store_ok,
                   "inflight": inflight,
                   "max_inflight": self.max_inflight})
        if ready:
            return 200, "application/json", body
        return (503, "application/json", body,
                {"Retry-After": self._retry_after()})

    def _durability_detail(self) -> dict | None:
        """Durability health: None for non-durable stores, otherwise
        whether the WAL has poisoned itself (read-only degraded mode)
        and why — the operator-facing face of fsyncgate semantics."""
        journal = getattr(self.store, "journal", None)
        if journal is None:
            return None
        out = {"poisoned": bool(journal.poisoned)}
        if journal.poisoned:
            out["mode"] = "read-only"
            cause = journal.wal.poison_cause
            if cause is not None:
                out["cause"] = repr(cause)
        return out

    def _ingest_detail(self) -> dict | None:
        """Ingest-plane health: in-flight staged rows against the
        admission bucket and whether new writes would currently shed.
        None until the first pipelined write creates the plane."""
        pipe = self._ingest_pipeline
        if pipe is None:
            return None
        gov = pipe.governor
        return {"inflight_rows": gov.inflight_rows,
                "max_inflight_rows": gov.max_inflight_rows,
                "group_cap_rows": pipe.effective_group_rows(),
                "shedding": gov.should_shed()}

    def _qos_detail(self) -> dict | None:
        """Tenant QoS health: per-tenant in-flight/budget state (the
        ``/rest/qos`` document). None while QoS is disabled."""
        from ..tenants import qos_enabled, tenant_registry
        if not qos_enabled():
            return None
        return tenant_registry.status()

    def _batcher_detail(self) -> dict | None:
        """Serving-tier batcher health: per-type pending-queue depth
        across the process-wide registry (every caller coalescing into
        this process, not just the web tier) plus this server's own
        batcher counters. None when the store can't batch."""
        if self.batcher is None:
            return None
        from ..scan.registry import batcher_registry
        return {"queue_depths": batcher_registry.queue_depths(),
                "stats": self.batcher.stats()}

    def _resilience_detail(self) -> dict:
        """Per-endpoint latency estimates for the health surface — the
        observability half of hedged requests: operators (and a future
        hedging client) read the p99-ish numbers the breaker boards
        publish as ``resilience.latency.p99.<key>`` gauges."""
        snap = metrics.snapshot()
        prefix = "resilience.latency.p99."
        latency = {k[len(prefix):]: round(v, 3)
                   for k, v in snap.get("gauges", {}).items()
                   if k.startswith(prefix) and v is not None}
        return {"latency_p99_ms": latency}

    def _acquire_slot(self) -> bool:
        with self._inflight_lock:
            if self.max_inflight is not None \
                    and self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            metrics.gauge("resilience.web.inflight", self._inflight)
            return True

    def _release_slot(self):
        with self._inflight_lock:
            self._inflight -= 1
            metrics.gauge("resilience.web.inflight", self._inflight)

    def _authorized(self, headers) -> bool:
        if not self.auth_token:
            return True  # gate not opted in: endpoints stay open
        got = (headers or {}).get("Authorization", "")
        return got == f"Bearer {self.auth_token}"

    def _route(self, method, parts, params, body, headers=None):
        if parts == ["version"]:
            return 200, "application/json", _j({"version": _version})
        if parts == ["schemas"]:
            return 200, "application/json", _j(self.store.get_type_names())
        if len(parts) == 2 and parts[0] == "schemas":
            name = parts[1]
            if method == "POST":
                self.store.create_schema(name, body.decode())
                return 201, "application/json", _j({"created": name})
            if method == "DELETE":
                self.store.remove_schema(name)
                return 200, "application/json", _j({"removed": name})
            sft = self.store.get_schema(name)
            return 200, "application/json", _j(
                {"name": name, "spec": sft.to_spec(),
                 "attributes": [{"name": a.name, "type": str(a.type)}
                                for a in sft.attributes]})
        if len(parts) == 2 and parts[0] == "query":
            return self._query(parts[1], params)
        if len(parts) == 2 and parts[0] == "count":
            hinted = {"sampling", "sampleBy", "index", "auths",
                      "maxFeatures", "properties"}
            if hinted & params.keys():
                # hinted/sampled/limited counts evaluate server-side
                # through the full Query surface — the client gets one
                # number either way, never O(n) rows over the wire
                n = self.store.query_count(self._parse_query(parts[1],
                                                             params))
            elif "cql" in params:
                n = self.store.query_count(params["cql"][0], parts[1])
            else:
                # total stored features — the SPI count() contract
                # (NOT visibility-filtered, matching local stores)
                n = self.store.count(parts[1])
            out = {"count": int(n)}
            if getattr(n, "complete", True) is False:
                out["complete"] = False
                out["missing_z_ranges"] = getattr(n, "missing_z_ranges", [])
                return (200, "application/json", _j(out),
                        _partial_headers(n))
            return 200, "application/json", _j(out)
        if len(parts) == 2 and parts[0] == "write" and method == "POST":
            # body = Arrow IPC stream; a reserved __vis__ column (when
            # present) carries per-row visibility labels — the same
            # convention the parquet tier persists
            sft = self.store.get_schema(parts[1])
            vis = None
            import pyarrow as pa
            import io as _io
            with pa.ipc.open_file(_io.BytesIO(body)) as rd:
                table = rd.read_all()
            if "__vis__" in table.schema.names:
                vis = np.asarray(table.column("__vis__").to_pylist(),
                                 dtype=object)
                table = table.drop_columns(["__vis__"])
            from ..features.batch import FeatureBatch
            batches = [FeatureBatch.from_arrow(sft, rb)
                       for rb in table.to_batches() if rb.num_rows]
            if batches:
                fused = FeatureBatch.concat_all(batches)
                if str(WEB_INGEST_PIPELINE.get()).lower() in (
                        "true", "1", "yes"):
                    refused = self._pipeline_write(parts[1], fused, vis)
                    if refused is not None:
                        return refused
                else:
                    self.store.write(parts[1], fused, visibilities=vis)
            n = sum(b.n for b in batches)
            out = {"written": n, "lsn": self._tail_lsn()}
            vec = getattr(self.store, "lsn_vector", None)
            if callable(vec):
                # cluster stores: the per-shard acked-LSN vector this
                # write is included in (read-your-writes token)
                out["lsn_vector"] = vec()
            return 200, "application/json", _j(out)
        if len(parts) == 2 and parts[0] == "delete" and method == "POST":
            ids = json.loads(body.decode())
            self.store.delete(parts[1], ids)
            out = {"deleted": len(ids), "lsn": self._tail_lsn()}
            vec = getattr(self.store, "lsn_vector", None)
            if callable(vec):
                out["lsn_vector"] = vec()
            return 200, "application/json", _j(out)
        if len(parts) == 2 and parts[0] == "estimate":
            # sketch-based cardinality estimate (never scans): the
            # remote leg of the cluster-merged SQL planner estimates
            from ..sql.planner import estimate_for_store
            est = estimate_for_store(
                self.store, parts[1], params.get("cql", ["INCLUDE"])[0])
            return 200, "application/json", _j(
                {"type": parts[1],
                 "estimate": None if est is None else int(est)})
        if len(parts) == 2 and parts[0] == "knn":
            return self._knn(parts[1], params)
        if len(parts) == 2 and parts[0] == "stats":
            return self._stats(parts[1], params, headers)
        if len(parts) == 2 and parts[0] == "density":
            return self._density(parts[1], params, headers)
        if len(parts) == 2 and parts[0] == "bin":
            return self._bin(parts[1], params, headers)
        if method == "GET" and parts == ["metrics"]:
            if params.get("format", [""])[0] == "prometheus":
                return (200, "text/plain; version=0.0.4",
                        metrics.prometheus_text())
            return 200, "application/json", _j(metrics.snapshot())
        if method == "GET" and parts == ["runtime"]:
            from ..obs.runtime import runtime
            return 200, "application/json", _j(runtime.snapshot())
        if method == "GET" and parts == ["slo"]:
            from ..obs.slo import slo_engine
            return 200, "application/json", _j(slo_engine.status())
        if method == "GET" and parts == ["qos"]:
            from ..tenants import tenant_registry
            return 200, "application/json", _j(tenant_registry.status())
        if method == "GET" and parts == ["profile"]:
            from ..obs.prof import profiler, watchdog
            if params.get("format", [""])[0] == "json":
                return 200, "application/json", _j(
                    {"profiler": profiler.stats(),
                     "watchdog": watchdog.stats()})
            # default: collapsed-stack text (flamegraph.pl/speedscope
            # input — "frame;frame;frame N" per line)
            return 200, "text/plain", profiler.collapsed()
        if method == "GET" and parts and parts[0] == "trace":
            from ..obs import tracer
            if len(parts) == 1:
                limit = int(params.get("limit", ["50"])[0])
                return 200, "application/json", _j(tracer.traces(limit))
            spans = tracer.get(parts[1])
            if spans is None:
                raise KeyError(f"unknown trace: {parts[1]}")
            return 200, "application/json", _j(
                {"trace_id": parts[1], "spans": spans})
        if parts and parts[0] == "cache":
            return self._cache(method, parts[1:], params)
        if parts and parts[0] == "cq":
            return self._cq(method, parts[1:], params, body)
        if parts and parts[0] == "views":
            return self._views(method, parts[1:], params, body, headers)
        if parts == ["sql", "join-partial"]:
            # one shard-group leg of a distributed broadcast join:
            # this server joins the shipped small side against its
            # local slice of the big side
            from ..sql.distributed import join_partial_leg
            spec = json.loads(body.decode()) if body else {}
            return 200, "application/json", _j(
                join_partial_leg(self.store, spec))
        if parts == ["sql"]:
            # POST body or ?q= : a SELECT with ST_* predicates/joins
            stmt = (body.decode() if method == "POST" and body
                    else params.get("q", [""])[0])
            if not stmt.strip():
                return 400, "application/json", _j(
                    {"error": "missing SQL statement"})
            if params.get("mode", [""])[0] == "partial":
                # one shard-group leg of a distributed aggregate:
                # mergeable partials computed next to the data
                from ..sql.distributed import partial_aggregate
                return 200, "application/json", _j(
                    partial_aggregate(self.store, stmt))
            from ..sql import SqlEngine
            res = SqlEngine(self.store).query(stmt)
            payload = {"columns": res.names,
                       "rows": [list(r) for r in res.rows()]}
            if res.plan is not None:
                payload["plan"] = res.plan
            if not res.complete:
                payload["complete"] = False
                payload["missing_groups"] = res.missing_groups
                payload["missing_z_ranges"] = res.missing_z_ranges
            return 200, "application/json", _j(payload)
        if parts and parts[0] == "wal":
            return self._wal(method, parts[1:], params)
        if parts and parts[0] == "integrity":
            return self._integrity(method, parts[1:])
        if parts and parts[0] == "replication":
            return self._replication(method, parts[1:])
        if parts and parts[0] == "cluster":
            return self._cluster(method, parts[1:], params)
        if parts == ["topology"] and method == "GET":
            topology = getattr(self.store, "topology", None)
            if not callable(topology):
                return 404, "application/json", _j(
                    {"error": "store has no cluster topology"})
            counts = params.get("counts", ["true"])[0] != "false"
            return 200, "application/json", _j(
                topology(include_counts=counts))
        if parts and parts[0] == "reshard":
            return self._reshard(method, parts[1:], params)
        if (len(parts) == 2 and parts[0] == "reindex"
                and method == "POST"):
            # the blocking reindex oracle on the wire: holds the store
            # op lock for the rebuild (use /rest/evolve for online)
            v = params.get("version", [None])[0]
            self.store.reindex(parts[1],
                               int(v) if v is not None else None)
            return 200, "application/json", _j(
                {"reindexed": parts[1],
                 "index_version":
                     self.store.get_schema(parts[1]).index_version})
        if parts and parts[0] == "evolve":
            return self._evolve(method, parts[1:], params, body)
        if parts == ["audit"]:
            # a server fronting a store without its own logger still
            # answers: surfaces without one record into the process
            # global ring (audit/hook.py)
            from ..audit import global_audit
            log = self.audit if self.audit is not None else global_audit()
            evs = log.query(
                params.get("type", [None])[0],
                int(params["since"][0]) if "since" in params else None)
            return 200, "application/json", _j(
                [json.loads(e.to_json()) for e in evs])
        return 404, "application/json", _j({"error": "not found"})

    def _ingest_pipe(self):
        if self._ingest_pipeline is None:
            with self._ingest_lock:
                if self._ingest_pipeline is None:
                    from ..ingest import IngestPipeline
                    self._ingest_pipeline = IngestPipeline(self.store)
        return self._ingest_pipeline

    def _pipeline_write(self, type_name: str, batch, vis):
        """Stage through the group-commit pipeline. Returns None once
        the write has committed, or a ready 429 response when admission
        control refuses — the bucket of in-flight rows is full, or the
        read batchers are backed up and ingest must yield."""
        pipe = self._ingest_pipe()
        if pipe.governor.should_shed():
            metrics.counter("ingest.web.sheds")
            return (429, "application/json",
                    _j({"error": "ingest shed: read queues saturated",
                        "retryable": True}),
                    {"Retry-After": self._retry_after()})
        ack = pipe.write(type_name, batch, visibilities=vis, block=False)
        if ack is None:
            metrics.counter("ingest.web.backpressure")
            return (429, "application/json",
                    _j({"error": "ingest backpressure: in-flight row "
                                 "bucket full", "retryable": True}),
                    {"Retry-After": self._retry_after()})
        # block this request thread until the fused group commits: the
        # response's lsn must cover this write (read-your-writes)
        ack.wait()
        return None

    def _tail_lsn(self) -> int | None:
        """The WAL position after a mutation (None for non-durable
        stores). Replication routers fronting this server via
        RemoteDataStore use it as the write's ACK watermark."""
        journal = getattr(self.store, "journal", None)
        return journal.wal.last_lsn if journal is not None else None

    def _replication(self, method, parts):
        """Replication admin. GET /rest/replication reports whichever
        role this store plays: a ``ReplicatedDataStore`` answers with
        router status, a primary with a ``WalShipper`` attached as
        ``store.shipper`` answers with shipper status. POST
        /rest/replication/promote (bearer-gated) forces failover."""
        if method == "GET" and not parts:
            status = getattr(self.store, "replication_status", None)
            if callable(status):
                return 200, "application/json", _j(status())
            shipper = getattr(self.store, "shipper", None)
            if shipper is not None:
                return 200, "application/json", _j(shipper.status())
            return 404, "application/json", _j(
                {"error": "store has no replication role"})
        if method == "POST" and parts == ["promote"]:
            promote = getattr(self.store, "promote", None)
            if not callable(promote):
                return 404, "application/json", _j(
                    {"error": "store cannot promote (not a replication "
                              "router)"})
            return 200, "application/json", _j(promote())
        return 404, "application/json", _j({"error": "not found"})

    def _cluster(self, method, parts, params):
        """Cluster admin. GET /rest/cluster reports shard-group
        topology, owned z-ranges, the acked LSN vector and per-leg
        breaker/latency state; POST /rest/cluster/promote?group=NAME
        (bearer-gated) forces intra-group failover."""
        if method == "GET" and not parts:
            status = getattr(self.store, "cluster_status", None)
            if callable(status):
                return 200, "application/json", _j(status())
            return 404, "application/json", _j(
                {"error": "store has no cluster role"})
        if method == "POST" and parts == ["promote"]:
            promote = getattr(self.store, "promote_group", None)
            if not callable(promote):
                return 404, "application/json", _j(
                    {"error": "store cannot promote (not a cluster "
                              "coordinator)"})
            group = params.get("group", [None])[0]
            return 200, "application/json", _j(promote(group))
        return 404, "application/json", _j({"error": "not found"})

    def _reshard(self, method, parts, params):
        """Elastic-topology admin. GET /rest/reshard reports resharder
        state (in-flight migration, epoch history, cooldown); POST
        /rest/reshard/split|migrate|resume|abort (bearer-gated) drive
        the verbs and POST /rest/reshard/auto ticks — or with
        ?state=on|off starts/stops — the autoscaler loop. Typed
        reshard refusals (kill switch, cooldown, in-flight limit) map
        to 409: the request was well-formed but the topology cannot
        change right now."""
        if not hasattr(self.store, "resharder"):
            return 404, "application/json", _j(
                {"error": "store has no elastic topology"})
        from ..cluster.reshard import ReshardError
        resharder = self.store.resharder
        if method == "GET" and not parts:
            return 200, "application/json", _j(resharder.status())
        if method != "POST" or len(parts) != 1:
            return 404, "application/json", _j({"error": "not found"})
        verb = parts[0]
        try:
            if verb == "split":
                src = (params.get("src", [None])[0]
                       or params.get("group", [None])[0])
                if src is None:
                    return 400, "application/json", _j(
                        {"error": "split requires ?src=<group>"})
                at = params.get("at", [None])[0]
                entry = resharder.split(
                    src, dst=params.get("dst", [None])[0],
                    at=int(at) if at is not None else None,
                    reason="rest")
                return 200, "application/json", _j(entry)
            if verb == "migrate":
                need = ("prefix_lo", "prefix_hi", "src", "dst")
                missing = [k for k in need if params.get(k, [None])[0]
                           is None]
                if missing:
                    return 400, "application/json", _j(
                        {"error": "migrate requires "
                                  + ", ".join(f"?{k}=" for k in need)})
                entry = resharder.migrate(
                    int(params["prefix_lo"][0]),
                    int(params["prefix_hi"][0]),
                    params["src"][0], params["dst"][0], reason="rest")
                return 200, "application/json", _j(entry)
            if verb == "resume":
                return 200, "application/json", _j(resharder.resume())
            if verb == "abort":
                return 200, "application/json", _j(resharder.abort())
            if verb == "auto":
                scaler = self.store.autoscaler
                state = params.get("state", [None])[0]
                if state == "on":
                    scaler.start()
                elif state == "off":
                    scaler.stop()
                elif state is not None:
                    return 400, "application/json", _j(
                        {"error": "state must be on|off"})
                else:
                    return 200, "application/json", _j(
                        scaler.run_once())
                return 200, "application/json", _j(scaler.status())
        except ReshardError as e:
            return (409, "application/json",
                    _j({"error": str(e), "retryable": False}))
        return 404, "application/json", _j({"error": "not found"})

    def _evolve(self, method, parts, params, body):
        """Schema-evolution admin. GET /rest/evolve reports evolver
        state (active evolution phase/cursor, history); POST
        /rest/evolve/reindex?type=&version=, /rest/evolve/update?type=
        (change list as JSON body or ?changes=), /rest/evolve/resume
        and /rest/evolve/abort (bearer-gated) drive the verbs. Typed
        refusals (kill switch, verb in flight, bad change spec,
        mid-flip fence) map to 409: well-formed request, but the
        schema cannot change right now."""
        if not hasattr(self.store, "evolver"):
            return 404, "application/json", _j(
                {"error": "store has no schema-evolution plane"})
        from ..evolve import SchemaEvolutionError
        evolver = self.store.evolver
        if method == "GET" and not parts:
            return 200, "application/json", _j(evolver.status())
        if method != "POST" or len(parts) != 1:
            return 404, "application/json", _j({"error": "not found"})
        verb = parts[0]
        try:
            if verb == "reindex":
                tn = params.get("type", [None])[0]
                if tn is None:
                    return 400, "application/json", _j(
                        {"error": "reindex requires ?type=<name>"})
                v = params.get("version", [None])[0]
                entry = evolver.reindex(
                    tn, int(v) if v is not None else None)
                return 200, "application/json", _j(entry)
            if verb == "update":
                args = {k: v[0] for k, v in params.items()}
                if body:
                    try:
                        parsed = json.loads(body)
                        if not isinstance(parsed, dict):
                            raise ValueError("body must be a JSON "
                                             "object")
                        args.update(parsed)
                    except ValueError as e:
                        return 400, "application/json", _j(
                            {"error": f"bad JSON body: {e}"})
                tn = args.get("type")
                if not tn:
                    return 400, "application/json", _j(
                        {"error": "update requires a type"})
                changes = args.get("changes")
                if isinstance(changes, str):
                    try:
                        changes = json.loads(changes)
                    except ValueError as e:
                        return 400, "application/json", _j(
                            {"error": f"bad changes JSON: {e}"})
                entry = evolver.update_schema(tn, changes)
                return 200, "application/json", _j(entry)
            if verb == "resume":
                return 200, "application/json", _j(evolver.resume())
            if verb == "abort":
                return 200, "application/json", _j(evolver.abort())
        except SchemaEvolutionError as e:
            return (409, "application/json",
                    _j({"error": str(e), "retryable": False}))
        return 404, "application/json", _j({"error": "not found"})

    def _wal(self, method, parts, params):
        """Durability admin: GET /rest/wal (stats, open), POST
        /rest/wal/checkpoint and /rest/wal/truncate?below= (mutating,
        bearer-gated via _GATED)."""
        journal = getattr(self.store, "journal", None)
        if journal is None:
            return 404, "application/json", _j(
                {"error": "store is not durable (no WAL journal)"})
        if method == "GET" and not parts:
            return 200, "application/json", _j(journal.stats())
        if method == "POST" and parts == ["checkpoint"]:
            info = self.store.checkpoint()
            return 200, "application/json", _j(info)
        if method == "POST" and parts == ["truncate"]:
            if "below" in params:
                lsn = int(params["below"][0])
            else:
                from ..wal.snapshot import latest_checkpoint_lsn
                lsn = latest_checkpoint_lsn(journal.root)
            if lsn <= 0:
                return 400, "application/json", _j(
                    {"error": "no checkpoint and no ?below= LSN"})
            dropped = journal.wal.truncate_below(lsn)
            return 200, "application/json", _j(
                {"below": lsn, "segments_dropped": dropped})
        return 404, "application/json", _j({"error": "not found"})

    def _integrity(self, method, parts):
        """Storage integrity surface: GET /rest/integrity (read-only
        verification sweep of WAL CRCs + checkpoint digests, open) and
        POST /rest/integrity/scrub (one scrub pass WITH quarantine per
        the knob — mutating, bearer-gated via _GATED)."""
        journal = getattr(self.store, "journal", None)
        if journal is None:
            return 404, "application/json", _j(
                {"error": "store is not durable (no WAL journal)"})
        if method == "GET" and not parts:
            from ..integrity.scrub import integrity_report
            rep = integrity_report(journal.root)
            rep["poisoned"] = bool(journal.poisoned)
            return 200, "application/json", _j(rep)
        if method == "POST" and parts == ["scrub"]:
            scrubber = getattr(self.store, "scrubber", None)
            if scrubber is None:
                from ..integrity.scrub import Scrubber
                scrubber = Scrubber(journal=journal)
            return 200, "application/json", _j(scrubber.run_once())
        return 404, "application/json", _j({"error": "not found"})

    def _parse_query(self, name, params) -> Query:
        """URL params -> Query; shared by /rest/query and the hinted
        /rest/count path so both evaluate identical semantics."""
        q = Query(name, params.get("cql", ["INCLUDE"])[0])
        if "maxFeatures" in params:
            q.max_features = int(params["maxFeatures"][0])
        if "sortBy" in params:
            q.sort_by = params["sortBy"][0]
            q.sort_desc = (params.get("sortOrder", ["asc"])[0]
                           .lower() == "desc")
        # ViewParams analog (index/geotools ViewParams:28): URL params
        # map onto per-query hints
        if "properties" in params:
            q.properties = [p for p in params["properties"][0].split(",")
                            if p]
        if "sampling" in params:
            q.hints[QueryHints.SAMPLING] = float(params["sampling"][0])
        if "sampleBy" in params:
            q.hints[QueryHints.SAMPLE_BY] = params["sampleBy"][0]
        if "index" in params:
            q.hints[QueryHints.QUERY_INDEX] = params["index"][0]
        if "auths" in params:
            q.auths = [a for a in params["auths"][0].split(",") if a]
        return q

    def _query(self, name, params):
        fmt = params.get("format", ["json"])[0]
        q = self._parse_query(name, params)
        if fmt in ("arrow-stream", "bin"):
            return self._query_stream(name, q, params, fmt)
        if fmt == "arrow":
            from ..arrow.io import write_ipc
            res = self._run_query(q)
            sft = self.store.get_schema(name)
            batch = res.batch
            if batch is None:
                from ..features.batch import FeatureBatch
                batch = FeatureBatch.from_dict(
                    sft, np.empty(0, dtype=object),
                    {a.name: ((np.empty(0), np.empty(0))
                              if a.type.name == "Point" else [])
                     for a in sft.attributes})
            # projected results carry a projected schema
            return (200, "application/vnd.apache.arrow.file",
                    write_ipc(batch.sft, batch),
                    _partial_headers(res))
        res = self._run_query(q)
        sft = self.store.get_schema(name)
        if fmt == "geojson":
            from ..geometry.geojson import to_geojson
            feats = []
            if res.batch is not None:
                gf = sft.geom_field
                for f in res.features():
                    g = f.get(gf)
                    feats.append({
                        "type": "Feature", "id": f["id"],
                        "geometry": to_geojson(g) if g is not None else None,
                        "properties": {k: v for k, v in f.items()
                                       if k not in ("id", gf)}})
            return (200, "application/geo+json", _j(
                {"type": "FeatureCollection", "features": feats}),
                _partial_headers(res))
        rows = list(res.features()) if res.batch is not None else []
        out = {"count": len(rows), "features": rows}
        if getattr(res, "complete", True) is False:
            out["complete"] = False
            out["missing_z_ranges"] = getattr(res, "missing_z_ranges", [])
        return (200, "application/json", _j(out), _partial_headers(res))

    def _query_stream(self, name, q: Query, params, fmt: str):
        """format=arrow-stream|bin: chunked-transfer streaming. The
        scan still runs the fused vectorized path eagerly (plan/CQL
        errors map to 400 before any bytes leave), then the result
        *encodes* incrementally — the first batch is on the wire while
        the rest is still being encoded, and neither side ever holds
        the full serialized payload."""
        from ..arrow.delta import (ARROW_STREAM_MIME, empty_batch,
                                   stream_bin, stream_ipc)
        res = self._run_query(q)
        sft = self.store.get_schema(name)
        batch = res.batch if res.batch is not None else empty_batch(sft)
        hdrs = _partial_headers(res)
        rows = (int(params["batchRows"][0]) if "batchRows" in params
                else None)
        if fmt == "bin":
            track = params.get("track", [None])[0]
            label = params.get("label", [None])[0]
            return (200, "application/octet-stream",
                    stream_bin(sft, batch, track=track, label=label,
                               batch_rows=rows),
                    hdrs)
        # projected results carry a projected schema (batch.sft)
        return (200, ARROW_STREAM_MIME,
                stream_ipc(batch.sft, batch, batch_rows=rows), hdrs)

    def _run_query(self, q: Query):
        """Queries coalesce through the batcher (one fused scan per
        linger window per schema); stores without batching run direct."""
        if self.batcher is not None:
            return self.batcher.query(q)
        return self.store.query(q)

    def _knn(self, name, params):
        """GET /rest/knn/{type}?x=&y=&k= — k nearest features to the
        query point. Concurrent requests on the same (type, k) coalesce
        through the batcher into ONE fused multi-query top-k dispatch
        (scan/batcher.QueryBatcher.knn), the same admission queue bbox
        queries ride."""
        try:
            x = float(params["x"][0])
            y = float(params["y"][0])
        except (KeyError, ValueError):
            return 400, "application/json", _j(
                {"error": "knn requires numeric x and y params"})
        k = int(params.get("k", ["10"])[0])
        if self.batcher is not None:
            ids, dists = self.batcher.knn(name, x, y, k)
        else:
            from ..analytics.processes import knn_process
            ids, dists = knn_process(self.store, name, x, y, k)
        return 200, "application/json", _j(
            {"ids": [str(i) for i in ids],
             "distances": np.asarray(dists, np.float64).tolist()})

    # -- conditional-request plumbing (ETag = plan key + LSN) --------------

    def _etag_for(self, type_name: str, plan_key: str) -> str | None:
        """ETag for a pushdown response: hash of (type, canonical plan
        key, pushdown version). Computed BEFORE the result — a version
        advancing mid-request makes the tag mismatch (full 200), never
        a stale 304. None when the store has no exact single version
        (router/cluster tiers)."""
        pv = getattr(self.store, "pushdown_version", None)
        if not callable(pv):
            return None
        try:
            v = pv(type_name)
        except Exception:
            return None
        import hashlib
        h = hashlib.sha1(
            f"{type_name}|{plan_key}|{v}".encode()).hexdigest()[:20]
        return f'"{h}"'

    @staticmethod
    def _not_modified(etag: str, headers) -> bool:
        if headers is None or etag is None:
            return False
        try:
            inm = headers.get("If-None-Match")
        except AttributeError:
            inm = None
        if not inm:
            return False
        if inm.strip() == "*":
            return True
        cands = [c.strip() for c in inm.split(",")]
        return etag in cands or f"W/{etag}" in cands

    def _stats(self, name, params, headers=None):
        from ..cache.keys import stats_key
        spec = params.get("stat", ["Count()"])[0]
        flt, key = stats_key(params.get("cql", [None])[0], spec)
        etag = self._etag_for(name, key)
        if etag is not None and self._not_modified(etag, headers):
            return 304, "application/json", b"", {"ETag": etag}
        stat = self.store.stats_query(name, spec, flt)
        extra = {"ETag": etag} if etag is not None else {}
        return 200, "application/json", _j(stat.to_json_object()), extra

    def _density(self, name, params, headers=None):
        from ..cache.keys import density_key
        bbox = tuple(float(v) for v in params["bbox"][0].split(","))
        width = int(params.get("width", ["256"])[0])
        height = int(params.get("height", ["256"])[0])
        cql = params.get("cql", ["INCLUDE"])[0]
        flt, key = density_key(cql, bbox, width, height)
        etag = self._etag_for(name, key)
        if etag is not None and self._not_modified(etag, headers):
            return 304, "application/json", b"", {"ETag": etag}
        grid = self.store.density(name, flt, bbox, width, height)
        hdrs = _partial_headers(grid)
        if etag is not None and getattr(grid, "complete", True) is not False:
            hdrs["ETag"] = etag
        return (200, "application/json", _j(
            {"bbox": bbox, "width": width, "height": height,
             "grid": np.asarray(grid).tolist()}), hdrs)

    def _bin(self, name, params, headers=None):
        """GET /rest/bin/{type}?cql=&track=&label=&sort= — the compact
        BIN record stream (bin_query), conditional like density."""
        from ..cache.keys import bin_key
        cql = params.get("cql", ["INCLUDE"])[0]
        track = params.get("track", [None])[0]
        label = params.get("label", [None])[0]
        sort = params.get("sort", ["false"])[0].lower() in ("1", "true",
                                                            "yes")
        flt, key = bin_key(cql, track, label, sort)
        etag = self._etag_for(name, key)
        if etag is not None and self._not_modified(etag, headers):
            return 304, "application/octet-stream", b"", {"ETag": etag}
        data = self.store.bin_query(name, flt, track=track, label=label,
                                    sort=sort)
        hdrs = _partial_headers(data)
        if etag is not None and getattr(data, "complete", True) is not False:
            hdrs["ETag"] = etag
        return 200, "application/octet-stream", bytes(data), hdrs

    def _cq_publisher(self):
        if self.cq is None:
            from ..store.continuous import ContinuousQueryPublisher
            try:
                self.cq = ContinuousQueryPublisher(self.store)
            except ValueError:
                return None
            self._owns_cq = True
        return self.cq

    def _cq(self, method, parts, params, body):
        """Continuous-query admin: GET /rest/cq (registered queries +
        per-type device filter-set stats, open); POST
        /rest/cq/register?name=&type=&ecql= and POST
        /rest/cq/unregister?name= (mutating, bearer-gated via _GATED).
        Register args also accepted as a JSON body — long ECQL reads
        better there than in a query string."""
        if method == "GET" and not parts:
            out = {"queries": [], "device": []}
            if self.cq is not None:
                out["queries"] = [
                    {"name": q.name, "type": q.type_name, "ecql": q.ecql,
                     "topic": q.topic, "matched": q.matched,
                     "published": q.published}
                    for q in self.cq.queries()]
                out["device"] = self.cq.device_stats()
            return 200, "application/json", _j(out)
        if method == "POST" and parts in (["register"], ["unregister"]):
            args = {k: v[0] for k, v in params.items()}
            if body:
                try:
                    parsed = json.loads(body)
                    if not isinstance(parsed, dict):
                        raise ValueError("body must be a JSON object")
                    args.update(parsed)
                except ValueError as e:
                    return 400, "application/json", _j(
                        {"error": f"bad JSON body: {e}"})
            pub = self._cq_publisher()
            if pub is None:
                return 404, "application/json", _j(
                    {"error": "store has no mutation bus for "
                              "continuous queries"})
            name = args.get("name")
            if not name:
                return 400, "application/json", _j(
                    {"error": "name required"})
            if parts == ["register"]:
                type_name = args.get("type")
                if not type_name:
                    return 400, "application/json", _j(
                        {"error": "type required"})
                ecql = args.get("ecql") or "INCLUDE"
                try:
                    cq = pub.register(name, type_name, ecql)
                except ValueError as e:
                    status = 409 if "exists" in str(e) else 400
                    return status, "application/json", _j(
                        {"error": str(e)})
                return 200, "application/json", _j(
                    {"registered": cq.name, "type": cq.type_name,
                     "topic": cq.topic})
            pub.unregister(name)
            return 200, "application/json", _j({"unregistered": name})
        return 404, "application/json", _j({"error": "not found"})

    def _views_registry(self):
        if self.views is None:
            from ..views import ViewRegistry
            self.views = ViewRegistry(self.store)
            self._owns_views = True
        return self.views

    def _views(self, method, parts, params, body, headers=None):
        """Materialized-view admin: GET /rest/views (status, open),
        GET /rest/views/{name} (rows at the view's LSN — conditional,
        ETag = exact pushdown version), POST
        /rest/views/register?name=&sql=, POST
        /rest/views/unregister?name= and POST /rest/views/refresh?name=
        (mutating, bearer-gated via _GATED). Register args also
        accepted as a JSON body — a standing SELECT reads better there
        than in a query string."""
        reg = self._views_registry()
        if method == "GET" and not parts:
            return 200, "application/json", _j({"views": reg.status()})
        if method == "GET" and len(parts) == 1:
            v = reg.get(parts[0])
            etag = self._etag_for(v.state.table, f"view:{v.name}")
            if etag is not None and self._not_modified(etag, headers):
                return 304, "application/json", b"", {"ETag": etag}
            res = reg.result(parts[0])
            extra = {"ETag": etag} if etag is not None else {}
            return (200, "application/json", _j(
                {"name": v.name, "lsn": v.lsn, "columns": res.names,
                 "rows": [list(r) for r in res.rows()]}), extra)
        if method == "POST" and parts in (["register"], ["unregister"],
                                          ["refresh"]):
            args = {k: v[0] for k, v in params.items()}
            if body:
                try:
                    parsed = json.loads(body)
                    if not isinstance(parsed, dict):
                        raise ValueError("body must be a JSON object")
                    args.update(parsed)
                except ValueError as e:
                    return 400, "application/json", _j(
                        {"error": f"bad JSON body: {e}"})
            name = args.get("name")
            if not name:
                return 400, "application/json", _j(
                    {"error": "name required"})
            if parts == ["register"]:
                sql = args.get("sql")
                if not sql:
                    return 400, "application/json", _j(
                        {"error": "sql required"})
                try:
                    view = reg.register(name, sql)
                except ValueError as e:
                    # unsupported/malformed statements refuse typed at
                    # compile time — surface the parser/planner message
                    # as a client error, never a 500
                    return 400, "application/json", _j(
                        {"error": str(e)})
                return 201, "application/json", _j(
                    {"registered": view.name,
                     "status": view.status(reg._lsn(view.state.table))})
            if parts == ["refresh"]:
                return 200, "application/json", _j(
                    {"refreshed": name, "status": reg.refresh(name)})
            reg.unregister(name)
            return 200, "application/json", _j({"unregistered": name})
        return 404, "application/json", _j({"error": "not found"})

    def _cache(self, method, parts, params):
        """Materialized-cache admin: GET /rest/cache (status, open),
        POST /rest/cache/invalidate?type= (mutating, bearer-gated via
        _GATED)."""
        if method == "GET" and not parts:
            cs = getattr(self.store, "cache_status", None)
            if not callable(cs):
                return 404, "application/json", _j(
                    {"error": "store has no result cache"})
            out = cs()
            if self.refresher is not None:
                out["refresher"] = self.refresher.status()
            return 200, "application/json", _j(out)
        if method == "POST" and parts == ["invalidate"]:
            inv = getattr(self.store, "invalidate_cache", None)
            if not callable(inv):
                return 404, "application/json", _j(
                    {"error": "store has no result cache"})
            tn = params.get("type", [None])[0]
            n = inv(tn)
            return 200, "application/json", _j(
                {"invalidated": int(n), "type": tn})
        return 404, "application/json", _j({"error": "not found"})


class _Httpd(ThreadingHTTPServer):
    def handle_error(self, request, client_address):
        # a client vanishing mid-exchange (reset, broken pipe — e.g.
        # the internal wfile.flush after our handler) is routine on a
        # real network; anything else keeps the stock traceback dump
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            metrics.counter("resilience.web.client_disconnects")
            return
        super().handle_error(request, client_address)


def _load_arrow():
    """Load pyarrow on the thread that builds the server. Loaded first
    inside a short-lived request thread, its allocator (mimalloc) can
    crash the process on that thread's first Arrow arrays; loaded on a
    long-lived thread it does not. The server runs without pyarrow until
    an Arrow route is asked for."""
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        pass


def _j(obj) -> bytes:
    return json.dumps(obj, default=_default).encode()


def _partial_headers(res) -> dict:
    """Response headers for the cluster partial-results contract: a
    result flagged ``complete=False`` (a shard group was down and
    ``geomesa.cluster.allow.partial`` let the query degrade) is marked
    so no transport strips the flag. Cluster results also carry the
    topology epoch they were planned against, so clients straddling an
    online reshard can detect the flip."""
    hdrs: dict = {}
    epoch = getattr(res, "topology_epoch", None)
    if epoch is not None:
        hdrs["X-GeoMesa-Topology-Epoch"] = str(int(epoch))
    if getattr(res, "complete", True) is not False:
        return hdrs
    hdrs["X-GeoMesa-Complete"] = "false"
    groups = getattr(res, "missing_groups", None)
    if groups:
        hdrs["X-GeoMesa-Missing-Groups"] = ",".join(groups)
    return hdrs


def _default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    from ..geometry import Geometry
    if isinstance(o, Geometry):
        from ..geometry.wkt import to_wkt
        return to_wkt(o)
    return str(o)


def _make_handler(server: GeoMesaWebServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so streaming responses may use chunked
        # transfer-encoding — the framing is what makes a mid-stream
        # server death *detectable* (no terminal chunk -> the client's
        # read raises instead of returning a silently-truncated body)
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _respond(self):
            u = urlparse(self.path)
            params = parse_qs(u.query)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            out = server.handle(
                self.command, u.path, params, body, headers=self.headers)
            status, ctype, payload = out[:3]
            extra = out[3] if len(out) > 3 else {}
            if not isinstance(payload, (bytes, bytearray, str)):
                return self._respond_chunked(status, ctype, payload, extra)
            if isinstance(payload, str):
                # text routes (prometheus exposition, collapsed-stack
                # profiles) hand back str; the socket needs bytes, and
                # Content-Length must count bytes, not characters
                payload = payload.encode("utf-8")
            try:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in extra.items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(payload)
            except (BrokenPipeError, ConnectionResetError):
                # the client hung up mid-response: its problem, not a
                # server fault — count it, don't dump a traceback
                metrics.counter("resilience.web.client_disconnects")
                self.close_connection = True

        def _respond_chunked(self, status, ctype, payload, extra):
            """Stream an iterator payload with chunked framing. A
            producer fault mid-stream drops the connection WITHOUT the
            terminal 0-chunk, so the client raises (IncompleteRead /
            connection error) rather than seeing a short body."""
            gen = iter(payload)
            try:
                try:
                    first = next(gen)  # encode errors -> 500, pre-headers
                except StopIteration:
                    first = None
                except Exception as e:
                    metrics.counter("resilience.web.errors")
                    err = _j({"error": repr(e)})
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(err)))
                    self.end_headers()
                    self.wfile.write(err)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in extra.items():
                    self.send_header(k, str(v))
                self.end_headers()
                if first:
                    self._chunk(first)
                for chunk in gen:
                    if chunk:
                        self._chunk(chunk)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                metrics.counter("resilience.web.client_disconnects")
                self.close_connection = True
            except Exception:
                # producer died mid-stream: sever without the terminal
                # chunk — truncation must be loud on the client
                metrics.counter("resilience.web.stream_aborts")
                self.close_connection = True
                try:
                    self.wfile.flush()
                    self.connection.close()
                except OSError:
                    pass
            finally:
                close = getattr(gen, "close", None)
                if close is not None:
                    close()

        def _chunk(self, data: bytes):
            self.wfile.write(b"%x\r\n" % len(data))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        do_GET = do_POST = do_DELETE = _respond

    return Handler
