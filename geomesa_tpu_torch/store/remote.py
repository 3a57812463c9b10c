"""Networked datastore client: the DataStore SPI over HTTP, the port's
copy of ``geomesa_tpu.store.remote``.

The reference's remote backends are client stacks speaking a wire
protocol to data-holding servers (Accumulo Thrift scanners/batch
writers, HBase protobuf RPC); queries execute where the data lives and
results stream back. Here a ``GeoMesaWebServer`` (web/server.py) fronts
a store (on the card, for an ``InMemoryDataStore()``) and
``RemoteDataStore`` is the client plumbing: schema management, Arrow
batch writes (visibility labels ride a reserved ``__vis__`` column,
the parquet tier's convention), server-side query/count/stats/density
execution, Arrow results decoded back into columnar batches. The wire
is the reference's, so the client also talks to the JAX package's
server, and the JAX client to the port's.

The client holds no device: a query's result is a ``QueryResult`` on
host arrays, its ``rows`` the positions 0..n-1 of the result.

    server = GeoMesaWebServer(InMemoryDataStore()).start()
    ds = RemoteDataStore("127.0.0.1", server.port)
    ds.create_schema("pts", "*geom:Point:srid=4326")
    ds.write_dict("pts", ids, {"geom": (x, y)})
    ds.query("BBOX(geom, 0, 0, 10, 10)", "pts").ids
"""

from __future__ import annotations

import http.client
import io
import json
import time
from typing import Any
from urllib.parse import quote, urlencode

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType, parse_spec
from ..resilience import (BreakerBoard, HedgePolicy, RetryBudget,
                          RetryPolicy)
from ..resilience.breaker import CLOSED
from ..index.api import FilterStrategy, Query, QueryHints
from .api import DataStore

__all__ = ["RemoteDataStore"]


class RemoteError(RuntimeError):
    """Server-reported failure. ``status`` is the HTTP code;
    ``retryable`` tells RetryPolicy whether another attempt is safe
    (5xx on idempotent calls, 503 sheds always — the server guarantees
    a shed request was never executed)."""

    def __init__(self, msg: str, status: int = 0,
                 retryable: bool = False,
                 retry_after_s: float | None = None):
        super().__init__(msg)
        self.status = status
        self.retryable = retryable
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s


def _breaker_counts(exc: BaseException) -> bool:
    """Transport faults and 5xx responses trip the breaker; a
    well-formed 4xx proves the endpoint alive."""
    if isinstance(exc, RemoteError):
        return exc.status >= 500
    return isinstance(exc, (ConnectionError, TimeoutError, OSError,
                            http.client.HTTPException))


class RemoteDataStore(DataStore):
    """DataStore client over the GeoMesaWebServer wire surface.

    Transient network faults are absorbed client-side (the role the
    reference delegates to Accumulo/HBase client stacks): idempotent
    calls — every GET, plus connect-phase failures and 503 sheds on
    writes — retry with full-jitter backoff under a shared retry
    budget, and a per-endpoint circuit breaker fast-fails once an
    endpoint looks dead instead of burning ``timeout_s`` per call.

    Idempotent GETs additionally HEDGE (resilience/hedge.py): once an
    endpoint's latency EWMA has a p99-ish estimate, each attempt waits
    that long for an answer, then launches one speculative second
    attempt — first success wins, the loser is discarded. Hedges are
    charged to the same retry budget, never fire on writes, and are
    suppressed while the endpoint's breaker isn't CLOSED (a sick
    endpoint needs shed load, not doubled load). ``hedge=False``
    disables; a ``HedgePolicy`` instance overrides the default."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 auth_token: str | None = None,
                 retry_policy: RetryPolicy | None = None,
                 breakers: BreakerBoard | None = None,
                 hedge: HedgePolicy | bool | None = None,
                 audit=None):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.auth_token = auth_token  # bearer token for gated endpoints
        self.audit = audit  # AuditLogger or None (global fallback)
        self._schemas: dict[str, SimpleFeatureType] = {}
        self._retry = retry_policy if retry_policy is not None \
            else RetryPolicy(budget=RetryBudget())
        self._breakers = breakers if breakers is not None else BreakerBoard()
        if hedge is False:
            self._hedge = None
        elif hedge is None or hedge is True:
            self._hedge = HedgePolicy(budget=self._retry.budget)
        else:
            self._hedge = hedge

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, params: dict | None = None,
                 body: bytes | None = None, idempotent: bool | None = None):
        if idempotent is None:
            idempotent = method == "GET"
        # breaker per route segment ("/rest/query/t" -> "query"): one
        # dead endpoint fails fast without gating the others
        segs = path.strip("/").split("/")
        endpoint = segs[1] if len(segs) > 1 else (segs[0] or "root")
        breaker = self._breakers.get(endpoint)

        def attempt():
            breaker.acquire()  # CircuitOpenError fast-fail when open
            t0 = time.perf_counter()
            try:
                out = self._do_request(method, path, params, body,
                                       idempotent)
            except Exception as e:
                if _breaker_counts(e):
                    breaker.failure()
                else:
                    breaker.success()
                raise
            breaker.success()
            # only successful attempts feed the latency EWMA: timeouts
            # and resets would teach the p99 the timeout value, and the
            # hedging delay it informs applies to healthy calls
            self._breakers.observe(endpoint, time.perf_counter() - t0)
            return out

        from ..obs import tracer
        with tracer.span("remote", f"{method} {path}") as sp:
            try:
                return self._retry.call(
                    self._maybe_hedged(attempt, breaker, endpoint,
                                       idempotent),
                    name=f"remote.{endpoint}")
            except Exception as e:
                sp.annotate("remote.failed", error=type(e).__name__)
                raise

    def _maybe_hedged(self, attempt, breaker, endpoint: str,
                      idempotent: bool, streaming: bool = False):
        """Wrap one retry attempt in a speculative hedge when every
        eligibility gate passes; otherwise return it untouched. Gates,
        re-checked per call so a flipped knob or a tripped breaker
        takes effect immediately: hedging configured and enabled,
        the call is idempotent (a hedge executes twice; only reads
        survive that invisibly), the call is NOT streaming (a hedged
        chunked response would double-deliver rows to the consumer and
        double-charge the budget for a transfer whose duration scales
        with result size, not endpoint health), the breaker is CLOSED,
        and the endpoint has a latency estimate for the delay."""
        if streaming or self._hedge is None or not idempotent \
                or not HedgePolicy.enabled() or breaker.state != CLOSED:
            return attempt
        delay = self._hedge.delay_s(self._breakers.latency_p99_s(endpoint))
        if delay is None:
            return attempt
        return lambda: self._hedge.call(attempt, delay,
                                        name=f"remote.{endpoint}")

    def _do_request(self, method, path, params, body, idempotent):
        qs = ("?" + urlencode(params)) if params else ""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        headers = {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        from ..obs import TRACE_HEADER, tracer
        wire = tracer.inject()
        if wire is not None:
            # the server continues this trace: its web/store spans land
            # under our current span's trace id
            headers[TRACE_HEADER] = wire
        try:
            try:
                conn.connect()
            except OSError as e:
                # connect phase: nothing reached the server, always
                # safe to retry — even for writes
                e.retryable = True
                raise
            try:
                conn.request(method, path + qs, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (ConnectionError, TimeoutError, OSError,
                    http.client.HTTPException) as e:
                # the request may have executed server-side; only
                # idempotent calls can safely go again
                e.retryable = idempotent
                raise
            if resp.status == 404:
                # the server maps KeyError -> 404; surface the SPI's
                # unknown-type signal so the client stays a drop-in
                try:
                    msg = json.loads(data.decode()).get("error", path)
                except Exception:
                    msg = path
                raise KeyError(msg)
            if resp.status >= 400:
                try:
                    msg = json.loads(data.decode()).get("error", "")
                except Exception:
                    msg = data[:200].decode(errors="replace")
                if resp.status in (503, 429):
                    # load shed (503) or ingest admission refusal (429):
                    # the server refused BEFORE executing, so a retry is
                    # duplicate-safe for any method; honor its explicit
                    # backpressure hint — this is how a remote writer
                    # experiences the ingest governor's blocking put
                    ra = resp.getheader("Retry-After")
                    raise RemoteError(
                        f"{resp.status} {path}: {msg}",
                        status=resp.status, retryable=True,
                        retry_after_s=float(ra) if ra else None)
                raise RemoteError(f"{resp.status} {path}: {msg}",
                                  status=resp.status,
                                  retryable=idempotent
                                  and resp.status >= 500)
            return resp.getheader("Content-Type", ""), data
        finally:
            conn.close()

    def _json(self, method: str, path: str, params=None, body=None):
        _, data = self._request(method, path, params, body)
        return json.loads(data.decode())

    # -- schema management -------------------------------------------------

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        self._json("POST", f"/rest/schemas/{quote(sft.type_name)}",
                   body=sft.to_spec().encode())
        self._schemas[sft.type_name] = sft

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        if type_name not in self._schemas:
            meta = self._json("GET", f"/rest/schemas/{quote(type_name)}")
            self._schemas[type_name] = parse_spec(type_name,
                                                  meta["spec"])
        return self._schemas[type_name]

    def get_type_names(self) -> list[str]:
        return list(self._json("GET", "/rest/schemas"))

    def remove_schema(self, type_name: str):
        self._json("DELETE", f"/rest/schemas/{quote(type_name)}")
        self._schemas.pop(type_name, None)

    # -- writes ------------------------------------------------------------

    def write(self, type_name: str, batch: FeatureBatch,
              visibilities=None, **kwargs):
        import pyarrow as pa
        table = pa.Table.from_batches([batch.to_arrow()])
        if visibilities is not None:
            vis = np.asarray(visibilities, dtype=object)
            if len(vis) != batch.n:
                raise ValueError("visibilities length mismatch")
            table = table.append_column(
                "__vis__", pa.array([None if v is None else str(v)
                                     for v in vis], pa.string()))
        sink = io.BytesIO()
        with pa.ipc.new_file(sink, table.schema) as w:
            w.write_table(table)
        out = self._json("POST", f"/rest/write/{quote(type_name)}",
                         body=sink.getvalue())
        # durable-LSN stamp when the server journals: the replication
        # router waits on it for its replica ack
        return out.get("lsn")

    def delete(self, type_name: str, ids):
        out = self._json("POST", f"/rest/delete/{quote(type_name)}",
                         body=json.dumps([str(i) for i in ids]).encode())
        return out.get("lsn")

    # -- queries -----------------------------------------------------------

    @staticmethod
    def _as_query(q: Query | str, type_name: str | None) -> Query:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        return q

    @staticmethod
    def _query_params(q: Query, fmt: str) -> dict:
        params: dict[str, Any] = {"cql": str(q.filter), "format": fmt}
        if q.max_features is not None:
            params["maxFeatures"] = q.max_features
        if q.properties is not None:
            params["properties"] = ",".join(q.properties)
        if q.sort_by is not None:
            params["sortBy"] = q.sort_by
            params["sortOrder"] = "desc" if q.sort_desc else "asc"
        if q.auths is not None:
            params["auths"] = ",".join(q.auths)
        if QueryHints.SAMPLING in q.hints:
            params["sampling"] = q.hints[QueryHints.SAMPLING]
        if QueryHints.SAMPLE_BY in q.hints:
            params["sampleBy"] = q.hints[QueryHints.SAMPLE_BY]
        if QueryHints.QUERY_INDEX in q.hints:
            params["index"] = q.hints[QueryHints.QUERY_INDEX]
        return params

    def _result_sft(self, q: Query) -> SimpleFeatureType:
        sft = self.get_schema(q.type_name)
        if q.properties is not None:
            keep = set(q.properties)
            sft = SimpleFeatureType(
                sft.type_name,
                [a for a in sft.attributes if a.name in keep],
                sft.user_data)
        return sft

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None):
        q = self._as_query(q, type_name)
        params = self._query_params(q, "arrow")
        t0 = time.perf_counter()
        _, data = self._request("GET", f"/rest/query/{quote(q.type_name)}",
                                params)
        t_fetch_ms = (time.perf_counter() - t0) * 1000
        sft = self._result_sft(q)
        import pyarrow as pa
        with pa.ipc.open_file(io.BytesIO(data)) as rd:
            table = rd.read_all()
        batches = [FeatureBatch.from_arrow(sft, rb)
                   for rb in table.to_batches() if rb.num_rows]
        batch = (FeatureBatch.concat_all(batches) if batches
                 else FeatureBatch.from_dict(
                     sft, np.empty(0, dtype=object),
                     {a.name: ((np.empty(0), np.empty(0))
                               if a.type.name == "Point" else [])
                      for a in sft.attributes}))
        from .memory import QueryResult
        from ..index.api import Explainer
        from ..audit import audit_query
        audit_query(self.audit, "remote", q.type_name, str(q.filter),
                    q.hints, 0.0, t_fetch_ms, batch.n, index="remote")
        return QueryResult(np.arange(batch.n, dtype=np.int64), batch.ids,
                           batch, Explainer(),
                           FilterStrategy("remote", q.filter, None))

    # -- streaming reads ---------------------------------------------------

    def _open_stream(self, path: str, params: dict):
        """Open a chunked streaming GET: retries/breakers cover only
        the pre-stream phase (connect + status line); once headers are
        back the connection is handed to the consuming generator. Never
        hedged — see ``_maybe_hedged``."""
        segs = path.strip("/").split("/")
        endpoint = segs[1] if len(segs) > 1 else "root"
        breaker = self._breakers.get(endpoint)
        qs = ("?" + urlencode(params)) if params else ""
        headers = {}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        from ..obs import TRACE_HEADER, tracer
        wire = tracer.inject()
        if wire is not None:
            headers[TRACE_HEADER] = wire

        def attempt():
            breaker.acquire()
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            try:
                try:
                    conn.connect()
                except OSError as e:
                    e.retryable = True
                    raise
                try:
                    conn.request("GET", path + qs, headers=headers)
                    resp = conn.getresponse()
                except (ConnectionError, TimeoutError, OSError,
                        http.client.HTTPException) as e:
                    e.retryable = True  # no stream bytes delivered yet
                    raise
                if resp.status == 404:
                    try:
                        msg = json.loads(resp.read().decode()) \
                            .get("error", path)
                    except Exception:
                        msg = path
                    raise KeyError(msg)
                if resp.status >= 400:
                    data = resp.read()
                    try:
                        msg = json.loads(data.decode()).get("error", "")
                    except Exception:
                        msg = data[:200].decode(errors="replace")
                    raise RemoteError(f"{resp.status} {path}: {msg}",
                                      status=resp.status,
                                      retryable=resp.status in (503,)
                                      or resp.status >= 500)
            except Exception as e:
                conn.close()
                if _breaker_counts(e):
                    breaker.failure()
                else:
                    breaker.success()
                raise
            breaker.success()
            return conn, resp

        return self._retry.call(
            self._maybe_hedged(attempt, breaker, endpoint, True,
                               streaming=True),
            name=f"remote.{endpoint}.stream")

    def query_stream(self, q: Query | str, type_name: str | None = None,
                     batch_rows: int | None = None):
        """Stream matching features as FeatureBatches decoded
        incrementally off a chunked ``format=arrow-stream`` response:
        client-side memory is bounded by one wire batch regardless of
        hit count, and the first batch arrives while the server is
        still encoding the rest. A mid-stream transport fault or
        truncated response raises a typed ``RemoteError`` — never a
        silently-short result (the chunked framing carries an explicit
        end-of-stream marker)."""
        q = self._as_query(q, type_name)
        params = self._query_params(q, "arrow-stream")
        if batch_rows is not None:
            params["batchRows"] = int(batch_rows)
        # resolve the SFT (its own HTTP round-trip) before opening the
        # stream: a failure here must not leak a live connection
        sft = self._result_sft(q)
        conn, resp = self._open_stream(
            f"/rest/query/{quote(q.type_name)}", params)

        def gen():
            import pyarrow as pa
            try:
                try:
                    rd = pa.ipc.open_stream(resp)
                    for rb in rd:
                        if rb.num_rows:
                            yield FeatureBatch.from_arrow(sft, rb)
                    resp.read()  # the chunked terminator must be intact
                except (ConnectionError, TimeoutError, OSError,
                        http.client.HTTPException, pa.ArrowInvalid) as e:
                    raise RemoteError(
                        f"stream interrupted mid-transfer: {e!r}",
                        retryable=False) from e
            finally:
                conn.close()
        return gen()

    def bin_stream(self, q: Query | str, type_name: str | None = None,
                   track: str | None = None, label: str | None = None):
        """Stream the compact BIN wire encoding (16/24-byte records)
        for a query: yields raw record chunks off a chunked
        ``format=bin`` response. Same typed-error contract as
        ``query_stream``."""
        q = self._as_query(q, type_name)
        params = self._query_params(q, "bin")
        if track:
            params["track"] = track
        if label:
            params["label"] = label
        conn, resp = self._open_stream(
            f"/rest/query/{quote(q.type_name)}", params)

        def gen():
            try:
                try:
                    while True:
                        chunk = resp.read(65536)
                        if not chunk:
                            break
                        yield chunk
                except (ConnectionError, TimeoutError, OSError,
                        http.client.HTTPException) as e:
                    raise RemoteError(
                        f"stream interrupted mid-transfer: {e!r}",
                        retryable=False) from e
            finally:
                conn.close()
        return gen()

    def bin_query(self, type_name: str, ecql="INCLUDE",
                  track: str | None = None, label: str | None = None,
                  sort: bool = False) -> bytes:
        """Server-side BIN aggregation (GET /rest/bin) — the contract
        surface every local backend exposes, materialized."""
        params: dict[str, Any] = {"cql": str(ecql or "INCLUDE")}
        if track:
            params["track"] = track
        if label:
            params["label"] = label
        if sort:
            params["sort"] = "true"
        _, data = self._request("GET", f"/rest/bin/{quote(type_name)}",
                                params)
        return data

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        """Materialized Arrow IPC file bytes, encoded server-side."""
        params: dict[str, Any] = {"cql": str(ecql or "INCLUDE"),
                                  "format": "arrow"}
        if sort_by:
            params["sortBy"] = sort_by
        _, data = self._request("GET", f"/rest/query/{quote(type_name)}",
                                params)
        return data

    def count(self, type_name: str) -> int:
        return int(self._json("GET", f"/rest/count/{quote(type_name)}")
                   ["count"])

    def estimate_count(self, type_name: str, f=None) -> int | None:
        """Server-side sketch cardinality estimate (GET /rest/estimate)
        — the remote leg of the cluster-merged planner estimate. None
        when the server cannot estimate OR cannot be reached: the
        planner treats both as cold stats, never an error."""
        try:
            est = self._json(
                "GET", f"/rest/estimate/{quote(type_name)}",
                params={"cql": str(f) if f is not None else "INCLUDE"}
            )["estimate"]
        except Exception:  # noqa: BLE001 — estimates are advisory
            return None
        return None if est is None else int(est)

    # -- distributed SQL legs ----------------------------------------------
    # POST bodies, but read-only: idempotent=True keeps them eligible
    # for the client's retry/hedge machinery

    def sql_partial(self, stmt: str) -> dict:
        """One shard group's partial-aggregate leg, evaluated server-
        side next to the data (sql/distributed.py wire format)."""
        _, data = self._request("POST", "/rest/sql",
                                params={"mode": "partial"},
                                body=stmt.encode(), idempotent=True)
        return json.loads(data.decode())

    def sql_join_partial(self, spec: dict) -> dict:
        """One shard group's broadcast-join leg: the spec carries the
        statement plus the encoded small side."""
        _, data = self._request("POST", "/rest/sql/join-partial",
                                body=json.dumps(spec).encode(),
                                idempotent=True)
        return json.loads(data.decode())

    def query_count(self, q: Query | str,
                    type_name: str | None = None) -> int:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        mapped = {QueryHints.SAMPLING, QueryHints.SAMPLE_BY,
                  QueryHints.QUERY_INDEX}
        if set(q.hints) - mapped:
            # a hint the count endpoint cannot express: evaluate via
            # the full query surface so semantics stay exact
            return self.query(q).n
        # hinted/sampled/limited counts evaluate SERVER-side through
        # the same Query parse as /rest/query — the response is one
        # number, never O(n) rows shipped just to be len()'d here
        params: dict[str, Any] = {"cql": str(q.filter)}
        if q.max_features is not None:
            params["maxFeatures"] = q.max_features
        if q.auths is not None:
            params["auths"] = ",".join(q.auths)
        if QueryHints.SAMPLING in q.hints:
            params["sampling"] = q.hints[QueryHints.SAMPLING]
        if QueryHints.SAMPLE_BY in q.hints:
            params["sampleBy"] = q.hints[QueryHints.SAMPLE_BY]
        if QueryHints.QUERY_INDEX in q.hints:
            params["index"] = q.hints[QueryHints.QUERY_INDEX]
        t0 = time.perf_counter()
        n = int(self._json(
            "GET", f"/rest/count/{quote(q.type_name)}", params)["count"])
        from ..audit import audit_query
        audit_query(self.audit, "remote", q.type_name, str(q.filter),
                    q.hints, 0.0, (time.perf_counter() - t0) * 1000, n,
                    index="remote")
        return n

    # -- observability surfaces --------------------------------------------

    def traces(self, limit: int = 50) -> list[dict]:
        """Trace summaries from the server's ring (GET /rest/trace)."""
        return self._json("GET", "/rest/trace", {"limit": limit})

    def trace(self, trace_id: str) -> list[dict]:
        """Full span list for one trace (KeyError if unknown)."""
        return self._json("GET", f"/rest/trace/{quote(trace_id)}")

    def runtime_snapshot(self) -> dict:
        """Runtime telemetry: compile churn, device memory, transfer
        bytes (GET /rest/runtime)."""
        return self._json("GET", "/rest/runtime")

    def slo_status(self) -> dict:
        """SLO burn-rate/alert state (GET /rest/slo)."""
        return self._json("GET", "/rest/slo")

    def qos_status(self) -> dict:
        """Per-tenant QoS state: in-flight caps, row buckets, retry
        budgets (GET /rest/qos)."""
        return self._json("GET", "/rest/qos")

    def profile_collapsed(self) -> str:
        """Collapsed-stack profile text (GET /rest/profile)."""
        _, data = self._request("GET", "/rest/profile")
        return data.decode("utf-8", "replace")

    def audit_events(self, type_name: str | None = None,
                     since_ms: int | None = None) -> list[dict]:
        """Server-side audit events (GET /rest/audit)."""
        params: dict[str, Any] = {}
        if type_name is not None:
            params["type"] = type_name
        if since_ms is not None:
            params["since"] = since_ms
        return self._json("GET", "/rest/audit", params or None)

    # -- server-side analytics ---------------------------------------------

    def stats_query(self, type_name: str, stat_spec: str, ecql=None):
        params = {"stat": stat_spec}
        if ecql:
            params["cql"] = str(ecql)
        return self._json("GET", f"/rest/stats/{quote(type_name)}", params)

    def density(self, type_name: str, ecql, bbox, width: int,
                height: int):
        out = self._json("GET", f"/rest/density/{quote(type_name)}",
                         {"cql": str(ecql or "INCLUDE"),
                          "bbox": ",".join(str(v) for v in bbox),
                          "width": width, "height": height})
        return np.asarray(out["grid"], dtype=np.float32)

    # -- health / replication ------------------------------------------------

    def probe_health(self, timeout_s: float = 1.0) -> bool:
        """One direct liveness probe: no retries, no breaker, short
        timeout — the replication router's failure detector must see
        the primary's real state NOW, not a retry-masked one."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)
        try:
            conn.request("GET", "/rest/health")
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except (ConnectionError, TimeoutError, OSError,
                http.client.HTTPException):
            return False
        finally:
            conn.close()

    def replication_status(self) -> dict:
        """GET /rest/replication (server must front a replicated or
        shipping store)."""
        return self._json("GET", "/rest/replication")

    def promote(self) -> dict:
        """POST /rest/replication/promote (bearer-gated like the other
        mutating admin routes)."""
        return self._json("POST", "/rest/replication/promote")

    def cluster_status(self) -> dict:
        """GET /rest/cluster (server must front a ClusterDataStore)."""
        return self._json("GET", "/rest/cluster")

    def promote_group(self, group: str | None = None) -> dict:
        """POST /rest/cluster/promote?group=NAME (bearer-gated):
        force intra-group failover on a cluster coordinator server."""
        params = {"group": group} if group else None
        return self._json("POST", "/rest/cluster/promote", params)

    def topology(self, include_counts: bool = True) -> dict:
        """GET /rest/topology: the cluster's epoch-stamped segment
        map (server must front a ClusterDataStore)."""
        params = None if include_counts else {"counts": "false"}
        return self._json("GET", "/rest/topology", params)

    def reshard_status(self) -> dict:
        """GET /rest/reshard: migrations in flight, epoch history,
        cooldown."""
        return self._json("GET", "/rest/reshard")

    def reshard(self, verb: str, **params) -> dict:
        """POST /rest/reshard/{split|migrate|resume|abort|auto}
        (bearer-gated). Keyword args become query params (e.g.
        ``reshard("split", src="shard2")``)."""
        clean = {k: v for k, v in params.items() if v is not None}
        return self._json("POST", f"/rest/reshard/{quote(verb)}",
                          clean or None)

    def reindex(self, type_name: str,
                to_version: int | None = None) -> dict:
        """POST /rest/reindex/{type}?version= (bearer-gated): the
        BLOCKING reindex oracle — the server holds its store op lock
        for the whole rebuild. Use ``evolve("reindex", ...)`` for the
        online shadow-build migration."""
        params = ({"version": int(to_version)}
                  if to_version is not None else None)
        return self._json("POST", f"/rest/reindex/{quote(type_name)}",
                          params)

    def evolve_status(self) -> dict:
        """GET /rest/evolve: active evolution (phase, cursor, barrier)
        plus completed history."""
        return self._json("GET", "/rest/evolve")

    def evolve(self, verb: str, **params) -> dict:
        """POST /rest/evolve/{reindex|update|resume|abort}
        (bearer-gated). Keyword args become query params; an ``update``
        change list ships in a JSON body (e.g. ``evolve("update",
        type="t", changes=[{"op": "add", ...}])``)."""
        clean = {k: v for k, v in params.items() if v is not None}
        body = None
        changes = clean.pop("changes", None)
        if changes is not None:
            body = json.dumps({"type": clean.pop("type", None),
                               "changes": changes}).encode()
        return self._json("POST", f"/rest/evolve/{quote(verb)}",
                          clean or None, body=body)

    def cache_status(self) -> dict:
        """GET /rest/cache: the server store's materialized-cache
        status (entries, bytes, hit/miss counters, refresher state)."""
        return self._json("GET", "/rest/cache")

    def invalidate_cache(self, type_name: str | None = None) -> int:
        """POST /rest/cache/invalidate[?type=NAME] (bearer-gated);
        returns the number of entries dropped server-side."""
        params = {"type": type_name} if type_name else None
        out = self._json("POST", "/rest/cache/invalidate", params)
        return int(out.get("invalidated", 0))

    def cq_status(self) -> dict:
        """GET /rest/cq: registered continuous queries plus per-type
        device filter-set stats."""
        return self._json("GET", "/rest/cq")

    def cq_register(self, name: str, type_name: str,
                    ecql: str = "INCLUDE") -> dict:
        """POST /rest/cq/register (bearer-gated); the ECQL travels in a
        JSON body, not the query string."""
        body = json.dumps({"name": name, "type": type_name,
                           "ecql": ecql}).encode()
        return self._json("POST", "/rest/cq/register", body=body)

    def cq_unregister(self, name: str) -> dict:
        """POST /rest/cq/unregister?name= (bearer-gated)."""
        return self._json("POST", "/rest/cq/unregister", {"name": name})

    def views_status(self) -> dict:
        """GET /rest/views: registered materialized views with fold
        counters and LSN staleness."""
        return self._json("GET", "/rest/views")

    def views_get(self, name: str) -> dict:
        """GET /rest/views/{name}: the view's rows at its fold LSN."""
        return self._json("GET", f"/rest/views/{quote(name)}")

    def views_register(self, name: str, sql: str) -> dict:
        """POST /rest/views/register (bearer-gated); the standing
        SELECT travels in a JSON body, not the query string."""
        body = json.dumps({"name": name, "sql": sql}).encode()
        return self._json("POST", "/rest/views/register", body=body)

    def views_unregister(self, name: str) -> dict:
        """POST /rest/views/unregister?name= (bearer-gated)."""
        return self._json("POST", "/rest/views/unregister",
                          {"name": name})

    def views_refresh(self, name: str) -> dict:
        """POST /rest/views/refresh?name= (bearer-gated): full
        re-execution — the O(table) baseline the folds replace."""
        return self._json("POST", "/rest/views/refresh", {"name": name})
