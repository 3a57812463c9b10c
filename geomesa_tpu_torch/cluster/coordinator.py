"""ClusterDataStore: Z-sharded scatter-gather over shard groups.

The reference scales horizontally by splitting z-ordered tables into
tablets and fanning queries across region servers in the coprocessor
scatter-gather shape (GeoMesaCoprocessor.scala:105-123): each server
computes a partial (ids, counts, bin chunks, stat sketches, arrow
batches) over its tablet ranges and the client merges. This module is
that shape one level up the stack: N *shard groups* — each typically a
primary + WAL-shipped replicas behind ``ReplicatedDataStore`` — own
disjoint z-prefix ranges (partition.py), writes route to the owning
group, and reads scatter to every group and merge exactly (the
partition is disjoint, so unions/sums/sketch-merges are exact, never
deduped or estimated).

Failure semantics are the point (a cluster that hangs or silently
drops a shard's rows is worse than a single store):

- every scatter leg runs under ``geomesa.cluster.leg.deadline.s`` with
  a hedged second attempt through the shared ``HedgePolicy``
  (resilience/hedge.py): after the group's observed p99-ish latency
  once the EWMA has samples, else the static
  ``geomesa.cluster.hedge.ms`` (for a
  replicated group the hedge naturally lands on a different replica —
  the router round-robins), and a per-group breaker
  (resilience/breaker.py) fast-fails legs into a known-dead group;
- a group losing its primary auto-promotes internally (the router's probe +
  most-caught-up election, zero acked-write loss) — the cluster keeps
  routing to the group object, which now fronts the promoted replica;
- cross-shard read-your-writes: every acked write bumps a per-group
  **LSN vector** (returned from ``write``/``delete`` and surfaced in
  ``cluster_status``); scatter legs against replicated groups carry a
  min-LSN gate — the staleness bound tightens to ``primary_estimate -
  acked_lsn`` so no replica that has not applied this client's writes
  can serve the leg (the router's bounded-staleness contract, pointed at
  consistency instead of freshness);
- when a whole group stays down past its deadline the query fails
  **typed** (``ShardUnavailableError`` naming the group and its owned
  z-ranges) — or, behind ``geomesa.cluster.allow.partial``, returns a
  result flagged ``complete=False`` with the missing z-ranges attached
  (``missing_z_ranges``). Silent wrong answers are structurally
  impossible: a merge only runs over legs that succeeded, and any
  missing leg either raises or flags.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import parse_spec
from ..index.api import Explainer, FilterStrategy, Query
from ..metrics import metrics
from ..resilience.breaker import BreakerBoard, CircuitOpenError
from ..resilience.hedge import HedgePolicy
from ..resilience.policy import RetryBudget
from ..store.api import DataStore
from ..store.memory import QueryResult
from ..utils.device import cuda_index, device_scope
from ..utils.properties import SystemProperty
from .partition import PREFIX_BITS, ZPrefixPartitioner
from .reshard import _OpGate, ReshardError, StaleTopologyError

__all__ = ["ClusterDataStore", "ClusterQueryResult",
           "ShardUnavailableError", "PartialCount",
           "ReshardError", "StaleTopologyError",
           "CLUSTER_LEG_DEADLINE_S", "CLUSTER_HEDGE_MS",
           "CLUSTER_ALLOW_PARTIAL", "CLUSTER_PRUNE"]

# per-scatter-leg deadline: a group that cannot answer inside this is
# treated as down for THIS query (typed failure or flagged partial)
CLUSTER_LEG_DEADLINE_S = SystemProperty("geomesa.cluster.leg.deadline.s",
                                        "5")
# tail-latency hedge: when a leg's first attempt has not answered
# after this long, a second attempt launches against the same group
# (a replicated group round-robins it to a different replica)
CLUSTER_HEDGE_MS = SystemProperty("geomesa.cluster.hedge.ms", "75")
# partial-results mode: False (default) -> a down group fails the
# query typed; True -> merge the live legs and flag the result
# complete=False with the missing z-ranges
CLUSTER_ALLOW_PARTIAL = SystemProperty("geomesa.cluster.allow.partial",
                                       "false")
# Z-range leg pruning kill switch: "false" scatters every read to
# every group (today's pre-planner behavior, bit-identical)
CLUSTER_PRUNE = SystemProperty("geomesa.cluster.prune", "true")


def _gated(fn):
    """Run a cluster read under the shared side of the op gate (see
    ``ClusterDataStore._op``): concurrent with other ops, drained by
    the reshard flip's exclusive section, typed-failed while a crashed
    flip leaves the topology inconsistent."""
    def wrapper(self, *args, **kwargs):
        with self._op():
            return fn(self, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


class ShardUnavailableError(ConnectionError):
    """One or more shard groups could not serve their scatter leg
    inside the deadline. Carries which groups and which z-ranges of
    the keyspace are therefore unreadable. NOT retryable as-is: the
    breaker holds the group out until it half-opens."""

    retryable = False

    def __init__(self, groups, z_ranges, detail: str = ""):
        self.groups = list(groups)
        self.z_ranges = list(z_ranges)
        msg = (f"shard group(s) unavailable: {', '.join(self.groups)}"
               f" (missing z-ranges: "
               f"{[(r['z_lo'], r['z_hi']) for r in self.z_ranges]})")
        super().__init__(msg + (f": {detail}" if detail else ""))


class PartialCount(int):
    """An int count flagged incomplete — plain ints cannot carry the
    partial-results metadata, and a count missing a shard must never
    look like a complete one."""

    complete = False
    missing_groups: list = []
    missing_z_ranges: list = []


class _PartialGrid(np.ndarray):
    """Density grid flagged incomplete (view-cast ndarray)."""

    complete = False


class _PartialBytes(bytes):
    """bin/arrow payload flagged incomplete."""

    complete = False


class _ClusterStream:
    """Iterator of merged FeatureBatches from streamed scatter legs,
    carrying the partial-results contract. ``complete`` /
    ``missing_groups`` / ``missing_z_ranges`` are final once the
    stream is exhausted (a leg can only drop out while it runs)."""

    def __init__(self):
        self._gen = iter(())
        self.complete = True
        self.missing_groups: list[str] = []
        self.missing_z_ranges: list[dict] = []
        self._on_close = None

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        # closing a never-started generator skips its finally, so the
        # op-gate release hooks here too (idempotent)
        self._gen.close()
        if self._on_close is not None:
            self._on_close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — finalizer
            pass


class ClusterQueryResult(QueryResult):
    """QueryResult plus the cluster contract: ``complete`` /
    ``missing_groups`` / ``missing_z_ranges`` (partial-results mode)
    and ``lsn_vector`` (the per-group acked-LSN snapshot this result
    is consistent with)."""

    def __init__(self, ids, batch, explain, plan, n=None):
        # rows: positions in the merged result (the port's QueryResult
        # carries row indices; the reference's carries a count)
        super().__init__(np.arange(len(ids) if n is None else n,
                                   dtype=np.int64),
                         ids, batch, explain, plan)
        self.complete = True
        self.missing_groups: list[str] = []
        self.missing_z_ranges: list[dict] = []
        self.lsn_vector: dict[str, int] = {}


class ClusterDataStore(DataStore):
    """One DataStore façade over N z-partitioned shard groups.

    ``groups`` is a list of DataStores — typically
    ``ReplicatedDataStore`` (primary + replicas; gives the cluster
    intra-group failover and hedge-to-replica) or ``RemoteDataStore``
    (a federation of web servers; ``cluster://h1:p1,h2:p2`` builds
    this shape). ``names`` labels them for status/metrics/errors
    (default ``shard0..shardN-1``).

    Ctor overrides beat the system-property knobs; a ``None`` override
    re-reads the knob per call so tests and operators can flip
    ``geomesa.cluster.allow.partial`` on a live cluster.

    Every thread that runs a group's operation (scatter legs and their
    hedged backups, stream producers, the autoscaler loop) runs with
    that group's card as its current CUDA device. Density grids sum in
    group order, so a weighted grid is the same bits on every run.
    """

    def __init__(self, groups, names=None, leg_deadline_s=None,
                 hedge_ms=None, allow_partial=None, registry=metrics,
                 audit=None):
        if not groups:
            raise ValueError("at least one shard group required")
        self.audit = audit  # AuditLogger or None (global fallback)
        self._groups = list(groups)
        self._names = (list(names) if names is not None
                       else [f"shard{i}" for i in range(len(groups))])
        if len(self._names) != len(self._groups):
            raise ValueError("names/groups length mismatch")
        if len(set(self._names)) != len(self._names):
            raise ValueError("duplicate group names")
        # each group's card, read on the building thread (see cuda_index)
        self._cuda = {n: cuda_index(g)
                      for n, g in zip(self._names, self._groups)}
        self._part = ZPrefixPartitioner(len(self._groups))
        self._leg_deadline_override = leg_deadline_s
        self._hedge_override = hedge_ms
        self._allow_partial_override = allow_partial
        self._registry = registry
        self._breakers = BreakerBoard(registry=registry)
        # shared hedging helper (resilience/hedge.py): scatter legs
        # launch their backup attempt through it, charged to a
        # cluster-wide retry budget
        self._hedge = HedgePolicy(budget=RetryBudget(), registry=registry)
        self._lock = threading.Lock()
        self._lsn_vector: dict[str, int] = {}
        self._sfts: dict = {}
        # scatter-plan surface: per-thread latest (concurrent queries
        # must not clobber each other's plan reads) plus a global
        # latest for the admin/status view
        self._plan_tls = threading.local()
        self._last_plan: dict | None = None
        # (type, filter-text) -> prune decision: real query mixes
        # repeat filter shapes, and the covering-range derivation is
        # pure in (schema, filter, topology) — invalidated on schema
        # change (see create_schema/remove_schema) and on topology
        # epoch change (the reshard flip)
        self._prune_cache: dict[tuple[str, str], tuple] = {}
        # elastic topology: every op takes the shared side of the gate,
        # the reshard flip takes the exclusive side; _migration is the
        # in-flight range move (double-routing + staging), installed
        # and cleared by the Resharder under the exclusive gate
        self._gate = _OpGate()
        self._migration = None
        self._resharder = None
        self._autoscaler = None
        registry.gauge("cluster.groups", len(self._groups))

    @property
    def device(self):
        """The groups' device when they all share one (the SQL engine
        runs coordinator-side joins there), else None."""
        devs = {str(getattr(g, "device", None)) for g in self._groups}
        return (getattr(self._groups[0], "device", None)
                if len(devs) == 1 else None)

    def _on_device(self, name: str, fn):
        """``fn`` run with group ``name``'s card as the current device."""
        index = self._cuda.get(name)
        if index is None:
            return fn

        def run():
            with device_scope(index):
                return fn()
        return run

    # -- elastic topology --------------------------------------------------

    @property
    def resharder(self):
        """The split/migrate executor for this cluster (lazy)."""
        if self._resharder is None:
            from .reshard import Resharder
            self._resharder = Resharder(self, registry=self._registry)
        return self._resharder

    @property
    def autoscaler(self):
        """The SLO/latency-driven control loop for this cluster (lazy;
        propose-only until ``geomesa.reshard.auto`` is set)."""
        if self._autoscaler is None:
            from .autoscale import Autoscaler
            self._autoscaler = Autoscaler(self, self.resharder,
                                          registry=self._registry)
        return self._autoscaler

    @contextlib.contextmanager
    def _op(self):
        """Every read/write runs under the shared side of the op gate
        (the flip drains them via the exclusive side), and fails typed
        while a crashed flip leaves the topology inconsistent —
        exact-or-typed, never a silently duplicated merge."""
        with self._gate.shared():
            mig = self._migration
            if mig is not None and mig.blocking:
                raise ReshardError(
                    f"topology flip incomplete (migration "
                    f"{mig.src_name}->{mig.dst_name}, phase "
                    f"{mig.phase}); resume or abort the reshard")
            yield

    def _check_epoch(self, topology_epoch):
        """Zombie-write fence: a client that routed against a topology
        the cluster has flipped past must fail typed and re-route (the
        router's promote-cutoff pattern pointed at topology)."""
        if topology_epoch is None:
            return
        if int(topology_epoch) != self._part.epoch:
            self._registry.counter("cluster.reshard.zombie.rejects")
            raise StaleTopologyError(
                f"write routed under topology epoch {topology_epoch} "
                f"but the cluster is at epoch {self._part.epoch}",
                epoch=int(topology_epoch), current=self._part.epoch)

    def topology(self, include_counts: bool = True) -> dict:
        """The versioned topology document (``GET /rest/topology``):
        epoch, boundary segments, per-group owned ranges + row counts
        (the key-density summary), the active migration, and the epoch
        history."""
        part = self._part
        mig = self._migration
        from .autoscale import RESHARD_AUTO
        from .reshard import RESHARD_ENABLED
        groups = []
        for i, (name, g) in enumerate(zip(self._names, self._groups)):
            ent: dict = {"name": name,
                         "ranges": [{"prefix_lo": lo, "prefix_hi": hi}
                                    for lo, hi
                                    in part.owned_prefix_ranges(i)]}
            if include_counts:
                rows: int | None = 0
                for tn in self.get_type_names():
                    try:
                        rows += int(g.count(tn))
                    except Exception:  # noqa: BLE001 — status surface
                        rows = None
                        break
                ent["rows"] = rows
            groups.append(ent)
        self._registry.gauge("cluster.topology.epoch", part.epoch)
        return {"epoch": part.epoch,
                "prefix_bits": PREFIX_BITS,
                "n_groups": len(self._groups),
                "enabled": bool(RESHARD_ENABLED.as_bool()),
                "auto": bool(RESHARD_AUTO.as_bool()),
                "segments": [dict(s, name=self._names[s["group"]])
                             for s in part.segments()],
                "groups": groups,
                "migration": mig.describe() if mig is not None else None,
                "history": list(self.resharder.history)}

    # -- knobs -------------------------------------------------------------

    def _leg_deadline_s(self) -> float:
        if self._leg_deadline_override is not None:
            return float(self._leg_deadline_override)
        return CLUSTER_LEG_DEADLINE_S.as_float() or 5.0

    def _hedge_s(self) -> float:
        if self._hedge_override is not None:
            return float(self._hedge_override) / 1e3
        return (CLUSTER_HEDGE_MS.as_float() or 75.0) / 1e3

    def _allow_partial(self) -> bool:
        if self._allow_partial_override is not None:
            return bool(self._allow_partial_override)
        return bool(CLUSTER_ALLOW_PARTIAL.as_bool())

    # -- uri ---------------------------------------------------------------

    @classmethod
    def from_uri(cls, uri: str, auth_token: str | None = None,
                 **kwargs) -> "ClusterDataStore":
        """``cluster://host1:port1,host2:port2,...`` — one
        RemoteDataStore shard group per endpoint (the two-process
        federation shape)."""
        if not uri.startswith("cluster://"):
            raise ValueError(f"not a cluster uri: {uri!r}")
        endpoints = [e.strip() for e in uri[len("cluster://"):].split(",")
                     if e.strip()]
        if not endpoints:
            raise ValueError("cluster:// uri names no endpoints")
        from ..store.remote import RemoteDataStore
        groups = []
        for ep in endpoints:
            host, _, port = ep.rpartition(":")
            if not port.isdigit():
                raise ValueError(f"bad cluster endpoint {ep!r} "
                                 "(want host:port)")
            groups.append(RemoteDataStore(host or "127.0.0.1", int(port),
                                          auth_token=auth_token))
        return cls(groups, names=endpoints, **kwargs)

    # -- scatter machinery -------------------------------------------------

    def _leg(self, name: str, fn, deadline: float, hedge_s: float,
             results: dict, failures: dict):
        """Run one scatter leg: breaker-gated, deadline-bounded, with
        one hedged backup through the shared ``HedgePolicy``
        (resilience/hedge.py). The speculative delay prefers the
        group's observed p99-ish latency over the static
        ``geomesa.cluster.hedge.ms`` once the EWMA has samples — a
        fast group hedges sooner, a slow one stops hedging on every
        call — and hedges are charged to the cluster's retry budget so
        a cluster-wide brownout can't double its own load."""
        from ..obs import tracer
        with tracer.span("scatter-leg", name) as sp:
            breaker = self._breakers.get(name)
            try:
                breaker.acquire()
            except CircuitOpenError as e:
                self._registry.counter("cluster.leg.fastfails")
                sp.annotate("breaker.fastfail")
                failures[name] = e
                return
            t0 = time.perf_counter()
            delay = self._hedge.delay_s(
                self._breakers.latency_p99_s(name))
            if delay is None:
                delay = hedge_s  # no estimate yet: the static knob
            if self._hedge.budget is not None:
                self._hedge.budget.deposit()  # first attempts earn
            try:
                from ..obs.prof import watchdog
                with watchdog.watch(f"scatter-leg.{name}", span=sp):
                    v = self._hedge.call(
                        fn, delay, deadline_s=deadline,
                        name=f"cluster.{name}",
                        on_hedge=lambda: self._registry.counter(
                            "cluster.leg.hedges"))
            except TimeoutError:
                breaker.failure()
                self._registry.counter("cluster.leg.failures")
                self._registry.counter("cluster.leg.timeouts")
                sp.annotate("leg.timeout", deadline_s=deadline)
                failures[name] = TimeoutError(
                    f"shard leg {name!r} exceeded its {deadline:g}s "
                    "deadline")
            except Exception as e:  # noqa: BLE001 — leg boundary
                breaker.failure()
                self._registry.counter("cluster.leg.failures")
                sp.annotate("leg.failed", error=type(e).__name__)
                failures[name] = e
            else:
                breaker.success()
                self._breakers.observe(name, time.perf_counter() - t0)
                results[name] = v

    def _scatter(self, make_fn, legs=None) -> tuple[dict, dict]:
        """Fan one read out to every group — or, with ``legs``, only
        the named subset the planner proved can hold matching rows (a
        Z-pruned leg is never contacted, so it can never fail and can
        never be reported missing: pruned != unavailable).
        ``make_fn(name, group)`` returns the zero-arg leg callable.
        Returns ``(results_by_name, failures_by_name)``."""
        self._registry.counter("cluster.scatter.calls")
        pairs = list(zip(self._names, self._groups))
        if legs is not None:
            want = set(legs)
            pairs = [(n, g) for n, g in pairs if n in want]
        deadline, hedge_s = self._leg_deadline_s(), self._hedge_s()
        results: dict = {}
        failures: dict = {}
        if len(pairs) == 1:
            # single-leg scatter (a fully-pruned selective read): run
            # inline — a thread buys no parallelism and its spawn/join
            # cost dominates a selective leg
            name, group = pairs[0]
            self._leg(name, self._on_device(name, make_fn(name, group)),
                      deadline, hedge_s, results, failures)
            return results, failures
        threads = []
        for name, group in pairs:
            # each leg thread runs under a copy of the caller's
            # context: trace spans parent correctly and the audit
            # hook's delegation suppression reaches the inner stores
            ctx = contextvars.copy_context()
            t = threading.Thread(
                target=ctx.run,
                args=(self._leg, name,
                      self._on_device(name, make_fn(name, group)),
                      deadline, hedge_s, results, failures),
                daemon=True, name=f"cluster-scatter-{name}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join(deadline + 5.0)
        return results, failures

    def _missing(self, failures: dict) -> dict | None:
        """Enforce the partial-results contract for a scatter with
        failed legs: raise typed by default, or describe what is
        missing for the caller to attach when the knob allows it."""
        if not failures:
            return None
        names = sorted(failures)
        z_ranges = [self._part.z_range(self._names.index(n))
                    for n in names]
        if not self._allow_partial():
            self._registry.counter("cluster.scatter.failed")
            raise ShardUnavailableError(
                names, z_ranges,
                detail="; ".join(f"{n}: {type(failures[n]).__name__}: "
                                 f"{failures[n]}" for n in names)
            ) from failures[names[0]]
        self._registry.counter("cluster.scatter.partial")
        return {"groups": names, "z_ranges": z_ranges}

    # -- cost-based planning: leg pruning + cardinality estimates ----------

    def prune_for(self, type_name: str, flt) -> tuple[list[str] | None,
                                                      dict | None]:
        """Z-range leg pruning: the group names whose owned z range can
        intersect the filter's covering Z2 ranges, or ``(None, info)``
        when pruning does not apply (knob off, non-point schema, no
        spatial bound — routing and filtering only provably coincide
        for point schemas, where the routed coordinate IS the filtered
        geometry). ``info`` is the plan fragment explaining the
        decision; None exactly when the knob is off, so a disabled
        cluster's plans stay bit-identical to the pre-planner ones."""
        if not CLUSTER_PRUNE.as_bool():
            return None, None
        key = (type_name, str(flt))
        hit = self._prune_cache.get(key)
        if hit is not None:
            return hit
        out = self._prune_uncached(type_name, flt)
        if len(self._prune_cache) >= 256:
            self._prune_cache.pop(next(iter(self._prune_cache)))
        self._prune_cache[key] = out
        return out

    def _prune_uncached(self, type_name: str, flt):
        try:
            from ..filters import parse_ecql
            from ..filters.helper import extract_geometries
            sft = self.get_schema(type_name)
            if sft.geom_field is None or not sft.is_points:
                return None, {"pruning": "non-point-schema"}
            if flt is None:
                return None, {"pruning": "no-spatial-bound"}
            if isinstance(flt, str):
                flt = parse_ecql(flt)
            geoms = extract_geometries(flt, sft.geom_field)
            if geoms.disjoint:
                # provably-empty spatial constraint: contact no leg
                return [], {"pruning": "empty", "covering_ranges": 0}
            if geoms.is_empty:
                return None, {"pruning": "no-spatial-bound"}
            boxes = [(g.envelope.xmin, g.envelope.ymin,
                      g.envelope.xmax, g.envelope.ymax) for g in geoms]
            ranges = self._part.covering_ranges(boxes)
            keep = self._part.groups_for_ranges(ranges)
            names = [self._names[g] for g in keep]
            return names, {"pruning": "z-range",
                           "covering_ranges": int(len(ranges))}
        except Exception as e:  # noqa: BLE001 — pruning is advisory
            return None, {"pruning": f"error: {type(e).__name__}"}

    def _account_legs(self, op: str, type_name: str, legs,
                      info: dict | None = None) -> dict:
        """Record which legs a scatter will contact vs pruned, on the
        metrics plane and the cluster-level plan surface."""
        contacted = (list(self._names) if legs is None
                     else [n for n in self._names if n in set(legs)])
        pruned = [n for n in self._names if n not in contacted]
        plan = {"op": op, "type": type_name,
                "topology_epoch": self._part.epoch,
                "contacted": contacted, "pruned": pruned}
        if info:
            plan.update(info)
        self._registry.counter("cluster.legs.contacted", len(contacted))
        if pruned:
            self._registry.counter("cluster.legs.pruned", len(pruned))
        self._plan_tls.plan = plan
        self._last_plan = plan
        return plan

    def last_plan(self) -> dict | None:
        """The most recent scatter plan (contacted/pruned legs): this
        thread's if it has issued one, else the cluster-wide latest —
        the plan surface tests and operators assert pruning against."""
        return getattr(self._plan_tls, "plan", None) or self._last_plan

    def estimate_count(self, type_name: str, flt) -> int | None:
        """Cluster-merged cardinality estimate: each shard group
        estimates its own slice (O(cells) sketch math, no scan) and
        the coordinator sums — exact composition because the z-prefix
        partition is disjoint. None as soon as any group cannot
        estimate (cold type, cleared stats, unsupported filter): the
        SQL planner then falls back to static thresholds."""
        from ..sql.planner import estimate_for_store
        total = 0
        for group in self._groups:
            est = estimate_for_store(group, type_name, flt)
            if est is None:
                return None
            total += int(est)
        return total

    def _ryw_kwargs(self, name: str, group) -> dict:
        """Cross-shard read-your-writes: translate 'this leg must see
        everything we have acked on this group' (min LSN) into the
        replication router's max-lag bound — a replica is only
        eligible when primary_estimate - applied <= bound, i.e. when
        applied >= our acked LSN."""
        from ..replication.router import ReplicatedDataStore
        if not isinstance(group, ReplicatedDataStore):
            return {}
        with self._lock:
            acked = self._lsn_vector.get(name, 0)
        if not acked:
            return {}
        bound = max(group._primary_lsn_estimate() - acked, 0)
        if group.max_lag_lsn is not None:
            bound = min(bound, group.max_lag_lsn)
        return {"max_lag_lsn": bound}

    # -- schema management -------------------------------------------------

    def create_schema(self, sft, spec=None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        for name, group in zip(self._names, self._groups):
            ret = group.create_schema(sft)
            self._bump_lsn(name, group, ret)
        self._sfts[sft.type_name] = sft
        self._prune_cache.clear()
        mig = self._migration
        if mig is not None:
            # keep the staging store's schema view current so later
            # staged applies of the new type always land
            mig.pending.create_schema(sft)

    def get_schema(self, type_name: str):
        sft = self._sfts.get(type_name)
        if sft is not None:
            return sft
        err = None
        for group in self._groups:
            try:
                sft = group.get_schema(type_name)
            except KeyError:
                raise
            except Exception as e:  # noqa: BLE001 — try next group
                err = e
                continue
            self._sfts[type_name] = sft
            return sft
        raise err if err is not None else KeyError(type_name)

    def get_type_names(self) -> list[str]:
        err = None
        for group in self._groups:
            try:
                return group.get_type_names()
            except Exception as e:  # noqa: BLE001 — try next group
                err = e
        raise err if err is not None else RuntimeError("no groups")

    def remove_schema(self, type_name: str):
        for name, group in zip(self._names, self._groups):
            ret = group.remove_schema(type_name)
            self._bump_lsn(name, group, ret)
        self._sfts.pop(type_name, None)
        self._prune_cache.clear()
        mig = self._migration
        if mig is not None and type_name in mig.pending.get_type_names():
            mig.pending.remove_schema(type_name)

    # -- write path --------------------------------------------------------

    def _bump_lsn(self, name: str, group, returned):
        """Record the group's acked WAL position after a mutation —
        the component of the LSN vector later reads gate on."""
        lsn = None
        if isinstance(returned, (int, np.integer)):
            lsn = int(returned)
        elif isinstance(returned, dict):
            lsn = returned.get("lsn")
        if lsn is None:
            est = getattr(group, "_primary_lsn_estimate", None)
            if callable(est):
                lsn = est()
        if lsn is None:
            journal = getattr(group, "journal", None)
            if journal is not None:
                lsn = journal.wal.last_lsn
        if lsn:
            with self._lock:
                if lsn > self._lsn_vector.get(name, 0):
                    self._lsn_vector[name] = int(lsn)

    def lsn_vector(self) -> dict[str, int]:
        """Per-group acked LSNs: results consistent with this vector
        include every write this store instance has acknowledged."""
        with self._lock:
            return dict(self._lsn_vector)

    def write(self, type_name: str, batch: FeatureBatch,
              visibilities=None, topology_epoch=None, **kwargs):
        """Partition the batch by z-prefix owner and write each slice
        to its owning group. Returns the updated LSN vector. Groups
        are written in order; a failing group raises after earlier
        groups applied their slices (at-least-once on retry — the
        failed slice was never acked, so the zero-acked-loss contract
        holds). ``topology_epoch`` (optional) asserts the topology the
        caller routed against — a stale epoch fails typed before any
        slice lands."""
        with self._op():
            self._check_epoch(topology_epoch)
            sft = self.get_schema(type_name)
            owners = self._part.owners_for_batch(sft, batch)
            vis_arr = (np.asarray(visibilities, dtype=object)
                       if visibilities is not None else None)
            routed = 0
            for gi, (name, group) in enumerate(zip(self._names,
                                                   self._groups)):
                rows = np.flatnonzero(owners == gi)
                if not len(rows):
                    continue
                sub = batch if len(rows) == batch.n else batch.take(rows)
                vis = None if vis_arr is None else list(vis_arr[rows])
                ret = group.write(type_name, sub, visibilities=vis,
                                  **kwargs)
                self._bump_lsn(name, group, ret)
                routed += len(rows)
            mig = self._migration
            if mig is not None and mig.forward:
                # non-durable source: double-route the moving slice to
                # the migration's staging store (a durable source's
                # WAL tail carries it instead)
                mig.stage_write(sft, batch, visibilities=visibilities)
            self._registry.counter("cluster.writes.routed", routed)
            return self.lsn_vector()

    def write_many(self, type_name: str,
                   pairs: list[tuple[FeatureBatch, list | None]]):
        """Routed group commit: coalesce every staged batch's slices
        per owning group BEFORE writing, so a fused ingest group costs
        each group ONE ``write_many`` (one journal/fsync decision, one
        admission pass) instead of one write per caller batch."""
        pairs = [(b, v) for b, v in pairs if b is not None and b.n]
        if not pairs:
            return None
        with self._op():
            sft = self.get_schema(type_name)
            per_group: list[list] = [[] for _ in self._groups]
            routed = 0
            for batch, vis in pairs:
                owners = self._part.owners_for_batch(sft, batch)
                vis_arr = (np.asarray(vis, dtype=object)
                           if vis is not None else None)
                for gi in np.unique(owners):
                    rows = np.flatnonzero(owners == gi)
                    sub = (batch if len(rows) == batch.n
                           else batch.take(rows))
                    sv = None if vis_arr is None else list(vis_arr[rows])
                    per_group[int(gi)].append((sub, sv))
                    routed += len(rows)
            for gi, (name, group) in enumerate(zip(self._names,
                                                   self._groups)):
                if not per_group[gi]:
                    continue
                ret = group.write_many(type_name, per_group[gi])
                self._bump_lsn(name, group, ret)
            mig = self._migration
            if mig is not None and mig.forward:
                for batch, vis in pairs:
                    mig.stage_write(sft, batch, visibilities=vis)
            self._registry.counter("cluster.writes.routed", routed)
            return self.lsn_vector()

    def delete(self, type_name: str, ids):
        """Broadcast: geometry-routed rows cannot be re-owned from ids
        alone, and deleting absent ids is a no-op everywhere."""
        with self._op():
            for name, group in zip(self._names, self._groups):
                ret = group.delete(type_name, ids)
                self._bump_lsn(name, group, ret)
            mig = self._migration
            if mig is not None and mig.forward:
                mig.stage_delete(type_name, ids)
            return self.lsn_vector()

    # -- read path ---------------------------------------------------------

    def _as_query(self, q, type_name) -> Query:
        if isinstance(q, str):
            if type_name is None:
                raise ValueError("type_name required with a filter string")
            q = Query(type_name, q)
        return q

    @_gated
    def query(self, q, type_name=None, explain_out=None):
        q = self._as_query(q, type_name)

        def make_fn(name, group):
            def leg():
                res = group.query(q, **self._ryw_kwargs(name, group))
                # materialize lazy ids/batch INSIDE the leg, before
                # slower sibling legs land: a replica apply between
                # scatter and merge must not invalidate row indices
                _ = res.ids
                _ = res.batch
                return res
            return leg

        from ..audit import audit_query, delegated_scope
        t0 = time.perf_counter()
        legs, prune_info = self.prune_for(q.type_name, q.filter)
        self._account_legs("query", q.type_name, legs, prune_info)
        with delegated_scope():
            results, failures = self._scatter(make_fn, legs=legs)
        missing = self._missing(failures)
        ids_parts, batch_parts = [], []
        for name in self._names:
            res = results.get(name)
            if res is None or res.n == 0:
                continue
            ids_parts.append(np.asarray(res.ids, dtype=object))
            batch_parts.append(res.batch)
        ids = (np.concatenate(ids_parts) if ids_parts
               else np.empty(0, dtype=object))
        batch = None
        if batch_parts:
            batch = (batch_parts[0] if len(batch_parts) == 1
                     else FeatureBatch.concat_all(batch_parts))
        if q.sort_by is not None and batch is not None and batch.n:
            from ..store.common import sort_order
            order = sort_order(batch, q.sort_by, q.sort_desc)
            batch = batch.take(order)
            ids = ids[order]
        if q.max_features is not None and len(ids) > q.max_features:
            ids = ids[:q.max_features]
            if batch is not None:
                batch = batch.take(np.arange(q.max_features))
        explain = Explainer(explain_out)
        explain(lambda: f"Cluster scatter over {len(self._groups)} "
                        f"groups ({len(failures)} missing)")
        out = ClusterQueryResult(
            ids, batch, explain,
            FilterStrategy("cluster", q.filter, None), n=len(ids))
        out.lsn_vector = self.lsn_vector()
        out.topology_epoch = self._part.epoch
        if missing:
            out.complete = False
            out.missing_groups = missing["groups"]
            out.missing_z_ranges = missing["z_ranges"]
        audit_query(self.audit, "cluster", q.type_name, str(q.filter),
                    q.hints, 0.0, (time.perf_counter() - t0) * 1000,
                    len(ids), index="cluster")
        return out

    @_gated
    def query_count(self, q, type_name=None) -> int:
        q = self._as_query(q, type_name)
        from ..audit import audit_query, delegated_scope
        t0 = time.perf_counter()
        legs, prune_info = self.prune_for(q.type_name, q.filter)
        self._account_legs("query_count", q.type_name, legs, prune_info)
        with delegated_scope():
            results, failures = self._scatter(
                lambda name, group:
                lambda: group.query_count(q, **self._ryw_kwargs(name,
                                                                group)),
                legs=legs)
        missing = self._missing(failures)
        total = int(sum(results.values()))
        if q.max_features is not None:
            total = min(total, q.max_features)
        audit_query(self.audit, "cluster", q.type_name, str(q.filter),
                    q.hints, 0.0, (time.perf_counter() - t0) * 1000,
                    total, index="cluster")
        if missing:
            out = PartialCount(total)
            out.missing_groups = missing["groups"]
            out.missing_z_ranges = missing["z_ranges"]
            out.topology_epoch = self._part.epoch
            return out
        return total

    # -- distributed SQL legs ----------------------------------------------

    @_gated
    def sql_partial(self, stmt: str, type_name: str = "",
                    legs: list[str] | None = None) \
            -> tuple[dict, dict | None]:
        """Scatter one partial-aggregate SQL leg per shard group (the
        sql/distributed.py decomposition): remote groups evaluate via
        their own ``sql_partial`` endpoint, in-process groups run the
        leg directly. ``legs`` (from the SQL planner's Z-range pruning
        of the pushed WHERE) restricts the scatter to the named
        groups. Returns ``(partials_by_group, missing)`` under the
        standard partial-results contract."""
        from ..audit import audit_query, delegated_scope
        from ..sql.distributed import partial_aggregate
        t0 = time.perf_counter()
        self._account_legs("sql_partial", type_name, legs)

        def make_fn(name, group):
            def leg():
                fn = getattr(group, "sql_partial", None)
                if callable(fn):
                    return fn(stmt)
                return partial_aggregate(
                    group, stmt,
                    query_kwargs=self._ryw_kwargs(name, group))
            return leg

        with delegated_scope():
            results, failures = self._scatter(make_fn, legs=legs)
        missing = self._missing(failures)
        audit_query(self.audit, "cluster", type_name, stmt, None, 0.0,
                    (time.perf_counter() - t0) * 1000,
                    int(sum(r.get("n", 0) for r in results.values())),
                    index="sql-partial")
        return results, missing

    @_gated
    def sql_join_partial(self, spec: dict, type_name: str = "",
                         legs: list[str] | None = None) \
            -> tuple[dict, dict | None]:
        """Scatter one broadcast-join leg per shard group: each group
        joins the shipped small side against its local slice of the
        big side. ``legs`` restricts the scatter to the groups whose
        owned z range can hold local-side matches. Same contract as
        ``sql_partial``."""
        from ..audit import audit_query, delegated_scope
        from ..sql.distributed import join_partial_leg
        t0 = time.perf_counter()
        self._account_legs("sql_join_partial", type_name, legs)

        def make_fn(name, group):
            def leg():
                fn = getattr(group, "sql_join_partial", None)
                if callable(fn):
                    return fn(spec)
                return join_partial_leg(
                    group, spec,
                    query_kwargs=self._ryw_kwargs(name, group))
            return leg

        with delegated_scope():
            results, failures = self._scatter(make_fn, legs=legs)
        missing = self._missing(failures)
        audit_query(self.audit, "cluster", type_name,
                    spec.get("sql", ""), None, 0.0,
                    (time.perf_counter() - t0) * 1000,
                    int(sum(r.get("n", r.get("count", 0))
                            for r in results.values())),
                    index="sql-join-partial")
        return results, missing

    @_gated
    def count(self, type_name: str) -> int:
        results, failures = self._scatter(
            lambda name, group:
            lambda: group.count(type_name,
                                **self._ryw_kwargs(name, group)))
        missing = self._missing(failures)
        total = int(sum(results.values()))
        if missing:
            out = PartialCount(total)
            out.missing_groups = missing["groups"]
            out.missing_z_ranges = missing["z_ranges"]
            return out
        return total

    # -- mergeable aggregates ----------------------------------------------

    @_gated
    def stats_query(self, type_name: str, stat_spec: str, ecql=None):
        """Scatter the sketch, merge exactly (Stat.merge — every
        sketch in stats/sketches.py is a commutative monoid over
        disjoint row sets, the StatsScan client reduce)."""
        legs, prune_info = self.prune_for(type_name, ecql)
        self._account_legs("stats_query", type_name, legs, prune_info)
        results, failures = self._scatter(
            lambda name, group:
            lambda: group.stats_query(type_name, stat_spec, ecql,
                                      **self._ryw_kwargs(name, group)),
            legs=legs)
        missing = self._missing(failures)
        merged = None
        for name in self._names:
            s = results.get(name)
            if s is None:
                continue
            if isinstance(s, dict):
                raise NotImplementedError(
                    "cluster stats merge needs Stat-returning groups "
                    "(in-process or replicated); a RemoteDataStore "
                    "group returned a JSON summary")
            merged = s if merged is None else merged.merge(s)
        if merged is None:
            from ..stats import parse_stat
            merged = parse_stat(stat_spec)
        merged.complete = missing is None
        if missing:
            merged.missing_groups = missing["groups"]
            merged.missing_z_ranges = missing["z_ranges"]
        return merged

    @_gated
    def density(self, type_name: str, ecql, bbox, width: int, height: int,
                weight_attr: str | None = None) -> np.ndarray:
        """Scatter the heatmap; grids over disjoint partitions sum
        exactly (the DensityScan client reduce)."""
        kwargs = {} if weight_attr is None else {"weight_attr": weight_attr}
        legs, prune_info = self.prune_for(
            type_name, self._density_filter(type_name, ecql, bbox))
        self._account_legs("density", type_name, legs, prune_info)
        results, failures = self._scatter(
            lambda name, group:
            lambda: group.density(type_name, ecql, bbox, width, height,
                                  **kwargs,
                                  **self._ryw_kwargs(name, group)),
            legs=legs)
        missing = self._missing(failures)
        grid = np.zeros((height, width), dtype=np.float32)
        for name in self._names:
            if name in results:
                grid += np.asarray(results[name], dtype=np.float32)
        if missing:
            grid = grid.view(_PartialGrid)
            grid.missing_groups = missing["groups"]
            grid.missing_z_ranges = missing["z_ranges"]
        return grid

    def _density_filter(self, type_name: str, ecql, bbox):
        """The effective spatial constraint of a density scan: the
        ecql AND the grid bbox (rows outside the rendered extent
        contribute no weight, so their legs can prune)."""
        try:
            from ..filters import ast as _ast
            from ..filters import parse_ecql
            sft = self.get_schema(type_name)
            if sft.geom_field is None:
                return ecql
            box = _ast.BBox(sft.geom_field, float(bbox[0]), float(bbox[1]),
                            float(bbox[2]), float(bbox[3]))
            f = parse_ecql(ecql) if isinstance(ecql, str) else ecql
            if f is None or isinstance(f, _ast.Include):
                return box
            return _ast.And([f, box])
        except Exception:  # noqa: BLE001 — pruning input is advisory
            return ecql

    @_gated
    def bin_query(self, type_name: str, ecql, track: str | None = None,
                  label: str | None = None, sort: bool = False) -> bytes:
        """Scatter BIN encoding; sorted chunks k-way merge via
        merge_sorted_bin_chunks (the BinSorter client reduce)."""
        legs, prune_info = self.prune_for(type_name, ecql)
        self._account_legs("bin_query", type_name, legs, prune_info)
        results, failures = self._scatter(
            lambda name, group:
            lambda: group.bin_query(type_name, ecql, track=track,
                                    label=label, sort=sort,
                                    **self._ryw_kwargs(name, group)),
            legs=legs)
        missing = self._missing(failures)
        chunks = [results[n] for n in self._names
                  if results.get(n)]
        if sort:
            from ..scan.aggregations import merge_sorted_bin_chunks
            data = merge_sorted_bin_chunks(chunks,
                                           labeled=label is not None)
        else:
            data = b"".join(chunks)
        if missing:
            data = _PartialBytes(data)
            data.missing_groups = missing["groups"]
            data.missing_z_ranges = missing["z_ranges"]
        return data

    @_gated
    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        """Scatter arrow encoding (each leg sorts shard-locally), then
        reduce the per-group IPC payloads as *streams*: the k-way merge
        of arrow/delta.merge_sorted_streams holds one in-flight record
        batch per leg instead of decoding and concatenating the union
        before sorting."""
        results, failures = self._scatter(
            lambda name, group:
            lambda: group.arrow_ipc(type_name, ecql, sort_by=sort_by,
                                    **self._ryw_kwargs(name, group)))
        missing = self._missing(failures)
        sft = self.get_schema(type_name)
        import io as _io
        from ..arrow.delta import iter_ipc, merge_sorted_streams
        from ..arrow.io import FeatureArrowFileWriter, write_ipc
        sources = [iter_ipc(results[name], sft)[1]
                   for name in self._names if results.get(name)]
        sink = _io.BytesIO()
        wrote = False
        with FeatureArrowFileWriter(sink, sft) as w:
            for b in merge_sorted_streams(sources, sort_by):
                w.write(b)
                wrote = True
        data = (sink.getvalue() if wrote
                else write_ipc(sft, _empty_batch(sft)))
        if missing:
            data = _PartialBytes(data)
            data.missing_groups = missing["groups"]
            data.missing_z_ranges = missing["z_ranges"]
        return data

    # -- streamed scatter-gather -------------------------------------------

    def query_stream(self, q, type_name=None, batch_rows=None):
        """Streamed scatter-gather: one producer thread per group feeds
        a bounded queue (depth ``geomesa.stream.max.inflight.batches``
        — a slow consumer backpressures the legs instead of buffering
        them), and the consumer runs the k-way sort-merge over the
        queues, so cluster results stream in bounded memory end to end.

        Streaming legs are never hedged — a duplicate leg would
        double-deliver rows. The per-leg deadline bounds the wait for a
        group's *next* batch: a stalled group fails the stream typed
        (``ShardUnavailableError``) mid-iteration, or under
        ``geomesa.cluster.allow.partial`` drops out with its z-ranges
        flagged on the returned handle (final once exhausted)."""
        import queue as _queue
        from ..arrow.delta import (STREAM_MAX_INFLIGHT,
                                   merge_sorted_streams, slice_batches)
        q = self._as_query(q, type_name)
        # a stream holds the shared op gate for its whole lifetime
        # (releases in the merge's finally): the reshard flip cannot
        # swap topology under a half-consumed merge
        self._gate.acquire_shared()
        gate_released = threading.Event()

        def release_gate():
            if not gate_released.is_set():
                gate_released.set()
                self._gate.release_shared()

        mig = self._migration
        if mig is not None and mig.blocking:
            release_gate()
            raise ReshardError(
                f"topology flip incomplete (migration "
                f"{mig.src_name}->{mig.dst_name}, phase {mig.phase}); "
                "resume or abort the reshard")
        deadline = self._leg_deadline_s()
        depth = max(STREAM_MAX_INFLIGHT.as_int() or 4, 1)
        self._registry.counter("cluster.scatter.calls")
        stop = threading.Event()
        failures: dict = {}
        _BATCH, _DONE, _ERR = "batch", "done", "err"

        def put(qq, item) -> bool:
            # bounded put that gives up when the consumer walked away
            while not stop.is_set():
                try:
                    qq.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def producer(name, group, qq):
            breaker = self._breakers.get(name)
            try:
                breaker.acquire()
            except CircuitOpenError as e:
                self._registry.counter("cluster.leg.fastfails")
                put(qq, (_ERR, e))
                return
            t0 = time.perf_counter()
            try:
                fn = getattr(group, "query_stream", None)
                it = fn(q, batch_rows=batch_rows,
                        **self._ryw_kwargs(name, group)) \
                    if callable(fn) else slice_batches(
                        group.query(
                            q, **self._ryw_kwargs(name, group)).batch,
                        batch_rows)
                for b in it:
                    if not put(qq, (_BATCH, b)):
                        return
            except Exception as e:  # noqa: BLE001 — leg boundary
                breaker.failure()
                self._registry.counter("cluster.leg.failures")
                put(qq, (_ERR, e))
            else:
                breaker.success()
                self._breakers.observe(name, time.perf_counter() - t0)
                put(qq, (_DONE, None))

        queues = []
        for name, group in zip(self._names, self._groups):
            qq = _queue.Queue(maxsize=depth)
            threading.Thread(target=self._on_device(
                                 name, lambda n=name, g=group, qq=qq:
                                 producer(n, g, qq)),
                             daemon=True,
                             name=f"cluster-stream-{name}").start()
            queues.append((name, qq))

        def leg_source(name, qq):
            while True:
                try:
                    kind, val = qq.get(timeout=deadline + 5.0)
                except _queue.Empty:
                    self._registry.counter("cluster.leg.failures")
                    self._registry.counter("cluster.leg.timeouts")
                    failures[name] = TimeoutError(
                        f"shard leg {name!r} produced no batch inside "
                        f"its {deadline:g}s deadline")
                    self._missing({name: failures[name]})
                    return
                if kind == _DONE:
                    return
                if kind == _ERR:
                    failures[name] = val
                    self._missing({name: val})  # raises typed unless
                    return                      # partials are allowed
                yield val

        handle = _ClusterStream()
        handle._on_close = release_gate

        def merged():
            try:
                remaining = q.max_features
                for b in merge_sorted_streams(
                        [leg_source(name, qq) for name, qq in queues],
                        q.sort_by, reverse=q.sort_desc,
                        batch_rows=batch_rows):
                    if remaining is not None:
                        if remaining <= 0:
                            return
                        if b.n > remaining:
                            b = b.take(np.arange(remaining))
                        remaining -= b.n
                    yield b
            finally:
                # runs on every exit path — exhaustion, max_features
                # truncation, consumer close — so a truncated stream
                # still reports legs that failed before the cut. Only
                # the partial-allowed branch of _missing is reachable
                # here (strict mode raised typed during iteration);
                # gating on it keeps the finally from raising anew.
                stop.set()
                release_gate()
                if failures and self._allow_partial():
                    missing = self._missing(failures)
                    handle.complete = False
                    handle.missing_groups = missing["groups"]
                    handle.missing_z_ranges = missing["z_ranges"]

        handle._gen = merged()
        return handle

    # -- admin -------------------------------------------------------------

    def cluster_status(self) -> dict:
        vec = self.lsn_vector()
        groups = []
        for i, (name, g) in enumerate(zip(self._names, self._groups)):
            ent = {"name": name, "type": type(g).__name__,
                   "acked_lsn": vec.get(name, 0),
                   "breaker": self._breakers.get(name).state}
            ent.update({k: v for k, v in self._part.z_range(i).items()
                        if k != "group"})
            rs = getattr(g, "replication_status", None)
            if callable(rs):
                try:
                    ent["replication"] = rs()
                except Exception as e:  # noqa: BLE001 — status, not control
                    ent["replication_error"] = f"{type(e).__name__}: {e}"
            groups.append(ent)
        self._registry.gauge("cluster.groups", len(self._groups))
        return {"role": "cluster",
                "n_groups": len(self._groups),
                "prefix_bits": PREFIX_BITS,
                "topology_epoch": self._part.epoch,
                "allow_partial": self._allow_partial(),
                "prune": bool(CLUSTER_PRUNE.as_bool()),
                "leg_deadline_s": self._leg_deadline_s(),
                "hedge_ms": self._hedge_s() * 1e3,
                "lsn_vector": vec,
                "groups": groups,
                "last_plan": self.last_plan(),
                "leg_latency": self._breakers.latencies()}

    def cache_status(self) -> dict:
        """Per-leg materialized-cache view: each shard group's cache is
        keyed by that group's own LSN, so a write routed to one shard
        only invalidates that leg's tiles."""
        groups: dict[str, dict] = {}
        for name, g in zip(self._names, self._groups):
            cs = getattr(g, "cache_status", None)
            if not callable(cs):
                continue
            try:
                groups[name] = cs()
            except Exception as e:  # noqa: BLE001 — status, not control
                groups[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"role": "cluster", "lsn_vector": self.lsn_vector(),
                "groups": groups}

    def invalidate_cache(self, type_name: str | None = None) -> int:
        n = 0
        for g in self._groups:
            inv = getattr(g, "invalidate_cache", None)
            if not callable(inv):
                continue
            try:
                n += int(inv(type_name))
            except Exception:  # noqa: BLE001 — best-effort fan-out
                pass
        return n

    def promote_group(self, name: str | None = None) -> dict:
        """Manually promote inside one shard group (the group must be
        replicated, or a remote fronting a replicated store)."""
        if name is None:
            if len(self._groups) != 1:
                raise ValueError(
                    "group name required; have: " + ", ".join(self._names))
            name = self._names[0]
        if name not in self._names:
            raise ValueError(f"no such group {name!r}; have: "
                             + ", ".join(self._names))
        group = self._groups[self._names.index(name)]
        fn = getattr(group, "promote", None)
        if not callable(fn):
            raise ValueError(f"group {name!r} ({type(group).__name__}) "
                             "does not support promotion")
        out = dict(fn() or {})
        out["group"] = name
        self._registry.counter("cluster.promotions")
        return out

    def close(self):
        for group in self._groups:
            close = getattr(group, "close", None)
            if callable(close):
                close()


def _empty_batch(sft) -> FeatureBatch:
    return FeatureBatch.from_dict(
        sft, np.empty(0, dtype=object),
        {a.name: ((np.empty(0), np.empty(0)) if a.type.name == "Point"
                  else []) for a in sft.attributes})
