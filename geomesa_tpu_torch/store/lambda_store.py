"""Lambda-architecture store: transient live tier + long-term persistence.

The analog of geomesa-lambda (lambda/data/LambdaDataStore.scala:38):
writes land in the transient (live) tier; a persistence step moves
features older than an age threshold into the persistent store
(DataStorePersistence analog); queries union both tiers with the
transient winning on id collisions (LambdaQueryRunner). The
LAMBDA_QUERY_PERSISTENT / LAMBDA_QUERY_TRANSIENT hints restrict to one
tier (QueryHints.scala:60-61).

The transient tier is a ``LiveDataStore`` on ``device`` (None means
``"cuda"``); the persistent tier is ``InMemoryDataStore(device=device)``
unless the caller passes one, such as a ``FileSystemDataStore``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..features.sft import SimpleFeatureType, parse_spec
from ..index.api import Query
from .api import DataStore
from .live import LiveDataStore, MessageBus
from .memory import InMemoryDataStore, QueryResult

__all__ = ["LambdaDataStore", "LAMBDA_QUERY_PERSISTENT",
           "LAMBDA_QUERY_TRANSIENT"]

LAMBDA_QUERY_PERSISTENT = "LAMBDA_QUERY_PERSISTENT"
LAMBDA_QUERY_TRANSIENT = "LAMBDA_QUERY_TRANSIENT"
_TIER_HINTS = (LAMBDA_QUERY_PERSISTENT, LAMBDA_QUERY_TRANSIENT)


def _for_tier(q: Query, **changes) -> Query:
    """The query a tier runs: without the tier hints, which only this
    store reads (the port's stores refuse hints they do not know)."""
    return dataclasses.replace(
        q, hints={k: v for k, v in q.hints.items() if k not in _TIER_HINTS},
        **changes)


class LambdaDataStore(DataStore):
    def __init__(self, persistent=None, bus: MessageBus | None = None,
                 persist_after_millis: int = 3_600_000,
                 durable_dir: str | None = None,
                 wal_fsync: str | None = None, device=None):
        # durability guards the volatile half: crash-recovered transient
        # rows reopen stamped "now", so the normal persist() cadence
        # re-ages them toward the persistent tier
        self.transient = LiveDataStore(bus, durable_dir=durable_dir,
                                       wal_fsync=wal_fsync, device=device)
        self.device = self.transient.device
        self.persistent = (persistent if persistent is not None
                           else InMemoryDataStore(device=self.device))
        self.persist_after = persist_after_millis
        # create_schema registers types in BOTH tiers; recovery only
        # repopulated the transient one — mirror the schemas across
        for tn in self.transient.get_type_names():
            if tn not in self.persistent.get_type_names():
                self.persistent.create_schema(self.transient.get_schema(tn))

    @property
    def journal(self):
        """The transient tier's WAL journal, or None when not durable."""
        return self.transient.journal

    def checkpoint(self, keep: int = 2) -> dict:
        return self.transient.checkpoint(keep=keep)

    def close(self):
        self.transient.close()
        close = getattr(self.persistent, "close", None)
        if close is not None:
            close()

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        self.transient.create_schema(sft)
        if sft.type_name not in self.persistent.get_type_names():
            self.persistent.create_schema(sft)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        try:
            return self.transient.get_schema(type_name)
        except KeyError:
            # types living only in a user-supplied persistent tier are
            # still part of this store's surface
            return self.persistent.get_schema(type_name)

    def get_type_names(self) -> list[str]:
        return sorted(set(self.transient.get_type_names())
                      | set(self.persistent.get_type_names()))

    def remove_schema(self, type_name: str):
        if self._transient_has(type_name):
            self.transient.remove_schema(type_name)
        if type_name in self.persistent.get_type_names():
            self.persistent.remove_schema(type_name)

    def _transient_has(self, type_name: str) -> bool:
        return type_name in self.transient.get_type_names()

    def write(self, type_name: str, batch, timestamp_ms=None,
              visibilities=None):
        if not self._transient_has(type_name):
            if type_name in self.persistent.get_type_names():
                # persistent-only type: register it in the transient
                # tier so the write lands in the cache (not a silent
                # publish to a topic nobody consumes)
                self.transient.create_schema(
                    self.persistent.get_schema(type_name))
            else:
                raise KeyError(f"no such schema: {type_name}")
        self.transient.write(type_name, batch, timestamp_ms,
                             visibilities=visibilities)

    def delete(self, type_name: str, ids):
        self.transient.delete(type_name, ids)
        self.persistent.delete(type_name, ids)

    def persist(self, type_name: str, now_ms: int | None = None) -> int:
        """Move features older than the age threshold into the
        persistent tier (DataStorePersistence run). Returns moved count."""
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        ids, batch = self.transient.features_older_than(
            type_name, now - self.persist_after)
        if batch is None or batch.n == 0:
            return 0
        # visibility labels travel with the features to the durable
        # tier (looked up by id BEFORE the transient delete)
        st = self.transient._mem._state(type_name)
        vis = None
        if st.has_vis and st.batch is not None:
            pos = {str(i): k for k, i
                   in enumerate(st.batch.ids.astype(str))}
            vis = [st.vis[pos[str(i)]] if str(i) in pos else None
                   for i in ids]
        # upsert into the persistent store
        self.persistent.delete(type_name, ids)
        self.persistent.write(type_name, batch, visibilities=vis)
        self.transient.delete(type_name, ids)
        return batch.n

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        if isinstance(q, str):
            q = Query(type_name, q)
        if q.hints.get(LAMBDA_QUERY_TRANSIENT):
            return self.transient.query(_for_tier(q), explain_out=explain_out)
        if q.hints.get(LAMBDA_QUERY_PERSISTENT) \
                or not self._transient_has(q.type_name):
            # persistent-only types answer from that tier alone
            return self.persistent.query(_for_tier(q),
                                         explain_out=explain_out)
        # run the tiers unsorted/unlimited; sort + limit re-apply on the
        # union (per-tier limits would be wrong)
        tier_q = _for_tier(q, max_features=None, sort_by=None)
        rt = self.transient.query(tier_q, explain_out=explain_out)
        rp = self.persistent.query(tier_q, explain_out=explain_out)
        # a persistent row is stale if ANY transient version of the id
        # exists (not just one matching this filter): transient holds
        # the current version, which may no longer match
        t_state = self.transient._mem._state(q.type_name)
        all_t_ids = (t_state.batch.ids.astype(str)
                     if t_state.batch is not None else np.empty(0, "U1"))
        keep = ~np.isin(rp.ids.astype(str), all_t_ids)
        ids = np.concatenate([rt.ids, rp.ids[keep]])
        batch = rt.batch
        if rp.batch is not None and keep.any():
            sub = rp.batch.take(np.flatnonzero(keep))
            batch = sub if batch is None else batch.concat(sub)
        rt.explain(f"Lambda union: {rt.n} transient + "
                   f"{int(keep.sum())} persistent")
        if batch is not None and q.sort_by is not None:
            from .common import sort_order
            order = sort_order(batch, q.sort_by, q.sort_desc)
            ids = ids[order]
            batch = batch.take(order)
        if q.max_features is not None:
            ids = ids[:q.max_features]
            if batch is not None:
                batch = batch.take(np.arange(min(q.max_features, batch.n)))
        # the union's rows come from two tables: its row positions are
        # its own order
        return QueryResult(np.arange(len(ids)), ids, batch, rt.explain,
                           rt.plan)

    def query_batched(self, queries: list[Query],
                      explain_out=None) -> list[QueryResult]:
        """Coalesced execution across the lambda tiers. Queries that a
        single tier can answer (persistent-only types, tier hints) fuse
        within that tier's batched scan; queries needing the
        transient+persistent union run the scalar merge path — its
        dedup depends on BOTH tiers' results, so fusing it would not
        change the number of dispatches it needs."""
        queries = list(queries)
        if len(queries) <= 1:
            return [self.query(q, explain_out=explain_out)
                    for q in queries]
        results: list[QueryResult | None] = [None] * len(queries)
        persistent_idx: list[int] = []
        transient_idx: list[int] = []
        union_idx: list[int] = []
        for i, q in enumerate(queries):
            if q.hints.get(LAMBDA_QUERY_TRANSIENT):
                transient_idx.append(i)
            elif q.hints.get(LAMBDA_QUERY_PERSISTENT) \
                    or not self._transient_has(q.type_name):
                persistent_idx.append(i)
            else:
                union_idx.append(i)

        def run_tier(tier, members):
            if not members:
                return
            if len(members) >= 2 and hasattr(tier, "query_batched"):
                sub = tier.query_batched([_for_tier(queries[i])
                                          for i in members],
                                         explain_out=explain_out)
                for i, r in zip(members, sub):
                    results[i] = r
            else:
                for i in members:
                    results[i] = tier.query(_for_tier(queries[i]),
                                            explain_out=explain_out)

        run_tier(self.persistent, persistent_idx)
        run_tier(self.transient, transient_idx)
        for i in union_idx:
            results[i] = self.query(queries[i], explain_out=explain_out)
        return results  # type: ignore[return-value]

    def count(self, type_name: str) -> int:
        q = Query(type_name)
        return self.query(q).n

    def bin_query(self, type_name: str, ecql="INCLUDE",
                  track: str | None = None, label: str | None = None,
                  sort: bool = False) -> bytes:
        """BIN aggregation over the merged tier view (transient rows
        win over persistent, same as ``query``)."""
        from ..scan.aggregations import encode_bin_batch
        res = self.query(Query(type_name, ecql))
        if res.batch is None or res.batch.n == 0:
            return b""
        return encode_bin_batch(self.get_schema(type_name), res.ids,
                                res.batch, track=track, label=label,
                                sort=sort)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        from ..arrow.scan import ArrowScan
        return ArrowScan(self).execute(type_name, ecql, sort_by=sort_by)
