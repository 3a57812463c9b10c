"""Ingest firehose: group-commit batched writes + admission control.

``IngestPipeline`` stages converter output (or any caller's batches)
through a bounded in-flight-rows queue into coalesced ``write_many``
store calls: one WAL append and fsync decision and one state append
(the in-place copy into the store's device columns) per fused group.
``IngestGovernor`` is the admission-control half: a token bucket over
in-flight rows (a blocking put for embedded callers, a refusal a front
end maps to 429 + Retry-After) plus a shed signal derived from the read
batchers' queue depth, so bulk ingest cannot starve query dispatches.
"""

from .pipeline import (INGEST_GROUP_ROWS, INGEST_LATENCY_BUDGET_MS,
                       INGEST_MAX_INFLIGHT_ROWS, INGEST_SHED_QUEUE_DEPTH,
                       IngestAck, IngestGovernor, IngestPipeline)

__all__ = ["IngestPipeline", "IngestGovernor", "IngestAck",
           "INGEST_MAX_INFLIGHT_ROWS", "INGEST_GROUP_ROWS",
           "INGEST_LATENCY_BUDGET_MS", "INGEST_SHED_QUEUE_DEPTH"]
