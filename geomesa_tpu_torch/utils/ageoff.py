"""Age-off: retention by feature age.

Analog of the Accumulo age-off iterators (accumulo/iterators/
AgeOffIterator / DtgAgeOffIterator — drop rows older than an expiry at
scan/compaction time). The port's stores hold explicit state, so
age-off is a maintenance op over any store exposing query/delete (the
in-memory store, the file store): compute the expired id set by dtg and
delete it."""

from __future__ import annotations

import time

from ..index.api import Query

__all__ = ["age_off", "expired_ids"]


def expired_ids(store, type_name: str, expiry_ms: int,
                now_ms: int | None = None,
                dtg_field: str | None = None) -> list[str]:
    sft = store.get_schema(type_name)
    dtg = dtg_field or sft.dtg_field
    if dtg is None:
        raise ValueError(f"type {type_name!r} has no date attribute")
    cutoff = (int(time.time() * 1000) if now_ms is None else now_ms) \
        - expiry_ms
    res = store.query(Query(type_name, f"{dtg} < {cutoff}"))
    if res.batch is None:
        return []
    return [str(i) for i in res.batch.ids]


def age_off(store, type_name: str, expiry_ms: int,
            now_ms: int | None = None,
            dtg_field: str | None = None) -> int:
    """Delete features older than expiry; returns how many."""
    ids = expired_ids(store, type_name, expiry_ms, now_ms, dtg_field)
    if ids:
        store.delete(type_name, ids)
    return len(ids)
