"""The live streaming tier's message type.

The reference's KafkaDataStore (kafka/data/KafkaDataStore.scala:44)
streams feature mutations as GeoMessages (Create/Delete/Clear,
kafka/utils/GeoMessage.scala:14). The port has only ``GeoMessage`` so
far: it is the write-ahead log's record body (``wal/log.py``), in the
wire format of ``filebus.py``. The message bus and ``LiveDataStore``
come with the streaming tiers (ROADMAP.md section 6, queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

from ..features.batch import FeatureBatch

__all__ = ["GeoMessage"]


@dataclasses.dataclass
class GeoMessage:
    """A feature mutation (GeoMessage.scala:14)."""
    kind: str                       # "create" | "delete" | "clear"
    type_name: str
    batch: FeatureBatch | None = None   # for create
    ids: tuple = ()                 # for delete
    timestamp_ms: int = 0
    visibilities: tuple | None = None   # per-feature labels (create)
