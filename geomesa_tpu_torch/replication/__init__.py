"""Replication: WAL-shipped read replicas with bounded staleness.

The reference scales reads by delegating replication to its backing
key-value stores (Accumulo/HBase/Bigtable tablet replication) and by
the Lambda architecture's stream/persistent split; this rebuild owns
its storage tier, so replication is built here from the two subsystems
that already exist — the durability WAL (monotonic LSNs, checkpoint
manifests, idempotent redo) and the resilience layer (reconnect with
backoff, breakers, health probes):

- ``shipper.py``  — primary side: a TCP server that streams WAL
  records to replicas from a negotiated LSN and serves checkpoint
  files for bootstrap;
- ``sync.py``     — replica-side client: LSN negotiation, checkpoint
  bootstrap, streaming catch-up frames;
- ``replica.py``  — a read-only ``DataStore`` continuously applying
  the shipped records through the idempotent redo path;
- ``router.py``   — ``ReplicatedDataStore``: writes to the primary
  (acknowledged once replicated), reads fanned across replicas under
  per-query staleness bounds, promote-on-failure.

Emits ``replication.*`` metrics; admin surface on ``/rest/replication``.
"""

from .replica import ReadOnlyReplicaError, Replica
from .router import ReplicatedDataStore, ReplicationAckTimeout
from .shipper import WalShipper
from .sync import ReplClient, bootstrap_from_checkpoint

__all__ = ["WalShipper", "Replica", "ReadOnlyReplicaError",
           "ReplicatedDataStore", "ReplicationAckTimeout",
           "ReplClient", "bootstrap_from_checkpoint"]
