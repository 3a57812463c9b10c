"""Durable sharded tier: fs-store partitions served by the device mesh.

The reference's scale story is a durable, partitioned table (tablets on
Accumulo/HBase, parquet partitions on the fs store) scanned by many
servers. The port pairs the two tiers it already has:

- **durability**: parquet partitions + metadata catalog + index sidecars
  from the fs store (store/fs.py; reference
  geomesa-fs/.../FileSystemDataStore.scala:29, partition pruning
  FsQueryPlanning.scala);
- **serving**: the mesh-distributed store (store/mesh_store.py), whose
  device tier shards the hot columns over a mesh of torch devices.

A ``FsBackedDistributedDataStore(root, mesh)`` opens the catalog, loads
every partition in deterministic partition order onto the mesh
(recovery = construct again on the same root), and writes through:
every write lands in parquet first, then the serving tier. The z-key
sort orders persist as sidecars under ``<type>/index_mesh/`` so a reopen
adopts them instead of re-sorting 100M rows. Both packages write the
same layout, so a root written by either opens in the other.

**Placement note (deviation from the reference, deliberate).** Tablet
servers own whole tablets; here rows shard EVENLY over the mesh
regardless of partition boundaries, as the reference's JAX port does:
equal shards keep the shards' work balanced, and the shard-local
kernels never exploit partition locality. The partition -> shard
relationship stays available as metadata (``partition_shards``):
partitions load in sorted order, so each maps to a contiguous row range
and therefore to a computable shard range (BaseFeatureIndex.getSplits:
63-72 is the reference's equivalent bookkeeping).
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType, parse_spec
from .fs import FileSystemDataStore, _safe_partition
from .mesh_store import DistributedDataStore

__all__ = ["FsBackedDistributedDataStore"]


class FsBackedDistributedDataStore(DistributedDataStore):
    """Mesh-served datastore whose source of truth is an fs-store root.

    Construction replays the catalog (write -> reopen -> query yields
    identical ids); writes go to parquet first, then the mesh tier. The
    fs store loads onto the mesh's first device."""

    def __init__(self, root: str, mesh=None, audit=None):
        super().__init__(mesh=mesh, audit=audit)
        self.root = root
        self.fs = FileSystemDataStore(root, device=self.device)
        # type -> [(partition, lo, hi)] row ranges in load order
        self._partition_rows: dict[str, list[tuple[str, int, int]]] = {}
        for t in self.fs.get_type_names():
            self._adopt(t)

    # -- recovery ----------------------------------------------------------

    def _adopt(self, type_name: str):
        """Replay one type from the durable tier onto the mesh:
        partitions load in sorted order (deterministic row placement),
        then the persisted sort orders install so the reopen skips the
        O(n log n) index build."""
        sft = self.fs.get_schema(type_name)
        super().create_schema(sft)
        ranges: list[tuple[str, int, int]] = []
        row = 0
        batches, vises = [], []
        for part in self.fs.partitions(type_name):
            batch, vis = self.fs.read_partition(type_name, part)
            if batch is None or batch.n == 0:
                continue
            ranges.append((part, row, row + batch.n))
            row += batch.n
            batches.append(batch)
            vises.append(vis)  # None when the partition has no labels
        if batches:
            vis_all = None
            if any(v is not None for v in vises):
                vis_all = np.concatenate(
                    [v if v is not None
                     else np.full(b.n, None, dtype=object)
                     for b, v in zip(batches, vises)])
            super().write(type_name, FeatureBatch.concat_all(batches),
                          visibilities=vis_all)
        self._partition_rows[type_name] = ranges
        self._install_index_sidecar(type_name)

    # -- durable write-through ---------------------------------------------

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None, scheme=None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        self.fs.create_schema(sft, scheme=scheme)
        super().create_schema(sft)
        self._partition_rows[sft.type_name] = []

    def write(self, type_name: str, batch: FeatureBatch,
              visibilities=None):
        raw = self.fs.write(type_name, batch, visibilities=visibilities)
        st = self._state(type_name)
        # on-disk (quoted) names: partition metadata keys must match
        # partitions() so live and reopened stores agree
        names = np.asarray([_safe_partition(p) for p in raw], dtype=str)
        # serve rows grouped by sorted partition: the CANONICAL layout a
        # reopen reproduces (partition dirs load in sorted order), so
        # persisted sort orders stay valid across restarts for the
        # bulk-load-then-reopen flow
        order = np.argsort(names, kind="stable")
        batch = batch.take(order)
        vis = (None if visibilities is None
               else np.asarray(visibilities, dtype=object)[order])
        names = names[order]
        lo = st.n  # includes pending appends
        for part in np.unique(names):
            sel = np.flatnonzero(names == part)
            self._partition_rows.setdefault(type_name, []).append(
                (str(part), lo, lo + len(sel)))
            lo += len(sel)
        super().write(type_name, batch, visibilities=vis)

    def delete(self, type_name: str, ids):
        self.fs.delete(type_name, ids)
        super().delete(type_name, ids)
        # row ranges shift after a delete; recompute lazily on demand
        self._partition_rows[type_name] = []

    def remove_schema(self, type_name: str):
        self.fs.remove_schema(type_name)
        super().remove_schema(type_name)
        self._partition_rows.pop(type_name, None)

    # -- partition / shard metadata ----------------------------------------

    def partitions(self, type_name: str) -> list[str]:
        return self.fs.partitions(type_name)

    def partition_shards(self, type_name: str) -> dict[str, list[int]]:
        """partition -> mesh shard indices holding (part of) its rows.
        Rows shard evenly over the mesh in load order, so a partition's
        contiguous row range maps to a shard range (see module note).
        Recomputed from the scheme when the tracked ranges went stale
        (deletes shift row positions)."""
        st = self._state(type_name)
        ranges = self._partition_rows.get(type_name)
        # ranges are stale whenever they don't cover every serving row,
        # not just when empty: a write after a delete appends ranges for
        # the NEW rows only, leaving the surviving rows untracked
        covered = sum(hi - lo for _, lo, hi in ranges or [])
        if st.n and covered != st.n:
            ranges = self._recompute_partition_rows(type_name)
        per = self.mesh.per(max(st.n, 1))
        out: dict[str, list[int]] = {}
        for part, lo, hi in ranges or []:
            if hi <= lo:
                continue
            d0, d1 = lo // per, (hi - 1) // per
            devs = list(range(int(d0), int(d1) + 1))
            out.setdefault(part, [])
            out[part] = sorted(set(out[part]) | set(devs))
        return out

    def _recompute_partition_rows(self, type_name: str):
        """Re-derive partition row ranges from the scheme over the
        CURRENT serving rows (runs of equal names in row order)."""
        st = self._state(type_name)
        if st.batch is None or st.n == 0:
            return []
        raw = self.fs._state(type_name).scheme.partition_for_rows(
            self.fs.get_schema(type_name), st.batch)
        names = np.asarray([_safe_partition(p) for p in raw], dtype=str)
        edges = np.flatnonzero(
            np.concatenate([[True], names[1:] != names[:-1]]))
        bounds = np.append(edges, len(names))
        ranges = [(str(names[int(lo)]), int(lo), int(hi))
                  for lo, hi in zip(bounds[:-1], bounds[1:])]
        self._partition_rows[type_name] = ranges
        return ranges

    # -- index sidecars ----------------------------------------------------

    def _index_dir(self, type_name: str) -> str:
        return os.path.join(self.root, type_name, "index_mesh")

    def _ids_digest(self, type_name: str) -> str:
        """Layout fingerprint over the FULL id column: sort orders are
        permutations over ROW POSITIONS, so adopting them onto a
        differently-ordered table would silently drop rows; the digest
        must match before a sidecar installs. A strided sample is NOT
        enough: two layouts agreeing on count and every sampled position
        but differing between samples would adopt each other's sidecars
        and serve wrong rows. Hashing is chunked so a 100M-id column
        never builds one giant joined string."""
        st = self._state(type_name)
        ids = (st.batch.ids if st.batch is not None
               else np.empty(0, dtype=object))
        h = hashlib.sha256(str(len(ids)).encode())
        for lo in range(0, len(ids), 1_000_000):
            part = ids[lo:lo + 1_000_000]
            h.update("\0".join(map(str, part)).encode())
            h.update(b"\0")
        return h.hexdigest()

    def persist_index(self, type_name: str) -> bool:
        """Write the serving tier's built z-key sort orders next to the
        data (the fs store's sidecar pattern, kept per type here). A
        reopen adopts them through warm_index when the reopened layout
        matches (ids digest)."""
        state = self.index_state(type_name)
        if not state:
            return False
        state = dict(state)
        state["ids_digest"] = np.array([self._ids_digest(type_name)])
        d = self._index_dir(type_name)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "orders.tmp.npz")  # np.savez needs .npz
        np.savez(tmp, **state)
        os.replace(tmp, os.path.join(d, "orders.npz"))
        return True

    def _install_index_sidecar(self, type_name: str):
        path = os.path.join(self._index_dir(type_name), "orders.npz")
        if not os.path.isfile(path):
            return
        try:
            data = np.load(path, mmap_mode="r")
            state = {k: data[k] for k in data.files}
            digest = str(np.asarray(state.pop("ids_digest", [""]))[0])
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            return  # unreadable sidecar: the lazy rebuild serves instead
        if digest != self._ids_digest(type_name):
            return  # a different row layout: lazy rebuild instead
        self.warm_index(type_name, state)
