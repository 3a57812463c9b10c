"""Filesystem datastore: Parquet persistence with partition pruning.

The analog of geomesa-fs (FileSystemDataStore.scala:29 +
ParquetFileSystemStorage.scala:63): features persist as Parquet files
under partition directories; a JSON metadata file records the schema,
the partition scheme and the package version; query planning prunes
partitions from the filter, reads the surviving files with the filter
pushed into the Parquet scan, loads the rows into an in-memory store on
the card and runs the normal device path there (a per-load cache of 8
stores keeps repeated queries resident).

Layout (the JAX package's, so a root written by either package opens in
the other):
    root/<type_name>/metadata.json
    root/<type_name>/data/<partition...>/<uuid>.parquet
    root/<type_name>/index/<digest>/<array>.npy + manifest.json

A load's rows come in the order of the sorted files, each file's row
groups and record batches in order, one store write per record batch:
the order the JAX store loads them in. The index sidecars persist the
z-key sort orders of a load as row positions, so both packages must
load the same files in that one order for a sidecar written by either
to serve the other.

Departure from the JAX store: a load reads the visibility column when
any of its files has one (the JAX store reads it only when the first
file in its sorted order has it, and otherwise serves labelled rows to
every reader; ROADMAP.md section 3).
"""

from __future__ import annotations

import json
import os
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType, parse_spec
from ..filters import ast
from ..index.api import Query
from ..utils.device import resolve_device
from .api import DataStore
from .memory import InMemoryDataStore, QueryResult
from .partitions import (DateTimeScheme, PartitionScheme, Z2Scheme,
                         scheme_from_config)

__all__ = ["FileSystemDataStore"]

# reserved parquet column carrying per-feature visibility labels
_VIS_COL = "__vis__"
# loaded stores a type keeps (LRU over (files, pushdown, columns))
_LOAD_CACHE = 8


def _each_file(fn, items):
    """fn over items on a few threads (Parquet's encode and decode leave
    the GIL); each item is a file of its own. Raises the first error."""
    items = list(items)
    if len(items) <= 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1,
                                            len(items))) as pool:
        return list(pool.map(fn, items))


def _safe_partition(name) -> str:
    """Sanitize a scheme-produced partition name into a relative path:
    attribute-derived names must not traverse outside the data dir."""
    from urllib.parse import quote
    segs = []
    for seg in str(name).split("/"):
        q = quote(seg, safe="")
        if q in ("", ".", ".."):
            q = "%" + q
        segs.append(q)
    return "/".join(segs)


def _pushdown_expr(f: ast.Filter, sft: SimpleFeatureType):
    """Filter AST -> a CONSERVATIVE pyarrow dataset expression (matches
    a superset of the filter), or None when nothing is pushable.

    The analog of geomesa-fs's FilterConverter (fs/parquet
    FilterConverter: CQL -> parquet predicate pushdown): row groups
    whose column statistics cannot match are never read, and
    non-matching rows are dropped at scan time. Exactness is unaffected
    — the in-memory engine re-evaluates the full filter over whatever
    loads. AND may drop unpushable conjuncts; OR is pushed only when
    every branch is pushable. ``str()`` of the expression equals the JAX
    package's for the same filter (it keys the load cache and the
    sidecar digest).
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    geom = sft.geom_field
    point_geom = geom is not None and sft.is_points

    def lit(prop, v):
        type_name = next((at.type.name for at in sft.attributes
                          if at.name == prop), None)
        if type_name == "Date":
            from ..filters.helper import to_millis
            return pa.scalar(np.datetime64(to_millis(v), "ms"))
        return v

    def conv(f):
        if isinstance(f, ast.And):
            parts = [p for p in (conv(c) for c in f.children)
                     if p is not None]
            if not parts:
                return None
            e = parts[0]
            for p in parts[1:]:
                e = e & p
            return e
        if isinstance(f, ast.Or):
            parts = [conv(c) for c in f.children]
            if not parts or any(p is None for p in parts):
                return None
            e = parts[0]
            for p in parts[1:]:
                e = e | p
            return e
        if isinstance(f, ast.BBox) and point_geom and f.prop == geom:
            gx, gy = pc.field(geom, "x"), pc.field(geom, "y")
            return ((gx >= f.xmin) & (gx <= f.xmax)
                    & (gy >= f.ymin) & (gy <= f.ymax))
        if isinstance(f, (ast.Intersects, ast.Within, ast.DWithin)) \
                and point_geom and f.prop == geom:
            from ..filters.helper import dwithin_degrees
            env = f.geom.envelope
            pad = (dwithin_degrees(f.geom, f.distance, f.units)
                   if isinstance(f, ast.DWithin) else 0.0)
            gx, gy = pc.field(geom, "x"), pc.field(geom, "y")
            return ((gx >= env.xmin - pad) & (gx <= env.xmax + pad)
                    & (gy >= env.ymin - pad) & (gy <= env.ymax + pad))
        if isinstance(f, ast.Compare):
            fld = pc.field(f.prop)
            v = lit(f.prop, f.value)
            return {
                ast.CompareOp.EQ: lambda: fld == v,
                ast.CompareOp.NE: lambda: fld != v,
                ast.CompareOp.LT: lambda: fld < v,
                ast.CompareOp.GT: lambda: fld > v,
                ast.CompareOp.LE: lambda: fld <= v,
                ast.CompareOp.GE: lambda: fld >= v,
            }[f.op]()
        if isinstance(f, ast.Between):
            fld = pc.field(f.prop)
            return (fld >= lit(f.prop, f.lo)) & (fld <= lit(f.prop, f.hi))
        if isinstance(f, ast.InList):
            return pc.field(f.prop).isin(
                [lit(f.prop, v) for v in f.values])
        if isinstance(f, ast.During):
            fld = pc.field(f.prop)
            return ((fld > pa.scalar(np.datetime64(f.start, "ms")))
                    & (fld < pa.scalar(np.datetime64(f.end, "ms"))))
        if isinstance(f, ast.Before):
            return pc.field(f.prop) < pa.scalar(np.datetime64(f.time, "ms"))
        if isinstance(f, ast.After):
            return pc.field(f.prop) > pa.scalar(np.datetime64(f.time, "ms"))
        if isinstance(f, ast.IsNull):
            return pc.field(f.prop).is_null()
        return None  # LIKE, NOT, fids, exotic spatial: not pushed

    try:
        return conv(f)
    except Exception:
        return None  # a column the files lack, bad literal, ...


def _read_table(files: list[str], expr=None, columns=None):
    """The Parquet scan of ``files`` in their order: row groups pruned
    by their statistics, rows by ``expr``, columns projected to
    ``columns`` (None: all). Returns (table, has_vis); the visibility
    column comes along whenever any file has it (files without it read
    null labels)."""
    import pyarrow as pa
    import pyarrow.dataset as pds
    dataset = pds.dataset(files)
    # the dataset's schema is its first file's: look at every footer
    has_vis = _VIS_COL in dataset.schema.names
    if not has_vis and any(_VIS_COL in frag.physical_schema.names
                           for frag in dataset.get_fragments()):
        has_vis = True
        dataset = pds.dataset(files, schema=dataset.schema.append(
            pa.field(_VIS_COL, pa.string())))
    if has_vis and columns is not None:
        # labels must survive projection or vis filtering silently
        # disappears on projected queries
        columns = columns + [_VIS_COL]
    return dataset.to_table(filter=expr, columns=columns), has_vis


def _split_vis(rb, remap=None):
    """(record batch without the label column, labels as an object
    array)."""
    i = rb.schema.get_field_index(_VIS_COL)
    vis = np.asarray(rb.column(i).to_pylist(), dtype=object)
    if remap is not None:
        vis = np.array([remap(v) for v in vis], dtype=object)
    return rb.drop_columns([_VIS_COL]), vis


class _FsTypeState:
    def __init__(self, sft: SimpleFeatureType, scheme: PartitionScheme,
                 root: str):
        self.sft = sft
        self.scheme = scheme
        self.root = root
        # cache: (frozenset(files), pushdown, columns) -> loaded store
        self.cache: dict[tuple, InMemoryDataStore] = {}
        # load-key digest -> memory store awaiting sidecar persistence
        self.pending_sidecar: dict[str, InMemoryDataStore] = {}

    @property
    def data_dir(self) -> str:
        return os.path.join(self.root, "data")

    @property
    def index_dir(self) -> str:
        return os.path.join(self.root, "index")

    def drop_loads(self):
        """Forget every loaded store (their device memory goes with the
        last reference)."""
        self.cache.clear()
        self.pending_sidecar.clear()


class FileSystemDataStore(DataStore):
    """Parquet-backed datastore with the same query surface as the
    in-memory store.

    ``device=None`` means ``"cuda"``: every store it loads runs on the
    card, and the constructor raises when CUDA is absent unless the
    caller names another device (``device="cpu"``)."""

    # LRU cap on persisted index snapshots per type
    _SIDECAR_CAP = 4

    def __init__(self, root: str, device=None):
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._types: dict[str, _FsTypeState] = {}
        for name in os.listdir(root):
            meta = os.path.join(root, name, "metadata.json")
            if os.path.isfile(meta):
                self._load_type(name)

    # -- metadata catalog --------------------------------------------------

    def _load_type(self, name: str):
        with open(os.path.join(self.root, name, "metadata.json")) as fh:
            meta = json.load(fh)
        # version-skew check (GeoMesaDataStore.checkProjectVersion analog)
        recorded = meta.get("version")
        if recorded is not None:
            from ..utils.version import check_version_string
            check_version_string(recorded, name)
        sft = parse_spec(name, meta["spec"])
        scheme = scheme_from_config(meta["partition_scheme"])
        self._types[name] = _FsTypeState(
            sft, scheme, os.path.join(self.root, name))

    def create_schema(self, sft: SimpleFeatureType | str,
                      spec: str | None = None,
                      scheme: PartitionScheme | None = None):
        if isinstance(sft, str):
            sft = parse_spec(sft, spec or "")
        if sft.type_name in self._types:
            raise ValueError(f"schema {sft.type_name!r} already exists")
        if scheme is None:
            # reference default: daily datetime, else z2 cells
            if sft.dtg_field is not None:
                scheme = DateTimeScheme("daily")
            elif sft.geom_field is not None:
                scheme = Z2Scheme(4)
            else:
                raise ValueError("schema needs a dtg or geometry for "
                                 "partitioning; pass an explicit scheme")
        tdir = os.path.join(self.root, sft.type_name)
        os.makedirs(os.path.join(tdir, "data"), exist_ok=True)
        from .. import __version__
        with open(os.path.join(tdir, "metadata.json"), "w") as fh:
            json.dump({"spec": sft.to_spec(),
                       "partition_scheme": scheme.to_config(),
                       "version": __version__}, fh, indent=2)
        self._types[sft.type_name] = _FsTypeState(sft, scheme, tdir)

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._state(type_name).sft

    def get_type_names(self) -> list[str]:
        return sorted(self._types)

    def remove_schema(self, type_name: str):
        """Drop the type and its on-disk data/index directories. The
        directory removal runs FIRST and raises on failure — the
        catalog entry must not disappear while data survives on disk
        (a reopen would silently resurrect the schema)."""
        import shutil
        st = self._state(type_name)
        shutil.rmtree(st.root)
        self._types.pop(type_name, None)

    def _state(self, type_name: str) -> _FsTypeState:
        if type_name not in self._types:
            raise KeyError(f"no such schema: {type_name}")
        return self._types[type_name]

    # -- writes ------------------------------------------------------------

    def write(self, type_name: str, batch: FeatureBatch,
              visibilities=None):
        """One Parquet file per partition the batch reaches, its rows in
        batch order. Returns the per-row partition names (raw, before
        quoting into directory names)."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        st = self._state(type_name)
        vis = None
        if visibilities is not None:
            vis = np.asarray(visibilities, dtype=object)
            if len(vis) != batch.n:
                raise ValueError("visibilities length mismatch")
            from ..security import validate_labels
            validate_labels(st.sft,
                            set(v for v in vis.tolist() if v))
        # rows grouped by partition as the scheme numbers them (no sort
        # of the rows' strings), in batch order within each; the batch
        # converts to Arrow once and each partition's file is a take of it
        parts, inverse = st.scheme.partition_groups(st.sft, batch)
        names = parts[inverse]
        if not batch.n:
            st.drop_loads()
            return names
        order = np.argsort(inverse, kind="stable")
        bounds = np.searchsorted(inverse[order], np.arange(len(parts) + 1))
        table = pa.Table.from_batches([batch.to_arrow()])

        def write_part(k):
            sel = order[bounds[k]:bounds[k + 1]]
            part = str(parts[k])
            pdir = os.path.join(st.data_dir, _safe_partition(part))
            os.makedirs(pdir, exist_ok=True)
            path = os.path.join(pdir, f"{uuid.uuid4().hex[:12]}.parquet")
            sub = table.take(pa.array(sel))
            if vis is not None:
                # labels persist in a reserved column next to the data
                # (the Accumulo column-visibility model made durable)
                sub = sub.append_column(
                    _VIS_COL, pa.array([None if v is None else str(v)
                                        for v in vis[sel]], pa.string()))
            pq.write_table(sub, path)
        _each_file(write_part, range(len(parts)))
        st.drop_loads()
        return names

    def delete(self, type_name: str, ids):
        """Remove features by id: rewrite every parquet file that holds
        any of them (delete + compaction in one step — the reference's
        fs storage likewise rewrites data files on modify)."""
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq
        st = self._state(type_name)
        value_set = pa.array([str(i) for i in ids], pa.string())

        def rewrite(f):
            table = pq.read_table(f)
            hit = pc.is_in(pc.cast(table.column("__fid__"), pa.string()),
                           value_set=value_set)
            n_hit = pc.sum(hit).as_py() or 0
            if not n_hit:
                return
            kept = table.filter(pc.invert(hit))
            if kept.num_rows:
                pq.write_table(kept, f)
            else:
                os.remove(f)
        _each_file(rewrite, self._files_for(st, None))
        st.drop_loads()

    def compact(self, type_name: str):
        """Merge each partition's files into one (fs/tools/compact
        analog), rows in the files' sorted order."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        st = self._state(type_name)

        def merge(part):
            pdir = os.path.join(st.data_dir, part)
            files = [os.path.join(pdir, f) for f in sorted(os.listdir(pdir))
                     if f.endswith(".parquet")]
            if len(files) <= 1:
                return
            tables = [pq.read_table(f) for f in files]
            # files may disagree on the optional __vis__ column
            merged = pa.concat_tables(tables, promote_options="default")
            out = os.path.join(pdir, f"{uuid.uuid4().hex[:12]}.parquet")
            pq.write_table(merged, out)
            for f in files:
                os.remove(f)
        _each_file(merge, self.partitions(type_name))
        st.drop_loads()

    def reindex(self, type_name: str, to_version: int | None = None):
        """Migrate the type's z-index layout: record the new version in
        the metadata, drop the sidecars (their sort orders are of the old
        curve; ``load_state`` also refuses them by version), and move
        every loaded store to the new version."""
        import shutil
        from ..features.sft import Configs, check_index_version
        to_version = check_index_version(to_version)
        st = self._state(type_name)
        if st.sft.index_version == to_version:
            return
        st.sft.user_data[Configs.INDEX_VERSION] = to_version
        meta_path = os.path.join(st.root, "metadata.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        meta["spec"] = st.sft.to_spec()
        tmp = meta_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(meta, fh, indent=2)
        os.replace(tmp, meta_path)
        shutil.rmtree(st.index_dir, ignore_errors=True)
        # a full load shares the type's schema object, a projected load
        # holds a copy: each loaded store rebuilds its z3 order under the
        # new curve (or builds at the new version on its next read)
        for mem in st.cache.values():
            try:
                ms = mem._state(type_name)
            except KeyError:
                continue
            ms.reindex(int(to_version))
        st.pending_sidecar.clear()

    # -- partitions --------------------------------------------------------

    def partitions(self, type_name: str) -> list[str]:
        st = self._state(type_name)
        out = []
        for dirpath, _dirs, files in os.walk(st.data_dir):
            if any(f.endswith(".parquet") for f in files):
                out.append(os.path.relpath(dirpath, st.data_dir)
                           .replace(os.sep, "/"))
        return sorted(out)

    def _files_for(self, st: _FsTypeState,
                   parts: list[str] | None) -> list[str]:
        if parts is None:
            files = []
            for dirpath, _d, fnames in os.walk(st.data_dir):
                files.extend(os.path.join(dirpath, f) for f in fnames
                             if f.endswith(".parquet"))
            return sorted(files)
        files = []
        for p in parts:
            pdir = os.path.join(st.data_dir, _safe_partition(p))
            if os.path.isdir(pdir):
                files.extend(os.path.join(pdir, f)
                             for f in sorted(os.listdir(pdir))
                             if f.endswith(".parquet"))
        return files

    def read_partition(self, type_name: str, partition: str):
        """Raw rows of one partition: (FeatureBatch | None, vis | None).
        ``partition`` is a name as returned by ``partitions()`` (the
        on-disk quoted form); it is NOT re-quoted here."""
        st = self._state(type_name)
        pdir = os.path.join(st.data_dir,
                            partition.replace("/", os.sep))
        if not os.path.isdir(pdir) \
                or os.path.commonpath(
                    [os.path.abspath(pdir),
                     os.path.abspath(st.data_dir)]) \
                != os.path.abspath(st.data_dir):
            return None, None
        files = [os.path.join(pdir, f) for f in sorted(os.listdir(pdir))
                 if f.endswith(".parquet")]
        if not files:
            return None, None
        table, has_vis = _read_table(files)
        batches, vises = [], []
        for rb in table.to_batches():
            if not rb.num_rows:
                continue
            if has_vis:
                rb, vis = _split_vis(rb)
                vises.append(vis)
            batches.append(FeatureBatch.from_arrow(st.sft, rb))
        if not batches:
            return None, None
        batch = FeatureBatch.concat_all(batches)
        return batch, (np.concatenate(vises) if has_vis else None)

    # -- index sidecars ----------------------------------------------------
    #
    # Built z-key sort orders persist next to the Parquet data
    # (root/<type>/index/<digest>/), keyed by a digest of the loaded
    # file set (+ sizes/mtimes) and the pushdown key, so a reopened
    # store memory-maps the permutation instead of re-sorting the keys.
    # The arrays are read-only maps: the z-key index only reads them
    # (searches, gathers), and an append merges them into new arrays.

    @staticmethod
    def _sidecar_digest(st: _FsTypeState, files, expr, props) -> str:
        import hashlib
        h = hashlib.sha256()
        for f in sorted(files):
            s = os.stat(f)
            h.update(f"{os.path.relpath(f, st.root)}|{s.st_size}|"
                     f"{s.st_mtime_ns}\n".encode())
        h.update(repr(None if expr is None else str(expr)).encode())
        h.update(repr(None if props is None else tuple(props)).encode())
        return h.hexdigest()[:24]

    def _install_sidecar(self, st: _FsTypeState, digest: str,
                         mem: InMemoryDataStore, type_name: str) -> bool:
        d = os.path.join(st.index_dir, digest)
        man = os.path.join(d, "manifest.json")
        if not os.path.isfile(man):
            return False
        try:
            with open(man) as fh:
                names = json.load(fh)["arrays"]
            state = {n: np.load(os.path.join(d, n + ".npy"),
                                mmap_mode="r") for n in names}
        except Exception:
            return False  # torn/corrupt sidecar: rebuild from scratch
        mem.warm_index(type_name, state)
        os.utime(d)  # recency for the LRU prune
        return True

    def _flush_sidecars(self, st: _FsTypeState, type_name: str):
        """Persist sort orders for loads whose index has since been
        built (lazily, by a query); prune old snapshots."""
        import shutil
        done = []
        for digest, mem in st.pending_sidecar.items():
            state = mem.index_state(type_name)
            if not state:
                continue
            d = os.path.join(st.index_dir, digest)
            tmp = d + f".tmp{os.getpid()}"
            try:
                os.makedirs(tmp, exist_ok=True)
                for name, arr in state.items():
                    np.save(os.path.join(tmp, name + ".npy"),
                            np.asarray(arr))
                with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                    json.dump({"arrays": sorted(state)}, fh)
                if os.path.isdir(d):
                    shutil.rmtree(tmp)
                else:
                    os.rename(tmp, d)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
            done.append(digest)
        for digest in done:
            st.pending_sidecar.pop(digest, None)
        # LRU prune
        if os.path.isdir(st.index_dir):
            snaps = [os.path.join(st.index_dir, n)
                     for n in os.listdir(st.index_dir)
                     if ".tmp" not in n]
            snaps.sort(key=lambda p: os.path.getmtime(p))
            for p in snaps[:-self._SIDECAR_CAP]:
                shutil.rmtree(p, ignore_errors=True)

    # -- loads -------------------------------------------------------------

    def _load(self, st: _FsTypeState, files: list[str],
              expr=None, props: list[str] | None = None
              ) -> InMemoryDataStore:
        """The in-memory store on the card over ``files`` (pushdown
        ``expr``, columns ``props``), from the cache or loaded now: one
        store write per Parquet record batch, in file order."""
        key = (frozenset(files), None if expr is None else str(expr),
               None if props is None else tuple(props))
        if key in st.cache:
            st.cache[key] = st.cache.pop(key)  # LRU recency refresh
            return st.cache[key]
        sft = st.sft
        columns = None
        if props is not None:
            keep = set(props)
            sft = SimpleFeatureType(
                sft.type_name, [a for a in sft.attributes
                                if a.name in keep], sft.user_data)
            columns = ["__fid__"] + [a.name for a in sft.attributes]
        ds = InMemoryDataStore(device=self.device)
        ds.create_schema(sft)
        if files:
            table, has_vis = _read_table(files, expr, columns)
            # attribute-level labels are positional over the FULL
            # schema; a projected load must remap each label to the
            # kept attributes or the parts guard the wrong columns
            remap = None
            if (has_vis and props is not None
                    and st.sft.visibility_level == "attribute"):
                keep_j = [j for j, a in enumerate(st.sft.attributes)
                          if a.name in keep]
                n_full = len(st.sft.attributes)

                def remap(v, _k=keep_j, _n=n_full):
                    if not v:
                        return v
                    parts = (str(v).split(",") + [""] * _n)[:_n]
                    return ",".join(parts[j] for j in _k)
            # one write per record batch, as the JAX store writes: a
            # write is a host append (the device columns build at the
            # first read), and no single write reaches the eager index
            # build of a bulk load, which would sort before the sidecar
            # below is installed
            for rb in table.to_batches():
                if not rb.num_rows:
                    continue
                vis = None
                if has_vis:
                    rb, vis = _split_vis(rb, remap)
                ds.write(sft.type_name, FeatureBatch.from_arrow(sft, rb),
                         visibilities=vis)
            del table
        # adopt a persisted index snapshot for this exact load, or mark
        # the store for persistence once a query builds its index
        if files:
            digest = self._sidecar_digest(st, files, expr, props)
            if not self._install_sidecar(st, digest, ds, sft.type_name):
                st.pending_sidecar[digest] = ds
        # bounded LRU: pushdown makes keys (files, filter, columns), so
        # a rotation of several recurring queries must stay resident
        if len(st.cache) >= _LOAD_CACHE:
            evicted = st.cache.pop(next(iter(st.cache)))
            # an evicted store must not stay pinned awaiting a sidecar
            # flush that can never come (its index will never be built)
            st.pending_sidecar = {d: m for d, m in
                                  st.pending_sidecar.items()
                                  if m is not evicted}
        st.cache[key] = ds
        return ds

    # -- queries -----------------------------------------------------------

    def load_resident(self, type_name: str) -> None:
        """Load the full table into the device-resident engine once.
        Subsequent queries are served from it (no per-query parquet
        scans), its z-key index persists as a sidecar, and a reopened
        store adopts the memory-mapped sort order instead of
        re-sorting."""
        st = self._state(type_name)
        self._load(st, self._files_for(st, None))

    def query(self, q: Query | str, type_name: str | None = None,
              explain_out=None) -> QueryResult:
        if isinstance(q, str):
            q = Query(type_name, q)
        st = self._state(q.type_name)
        # a resident full-table store answers directly: device columns
        # and sort orders are already built (or memory-mapped), so skip
        # partition pruning and parquet pushdown entirely. A persisted
        # FULL-TABLE sidecar on disk also routes here: a reopened store
        # adopts the memory-mapped sort order rather than re-sorting
        files_all = self._files_for(st, None)
        full_key = (frozenset(files_all), None, None)
        resident = full_key in st.cache
        if files_all and not resident and os.path.isdir(st.index_dir):
            # probe only when sidecars exist at all; a pure pushdown
            # workload never pays the stat+digest pass
            digest = self._sidecar_digest(st, files_all, None, None)
            resident = os.path.isfile(os.path.join(
                st.index_dir, digest, "manifest.json"))
        if files_all and resident:
            mem = self._load(st, files_all)
            res = mem.query(q, explain_out=explain_out)
            self._flush_sidecars(st, q.type_name)
            res.explain("Served from resident full-table store")
            return res
        parts = st.scheme.covering_partitions(st.sft, q.filter)
        if parts == []:
            from ..index.api import Explainer, FilterStrategy
            ex = Explainer(explain_out)
            ex("All partitions pruned")
            return QueryResult(np.empty(0, dtype=np.int64),
                               np.empty(0, dtype=object), None, ex,
                               FilterStrategy("empty", None, None))
        files = self._files_for(st, parts)
        expr = _pushdown_expr(q.filter, st.sft)
        props = None
        if q.properties is not None:
            need = ast.props_of(q.filter) | set(q.properties)
            if st.sft.geom_field:
                need.add(st.sft.geom_field)
            if st.sft.dtg_field:
                need.add(st.sft.dtg_field)
            if q.sort_by:
                need.add(q.sort_by)
            from ..index.api import QueryHints
            sample_by = q.hints.get(QueryHints.SAMPLE_BY)
            if sample_by:
                need.add(sample_by)
            props = [a.name for a in st.sft.attributes if a.name in need]
        mem = self._load(st, files, expr, props)
        res = mem.query(q, explain_out=explain_out)
        self._flush_sidecars(st, q.type_name)
        res.explain(f"Partitions scanned: "
                    f"{'all' if parts is None else len(parts)}; "
                    f"files: {len(files)}; parquet pushdown: "
                    f"{'yes' if expr is not None else 'no'}"
                    + (f"; columns: {len(props)}" if props else ""))
        return res

    def count(self, type_name: str) -> int:
        st = self._state(type_name)
        mem = self._load(st, self._files_for(st, None))
        return mem.count(type_name)

    def bin_query(self, type_name: str, ecql="INCLUDE",
                  track: str | None = None, label: str | None = None,
                  sort: bool = False) -> bytes:
        """BIN aggregation over the full table's loaded store."""
        st = self._state(type_name)
        mem = self._load(st, self._files_for(st, None))
        return mem.bin_query(type_name, ecql, track=track, label=label,
                             sort=sort)

    def arrow_ipc(self, type_name: str, ecql="INCLUDE",
                  sort_by: str | None = None) -> bytes:
        st = self._state(type_name)
        mem = self._load(st, self._files_for(st, None))
        return mem.arrow_ipc(type_name, ecql, sort_by=sort_by)
