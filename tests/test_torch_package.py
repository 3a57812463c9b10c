"""Package rules of the PyTorch port, and its CUDA kernels on the card.

This file imports no JAX, so the GPU tests can run where JAX is not
installed: ``python -m pytest --noconftest -m gpu tests/test_torch_package.py``.
On a machine without CUDA the ``gpu`` tests skip.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import geomesa_tpu_torch
from geomesa_tpu_torch import FeatureBatch, InMemoryDataStore, Query
from geomesa_tpu_torch import parse_spec
from geomesa_tpu_torch.analytics import join
from geomesa_tpu_torch.analytics.tube import tube_select_mask
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.geometry import parse_wkt
from geomesa_tpu_torch.scan import aggregations, gscan, kernels, residual, zscan

PKG = os.path.dirname(geomesa_tpu_torch.__file__)
MS_DAY = 86_400_000


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, geomesa_tpu_torch, geomesa_tpu_torch.store, "
            "geomesa_tpu_torch.scan.kernels, geomesa_tpu_torch.scan.batcher, "
            "geomesa_tpu_torch.metrics, geomesa_tpu_torch.security, "
            "geomesa_tpu_torch.scan.aggregations, "
            "geomesa_tpu_torch.store.common, geomesa_tpu_torch.stats, "
            "geomesa_tpu_torch.arrow, geomesa_tpu_torch.arrow.delta, "
            "geomesa_tpu_torch.geometry.relate, "
            "geomesa_tpu_torch.geometry.wkb, "
            "geomesa_tpu_torch.geometry.geojson, "
            "geomesa_tpu_torch.analytics.st_functions, "
            "geomesa_tpu_torch.curves.xz, geomesa_tpu_torch.index.xzkeys, "
            "geomesa_tpu_torch.scan.gscan, geomesa_tpu_torch.analytics, "
            "geomesa_tpu_torch.analytics.join, "
            "geomesa_tpu_torch.analytics.partitioning, "
            "geomesa_tpu_torch.analytics.processes, "
            "geomesa_tpu_torch.analytics.tube, geomesa_tpu_torch.utils.fp, "
            "geomesa_tpu_torch.native, geomesa_tpu_torch.curves.legacy, "
            "geomesa_tpu_torch.features.codec, geomesa_tpu_torch.wal, "
            "geomesa_tpu_torch.integrity, geomesa_tpu_torch.integrity.verify, "
            "geomesa_tpu_torch.store.filebus, geomesa_tpu_torch.store.fs, "
            "geomesa_tpu_torch.store.partitions, geomesa_tpu_torch.utils, "
            "geomesa_tpu_torch.utils.metadata, geomesa_tpu_torch.utils.version, "
            "geomesa_tpu_torch.utils.locking, geomesa_tpu_torch.utils.ageoff, "
            "geomesa_tpu_torch.convert, geomesa_tpu_torch.convert.dsl, "
            "geomesa_tpu_torch.convert.converter, "
            "geomesa_tpu_torch.convert.vectorized, "
            "geomesa_tpu_torch.convert.validators, "
            "geomesa_tpu_torch.convert.enrichment, "
            "geomesa_tpu_torch.convert.formats, "
            "geomesa_tpu_torch.convert.avro_reader, "
            "geomesa_tpu_torch.convert.avro_writer, "
            "geomesa_tpu_torch.convert.geo_formats, "
            "geomesa_tpu_torch.resilience, "
            "geomesa_tpu_torch.resilience.policy, "
            "geomesa_tpu_torch.filters.compile, "
            "geomesa_tpu_torch.scan.standing, geomesa_tpu_torch.store.live, "
            "geomesa_tpu_torch.store.socketbus, "
            "geomesa_tpu_torch.store.stream, "
            "geomesa_tpu_torch.store.lambda_store, "
            "geomesa_tpu_torch.store.continuous, geomesa_tpu_torch.geohash, "
            "geomesa_tpu_torch.sql, geomesa_tpu_torch.sql.parser, "
            "geomesa_tpu_torch.sql.planner, geomesa_tpu_torch.sql.engine, "
            "geomesa_tpu_torch.sql.distributed, geomesa_tpu_torch.obs, "
            "geomesa_tpu_torch.obs.trace, geomesa_tpu_torch.obs.prof, "
            "geomesa_tpu_torch.obs.slo, geomesa_tpu_torch.tenants, "
            "geomesa_tpu_torch.audit, geomesa_tpu_torch.audit.events, "
            "geomesa_tpu_torch.audit.hook, "
            "geomesa_tpu_torch.metrics.reporters, "
            "geomesa_tpu_torch.scan.registry, "
            "geomesa_tpu_torch.utils.threads, geomesa_tpu_torch.cache, "
            "geomesa_tpu_torch.cache.keys, "
            "geomesa_tpu_torch.cache.result_cache, "
            "geomesa_tpu_torch.cache.refresh, geomesa_tpu_torch.ingest, "
            "geomesa_tpu_torch.ingest.pipeline, geomesa_tpu_torch.api, "
            "geomesa_tpu_torch.resilience.breaker, "
            "geomesa_tpu_torch.resilience.hedge, "
            "geomesa_tpu_torch.resilience.chaos, "
            "geomesa_tpu_torch.web, geomesa_tpu_torch.web.server, "
            "geomesa_tpu_torch.store.remote, "
            "geomesa_tpu_torch.integrity.scrub, "
            "geomesa_tpu_torch.replication, "
            "geomesa_tpu_torch.replication.sync, "
            "geomesa_tpu_torch.replication.shipper, "
            "geomesa_tpu_torch.replication.replica, "
            "geomesa_tpu_torch.replication.router, "
            "geomesa_tpu_torch.cluster, geomesa_tpu_torch.cluster.partition, "
            "geomesa_tpu_torch.cluster.reshard, "
            "geomesa_tpu_torch.cluster.coordinator, "
            "geomesa_tpu_torch.cluster.autoscale, "
            "geomesa_tpu_torch.evolve, geomesa_tpu_torch.evolve.evolver, "
            "geomesa_tpu_torch.views, geomesa_tpu_torch.views.state, "
            "geomesa_tpu_torch.views.registry, "
            "geomesa_tpu_torch.views.subscribe, geomesa_tpu_torch.jobs, "
            "geomesa_tpu_torch.integrity.harness, "
            "geomesa_tpu_torch.parallel, geomesa_tpu_torch.parallel.mesh, "
            "geomesa_tpu_torch.parallel.ring, "
            "geomesa_tpu_torch.store.mesh_store, "
            "geomesa_tpu_torch.store.fs_mesh, "
            "geomesa_tpu_torch.index.splitters\n"
            "import importlib; "
            "importlib.import_module('geomesa_tpu_torch.obs.runtime')\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'geomesa_tpu' "
            "or m.startswith('geomesa_tpu.')]\n"
            "print(','.join(bad))")
    root = os.path.dirname(PKG)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_source_imports_jax_or_reference():
    pat = re.compile(r"^\s*(from|import)\s+(jax\b|geomesa_tpu\b(?!_torch))",
                     re.M)
    offenders, seen = [], set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                seen.add(os.path.relpath(path, PKG))
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert offenders == []
    assert {"metrics/__init__.py", "metrics/registry.py",
            "scan/batcher.py", "scan/zscan.py", "scan/residual.py",
            "scan/gscan.py", "index/attr.py",
            "analytics/st_functions.py", "scan/aggregations.py",
            "security/__init__.py", "security/visibility.py",
            "store/common.py", "stats/sketches.py", "stats/estimator.py",
            "stats/serialize.py", "arrow/vector.py", "arrow/io.py",
            "arrow/delta.py", "arrow/scan.py", "arrow/data.py",
            "arrow/feature.py", "geometry/relate.py", "geometry/wkb.py",
            "geometry/geojson.py", "curves/xz.py", "index/xzkeys.py",
            "analytics/join.py", "analytics/partitioning.py",
            "analytics/processes.py", "analytics/tube.py",
            "utils/fp.py", "native/__init__.py", "curves/legacy.py",
            "features/codec.py", "integrity/faultfs.py", "integrity/verify.py",
            "store/filebus.py", "store/live.py", "wal/log.py",
            "wal/snapshot.py", "wal/recovery.py", "wal/durable.py",
            "store/fs.py", "store/partitions.py", "utils/metadata.py",
            "utils/version.py", "utils/locking.py", "utils/ageoff.py",
            "convert/__init__.py", "convert/dsl.py", "convert/converter.py",
            "convert/vectorized.py", "convert/validators.py",
            "convert/enrichment.py", "convert/formats.py",
            "convert/avro_reader.py", "convert/avro_writer.py",
            "convert/geo_formats.py", "resilience/__init__.py",
            "resilience/policy.py", "filters/compile.py",
            "scan/standing.py", "store/socketbus.py", "store/stream.py",
            "store/lambda_store.py", "store/continuous.py",
            "geohash/__init__.py", "sql/__init__.py", "sql/parser.py",
            "sql/planner.py", "sql/engine.py", "sql/distributed.py",
            "obs/__init__.py", "obs/trace.py", "obs/prof.py",
            "obs/runtime.py", "obs/slo.py", "tenants/__init__.py",
            "audit/__init__.py", "audit/events.py", "audit/hook.py",
            "metrics/reporters.py", "scan/registry.py",
            "utils/threads.py", "cache/__init__.py", "cache/keys.py",
            "cache/result_cache.py", "cache/refresh.py",
            "ingest/__init__.py", "ingest/pipeline.py", "api/__init__.py",
            "resilience/breaker.py", "resilience/hedge.py",
            "resilience/chaos.py", "web/__init__.py", "web/server.py",
            "store/remote.py", "integrity/scrub.py",
            "replication/__init__.py", "replication/sync.py",
            "replication/shipper.py", "replication/replica.py",
            "replication/router.py", "cluster/__init__.py",
            "cluster/partition.py", "cluster/reshard.py",
            "cluster/coordinator.py", "cluster/autoscale.py",
            "index/splitter.py", "utils/device.py", "evolve/__init__.py",
            "evolve/evolver.py", "views/__init__.py", "views/state.py",
            "views/registry.py", "views/subscribe.py", "jobs/__init__.py",
            "integrity/harness.py"} <= seen
    # the native library's C++ sources are the port's own copies
    src = os.path.join(PKG, "native", "src")
    assert sorted(os.listdir(src)) == ["feature_codec.cpp", "zbuild.cpp",
                                       "zencode.cpp", "zrange.cpp",
                                       "zsort.cpp"]
    for f in os.listdir(src):
        with open(os.path.join(src, f)) as fh:
            assert not re.search(r"#include\s+[<\"][^>\"]*geomesa_tpu/",
                                 fh.read())


def test_version_equals_the_reference():
    """The file store stamps the version into each type's metadata.json
    and refuses a major skew: the two packages' must be equal (read from
    the JAX package's source, which this file does not import)."""
    root = os.path.dirname(PKG)
    with open(os.path.join(root, "geomesa_tpu", "__init__.py")) as fh:
        ref = re.search(r'^__version__ = "([^"]+)"', fh.read(), re.M)
    assert ref is not None
    assert geomesa_tpu_torch.__version__ == ref.group(1)


def test_file_store_defaults_to_cuda(monkeypatch, tmp_path):
    from geomesa_tpu_torch import FileSystemDataStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FileSystemDataStore(str(tmp_path / "fs"), device=device)
    assert not os.path.exists(tmp_path / "fs")
    ds = FileSystemDataStore(str(tmp_path / "fs"), device="cpu")
    ds.create_schema("t", "dtg:Date,*geom:Point")
    ds.write_dict("t", ["a"], {"dtg": [0], "geom": ([1.0], [2.0])})
    ds.load_resident("t")
    (mem,) = ds._state("t").cache.values()
    assert mem.device.type == "cpu"


def test_store_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InMemoryDataStore()
    assert InMemoryDataStore(device="cpu").device.type == "cpu"
    # a durable store too, before it touches its directory
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InMemoryDataStore(device=device, durable_dir=str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()


def test_mesh_stores_default_to_cuda(monkeypatch, tmp_path):
    """A mesh is of CUDA devices unless the caller names another, and
    the mesh stores and data_mesh raise without CUDA (before the fs-mesh
    store touches its root)."""
    from geomesa_tpu_torch import (DistributedDataStore,
                                   FsBackedDistributedDataStore)
    from geomesa_tpu_torch.parallel import data_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            data_mesh(device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            data_mesh(8, device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedDataStore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FsBackedDistributedDataStore(str(tmp_path / "fsm"))
    assert not (tmp_path / "fsm").exists()
    mesh = data_mesh(8, device="cpu")
    ds = DistributedDataStore(mesh)
    assert ds.device.type == "cpu" and ds.mesh is mesh
    fsm = FsBackedDistributedDataStore(str(tmp_path / "fsm"), mesh)
    assert fsm.fs.device.type == "cpu"


def test_streaming_stores_default_to_cuda(monkeypatch, tmp_path):
    """The live, stream and lambda stores run on the card unless the
    caller names a device, and raise without one (before a durable
    directory is touched); a standing set takes its store's device."""
    from geomesa_tpu_torch import (IterableSource, LambdaDataStore,
                                   LiveDataStore, StreamDataStore)
    from geomesa_tpu_torch.scan.standing import StandingFilterSet
    from geomesa_tpu_torch.store.continuous import ContinuousQueryPublisher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = {"type": "delimited-text", "format": "CSV",
            "id-field": "$1",
            "fields": [{"name": "dtg", "transform": "isoDate($2)"},
                       {"name": "geom",
                        "transform": "point($3::double, $4::double)"}]}
    spec = "dtg:Date,*geom:Point"
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LiveDataStore(device=device, durable_dir=str(tmp_path / "d"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamDataStore("s", conf, IterableSource([]), spec=spec,
                            device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LambdaDataStore(device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StandingFilterSet(parse_spec("t", spec), device=device)
    assert not (tmp_path / "d").exists()
    live = LiveDataStore(device="cpu")
    assert live.device.type == "cpu"
    assert StreamDataStore("s", conf, IterableSource([]), spec=spec,
                           device="cpu").device.type == "cpu"
    lam = LambdaDataStore(device="cpu")
    assert lam.device.type == lam.persistent.device.type == "cpu"
    live.create_schema("t", spec)
    pub = ContinuousQueryPublisher(live)
    pub.register("q", "t", "BBOX(geom, 0, 0, 1, 1)")
    assert pub._sets["t"].device.type == "cpu"
    assert all(kernels.launches.get(k) is not None for k in (
        "standing_grid", "standing_count", "standing_offsets",
        "standing_write", "standing_sort"))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _data(n, cap, device, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n) * scale
    y = rng.uniform(-90, 90, n) * scale
    ms = rng.integers(0, 100 * MS_DAY, n)
    return x, y, ms, zscan.build_scan_data(x, y, ms, device, cap=cap)


QUERIES = [
    ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)]),
    ([(-10.0, -10.0, 10.0, 10.0)], []),
    ([(-80.0, 30.0, -60.0, 45.0), (0.0, 0.0, 30.0, 20.0),
      (100.0, -50.0, 140.0, -10.0)],
     [(0, 10 * MS_DAY), (90 * MS_DAY, 99 * MS_DAY), (40 * MS_DAY, 41 * MS_DAY)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 100 * MS_DAY)]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("boxes,intervals", QUERIES)
def test_kernels_match_plain(cuda, boxes, intervals):
    _, _, _, d = _data(300_001, 524_288, cuda)
    q = zscan.make_query(boxes, intervals)
    b, t = q.tables(cuda)
    want = kernels.scan_mask_plain(d.cols, d.n, b, t, q.time_any)
    got = kernels.scan_mask(d.cols, d.n, b, t, q.time_any)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[d.n:].any()
    cnt = kernels.scan_count(d.cols, d.n, b, t, q.time_any)
    assert int(cnt.item()) == int(want.sum())
    idx = torch.randint(0, d.n, (70_001,), device=cuda, dtype=torch.int32,
                        generator=torch.Generator(cuda).manual_seed(1))
    got = kernels.scan_mask_gather(d.rows, idx, b, t, q.time_any)
    assert torch.equal(got, kernels.scan_mask_gather_plain(
        d.rows, idx, b, t, q.time_any))


@pytest.fixture(scope="module")
def gather_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return _data(2_000_003, 2**21, torch.device("cuda"), seed=4)[3]


@pytest.mark.gpu
@pytest.mark.parametrize("time_any", [False, True])
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("m", [1, 31, 33, 4097, 1_000_000])
def test_gather_kernel_matches_plain(gather_data, m, order, time_any):
    """The kernel equals the plain version on the gather table, ragged
    edges included, and each call is one launch."""
    d = gather_data
    dev = d.device
    q = zscan.make_query(*QUERIES[1 if time_any else 0])
    b, t = q.tables(dev)
    idx = torch.randint(0, d.n, (m,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(m))
    if order == "sorted":
        idx = torch.sort(idx).values
    want = kernels.scan_mask_gather_plain(d.rows, idx, b, t, time_any)
    kernels.reset_launches()
    got = kernels.scan_mask_gather(d.rows, idx, b, t, time_any)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.launches["scan_mask_gather"] == 1
    with pytest.raises(ValueError, match="int32"):
        kernels.scan_mask_gather(d.rows, idx.long(), b, t, time_any)
    with pytest.raises(ValueError, match="aligned"):
        kernels.scan_mask_gather(d.rows, torch.cat([idx, idx])[1:m + 1], b,
                                 t, time_any)
    flat = torch.zeros(8 * 16 + 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kernels.scan_mask_gather(flat[4:].view(16, 8), idx % 16, b, t,
                                 time_any)


@pytest.mark.gpu
def test_kernels_keep_subnormals(cuda):
    """Built without flush-to-zero: subnormal words compare as numbers."""
    _, _, _, d = _data(100_000, 131_072, cuda, seed=3, scale=1e-42)
    q = zscan.make_query([(-5e-41, -2e-41, 7e-41, 3e-41)], [])
    b, t = q.tables(cuda)
    want = kernels.scan_mask_plain(d.cols, d.n, b, t, True)
    got = kernels.scan_mask(d.cols, d.n, b, t, True)
    assert 0 < int(want.sum()) < d.n
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_plain(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")
    for name in ("scan_mask_plain", "scan_mask_gather_plain",
                 "scan_count_plain", "scan_batch_bits_plain",
                 "compact_bits_plain", "compact_prefix_plain", "_predicate",
                 "_candidates", "pip_mask_plain", "residual_mask_plain",
                 "density_grid_plain", "density_cells_plain",
                 "extent_tristate_plain", "_tristate_rows",
                 "dwithin_counts_plain", "slab_pairs_plain",
                 "contains_counts_plain", "contains_band_rows_plain",
                 "_contains_one", "knn_topk_plain",
                 "dwithin_counts_tiles_plain",
                 "contains_counts_tiles_plain", "slab_pairs_tiles_plain",
                 "_slab_hits", "knn_topk_blocks_plain", "_knn_keys",
                 "tube_mask_plain", "tube_mask_index_plain",
                 "standing_grid_plain", "standing_count_plain",
                 "standing_offsets_plain", "standing_write_plain",
                 "standing_sort_plain", "_standing_hits"):
        monkeypatch.setattr(kernels, name, refuse)
    x, y, _, d = _data(10_000, 16_384, cuda)
    q = zscan.make_query(*QUERIES[0])
    kernels.reset_launches()
    zscan.scan_mask(d, q)
    zscan.scan_mask_at(d, q, np.arange(0, 10_000, 7))
    zscan.scan_count(d, q)
    zscan.batch_hit_rows(d, zscan.stack_queries(
        [zscan.make_query(*qq) for qq in QUERIES]))
    gscan.points_in_polygon_device(x, y, gscan.pack_polygon(
        parse_wkt(STAR), cuda))
    batch = _attr_batch(10_000)
    residual.device_mask(parse_ecql("age > 5 AND name LIKE 'w0%'"), batch,
                         residual.DeviceColumns(batch, cuda))
    aggregations.density_grid(x, y, np.ones(len(x), bool), (-90, -45, 90, 45),
                              64, 32, device=cuda)
    eb, ems = extent_cases(1000)
    gscan.extent_tristate(gscan.build_extent_data(eb, ems, cuda),
                          gscan.extent_query(*EXTENT_QUERIES[0]))
    # the joins on the scan columns: counts (no band rows on these
    # rows), pairs (two slab passes), knn (10,064 rows in three chunks,
    # then their keys), contains counts and pairs
    dev = (d.xhi, d.yhi)
    join.dwithin_join(x, y, [0.0], [0.0], 20.0, counts_only=True,
                      device_xy=dev)
    join.dwithin_join(x, y, [0.0], [0.0], 20.0, device_xy=dev)
    join.knn(x, y, 0.0, 0.0, 5, device_xy=dev)
    for counts_only in (True, False):
        join.contains_join([parse_wkt(STAR)], x, y, counts_only=counts_only,
                           device_xy=dev)
    tube_select_mask(d, [(-50.0, -40.0, 50.0, 40.0)], [(0, 50 * MS_DAY)])
    # one standing dispatch of one chunk: the grid's count and prefix
    # (its one slot is everywhere: no cell list to fill), a count and a
    # write launch, the slots' prefix and the sort; no bitmap and no
    # compaction
    from geomesa_tpu_torch.scan.standing import StandingFilterSet
    fset = StandingFilterSet(_attr_batch(1).sft, device=cuda)
    fset.register("q", parse_ecql("age > 5"))
    fset.dispatch(_attr_batch(1000))
    assert kernels.launches == {"scan_mask": 1, "scan_mask_gather": 1,
                                "scan_count": 1, "scan_batch_bits": 1,
                                "compact_prefix": 1, "compact_bits": 1,
                                "pip_mask": 1, "residual_mask": 1,
                                "density_grid": 1, "extent_tristate": 1,
                                "dwithin_counts": 1, "slab_pairs": 4,
                                "contains_counts": 1, "knn_topk": 3,
                                "tube_mask": 2, "standing_grid": 2,
                                "standing_count": 1, "standing_offsets": 1,
                                "standing_write": 1, "standing_sort": 1}
    join.clear_xsort_cache()


@pytest.mark.gpu
def test_store_on_cuda_matches_cpu(cuda, monkeypatch):
    rng = np.random.default_rng(9)
    n = 40_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    ids = [f"f{i}" for i in range(n)]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    q = ("BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
         "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z")
    for host, thr in (("0", "1.0"), ("0", "0")):
        monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", host)
        monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", thr)
        kernels.reset_launches()
        got = stores[0].query(q, "pts")
        assert sum(kernels.launches.values()) == 1
        assert list(got.ids) == list(stores[1].query(q, "pts").ids)


def _durable_history(ds, seed, x, y, ms):
    """Chunked writes, a checkpoint, then a tail of new rows, an update
    (delete, then write) and a delete; returns the ids in row order."""
    ds.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
    n = len(x)
    ids = np.array([f"f{i}" for i in range(n)], dtype=object)
    for lo in range(0, n - 8_000, 8_000):
        ds.write_dict("pts", ids[lo:lo + 8_000],
                      {"dtg": ms[lo:lo + 8_000],
                       "geom": (x[lo:lo + 8_000], y[lo:lo + 8_000])})
    ds.checkpoint()
    lo = n - 8_000
    ds.write_dict("pts", ids[lo:], {"dtg": ms[lo:], "geom": (x[lo:], y[lo:])})
    rng = np.random.default_rng(seed)
    upd = ids[rng.choice(n, 1_000, replace=False)]
    ds.delete("pts", upd)
    ds.write_dict("pts", upd, {"dtg": ms[:1_000],
                               "geom": (y[:1_000] * 2.0, x[:1_000] / 2.0)})
    ds.delete("pts", ids[rng.choice(n, 500, replace=False)])
    return list(ds.query("INCLUDE", "pts").ids)


@pytest.mark.gpu
def test_durable_store_on_cuda_matches_cpu(cuda, monkeypatch, tmp_path):
    """A durable CUDA store written, checkpointed, aborted (a torn
    partial frame after its last record) and reopened holds its columns
    on the card and answers as the same sequence on a CPU store does,
    through the scan kernels."""
    from geomesa_tpu_torch.wal.log import list_segments
    rng = np.random.default_rng(10)
    n = 40_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    stores, want = [], []
    for name, device in (("gpu", None), ("cpu", "cpu")):
        root = str(tmp_path / name)
        ds = InMemoryDataStore(device=device, durable_dir=root,
                               wal_fsync="always")
        want.append(_durable_history(ds, 10, x, y, ms))
        ds.journal.abort()
        _, seg = list_segments(os.path.join(root, "log"))[-1]
        with open(seg, "ab") as f:
            f.write(b"\x05\x00\x00\x00 torn")
        stores.append(InMemoryDataStore(device=device, durable_dir=root))
    assert want[0] == want[1]
    gpu, cpu = stores
    assert gpu.journal.last_report.torn_records_dropped == 1
    assert gpu.journal.last_report.checkpoint_lsn > 0
    assert list(gpu.query("INCLUDE", "pts").ids) == want[0]
    q = ("BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
         "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z")
    for host, thr in (("0", "1.0"), ("0", "0")):
        monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", host)
        monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", thr)
        kernels.reset_launches()
        got = gpu.query(q, "pts")
        assert sum(kernels.launches.values()) >= 1
        assert list(got.ids) == list(cpu.query(q, "pts").ids)
        assert gpu.query_count(q, "pts") == cpu.query_count(q, "pts")
    assert gpu._types["pts"].scan_data.xhi.device.type == "cuda"
    for s in stores:
        s.close()


@pytest.mark.gpu
def test_file_store_on_cuda_matches_cpu(cuda, monkeypatch, tmp_path):
    """A file store on the card (partitioned Parquet, loaded into an
    in-memory store on CUDA) over a root the CPU store wrote: its
    resident query launches scan_mask_gather, and every answer (pruned
    and pushed down, an attribute predicate, resident, a reopen that
    adopts the sidecar with no z-key sort) equals the CPU store's on the
    same root, id for id in order."""
    from geomesa_tpu_torch import FileSystemDataStore
    from geomesa_tpu_torch.index import zkeys
    rng = np.random.default_rng(17)
    n = 60_000
    ids = np.array([f"v{i}" for i in range(n)], dtype=object)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    data = {"name": np.array([f"n{i % 50}" for i in range(n)], dtype=object),
            "speed": rng.uniform(0, 30, n),
            "dtg": 1_577_836_800_000 + rng.integers(0, 20 * MS_DAY, n)}
    root = str(tmp_path / "root")
    writer = FileSystemDataStore(root, device="cpu")
    writer.create_schema("ais", "name:String,speed:Double,dtg:Date,"
                         "*geom:Point")
    for lo in range(0, n, 20_000):
        sl = slice(lo, lo + 20_000)
        writer.write_dict("ais", ids[sl], {
            **{k: v[sl] for k, v in data.items()}, "geom": (x[sl], y[sl])})
    writer.compact("ais")
    q = ("BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
         "2020-01-03T00:00:00Z/2020-01-10T00:00:00Z")
    attr = "speed > 25 AND BBOX(geom, -100, -40, 100, 40)"
    got = {}
    for device in (None, "cpu"):
        ds = FileSystemDataStore(root, device=device)
        pruned = ds.query(q, "ais").ids.tolist()
        attr_ids = ds.query(attr, "ais").ids.tolist()
        ds.load_resident("ais")
        monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", "0")
        monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", "1.0")
        kernels.reset_launches()
        resident = ds.query(q, "ais").ids.tolist()
        if device is None:
            assert kernels.launches["scan_mask_gather"] >= 1
            full = [m for k, m in ds._state("ais").cache.items()
                    if k[1] is None and k[2] is None]
            assert full[0]._types["ais"].scan_data.xhi.device.type == "cuda"
        monkeypatch.setattr(zkeys, "sort_bin_z", None)
        reopened = FileSystemDataStore(root, device=device).query(
            q, "ais").ids.tolist()
        monkeypatch.undo()
        got[device] = (pruned, attr_ids, resident, reopened,
                       ds.count("ais"))
    assert got[None] == got["cpu"]
    pruned, attr_ids, resident, reopened, count = got[None]
    assert pruned == resident == reopened and len(pruned) > 0
    assert len(attr_ids) > 0 and count == n


def _batch(count, k_boxes=None, intervals=None, seed=0):
    """``count`` stacked queries: the QUERIES cycled, or ``k_boxes``
    seeded boxes and ``intervals`` intervals each (the split path)."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(count):
        if k_boxes is None:
            qs.append(zscan.make_query(*QUERIES[i % len(QUERIES)]))
            continue
        corners = rng.uniform([-180, -90], [170, 80], (k_boxes, 2))
        boxes = [(x0, y0, x0 + 10, y0 + 10) for x0, y0 in corners]
        ivs = [(j * 5 * MS_DAY, (j * 5 + 3) * MS_DAY) for j in range(intervals)]
        qs.append(zscan.make_query(boxes, ivs))
    return zscan.stack_queries(qs)


def _mixed_batch(count, seed=0):
    """``count`` queries whose own slot counts differ within the batch:
    1 to 4 boxes, and no interval (time-free), one, or three."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(count):
        boxes = []
        for _ in range(1 + i % 4):
            w, h = rng.uniform(5, 120, 2)
            x0, y0 = rng.uniform(-180, 180 - w), rng.uniform(-90, 90 - h)
            boxes.append((x0, y0, x0 + w, y0 + h))
        ivs = [(j * 30 * MS_DAY, (j * 30 + 20) * MS_DAY)
               for j in range((0, 1, 3)[i % 3])]
        qs.append(zscan.make_query(boxes, ivs))
    return zscan.stack_queries(qs)


def _check_batch(d, bq, n_launch=1, every_slot=False):
    """Both batched kernels and the prefix kernel against their plain
    versions on the card, exactly; the bitmap kernel in ``n_launch``
    launches, over each query's own slots (or, with ``every_slot``,
    counts of K boxes and B intervals: the unused NaN and impossible
    slots too)."""
    b, t = bq.tables(d.device)
    c = bq.counts(d.device)
    if every_slot:
        c = torch.tensor([[b.shape[1], t.shape[1]]] * b.shape[0],
                         dtype=torch.int32, device=d.device)
    want_bits, want_parts = kernels.scan_batch_bits_plain(d.cols, d.n, b, t, c)
    kernels.reset_launches()
    bits, parts = kernels.scan_batch_bits(d.cols, d.n, b, t, c)
    torch.cuda.synchronize()
    assert kernels.launches["scan_batch_bits"] == n_launch
    assert torch.equal(bits, want_bits) and torch.equal(parts, want_parts)
    offsets, totals = kernels.compact_prefix(parts)
    torch.cuda.synchronize()
    want_offsets, want_totals = kernels.compact_prefix_plain(want_parts)
    assert torch.equal(offsets, want_offsets) and torch.equal(totals,
                                                              want_totals)
    kernels.reset_launches()
    *ids, counts = kernels.compact_bits(bits, parts)
    torch.cuda.synchronize()
    *want, want_counts = kernels.compact_bits_plain(want_bits, want_parts)
    assert np.array_equal(counts, want_counts)
    for got, exp in zip(ids, want):
        assert torch.equal(got, exp)
    assert kernels.launches["compact_prefix"] == (1 if d.cap else 0)
    assert kernels.launches["compact_bits"] == (1 if sum(map(len, want)) else 0)
    return want


BATCH_N = [0, 1, 3, 5, 31, 33, 2047, 2049, 4097, 1_000_000, 2**20 - 1]


@pytest.fixture(scope="module")
def batch_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    out = {}
    for n in BATCH_N:
        # capacity padding beyond n, and a capacity off a word boundary;
        # the last case is n = cap - 1 at a power-of-two capacity
        cap = n + 1 if n == 2**20 - 1 else max(n + 77, 64)
        out[n] = _data(n, cap, torch.device("cuda"), seed=n)[3]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1, 2, 3, 32, 64])
@pytest.mark.parametrize("n", BATCH_N)
def test_batch_kernels_match_plain(batch_data, n, count):
    """Qp = 1, 2, 3, 32 in one launch; 64 in two (32 queries per
    launch)."""
    d = batch_data[n]
    bq = _batch(count)
    hits, cands = _check_batch(d, bq, -(-count // 32))
    if n == 1_000_000:
        assert len(hits) > 0
    if count == 1:
        # a batch of one through scan_mask_batch is the scalar dense mask
        q = zscan.make_query(*QUERIES[0])
        assert torch.equal(zscan.scan_mask_batch(d, bq)[0],
                           zscan.scan_mask(d, q))


@pytest.mark.gpu
@pytest.mark.parametrize("every_slot", [False, True])
@pytest.mark.parametrize("count", [3, 32, 64])
@pytest.mark.parametrize("n", [5, 2049, 1_000_000])
def test_batch_kernels_own_slots(batch_data, n, count, every_slot):
    """Queries with 1 to 4 boxes, time-free, one or three intervals in
    one launch: the kernel over each query's own slots, and with counts
    that take in every padded slot, equals the plain version."""
    hits, _ = _check_batch(batch_data[n], _mixed_batch(count, seed=count),
                           -(-count // 32), every_slot)
    if n == 1_000_000:
        assert len(hits) > 0


def _boundary_case(device):
    """Rows on the bounds of four boxes: on each bound's hi word with
    the lo word below, equal to and above the bound's lo word, on the hi
    word alone, and at +0.0 and -0.0 against zero bounds (one box has
    bounds at +0.0, one at -0.0); then the queries, each with its own
    box, the last two over two boxes and two intervals."""
    boxes = [(-10.3, 5.7, 20.1, 30.9), (0.0, 0.0, 12.5, 7.25),
             (-0.0, -0.0, 3.0, 3.0), (-3.0, -3.0, -0.0, -0.0)]
    qs = [zscan.make_query([bx], []) for bx in boxes]
    qs.append(zscan.make_query(boxes[:2], [(0, 10 * MS_DAY),
                                           (20 * MS_DAY, 30 * MS_DAY)]))
    qs.append(zscan.make_query(boxes[2:], [(5 * MS_DAY, 5 * MS_DAY),
                                           (6 * MS_DAY, 90 * MS_DAY)]))
    xs, ys = [], []
    for x0, y0, x1, y1 in boxes:
        mid_x, mid_y = (x0 + x1) / 2, (y0 + y1) / 2
        for v, on_x in ((x0, True), (x1, True), (y0, False), (y1, False)):
            hi, lo = zscan.split_two_float(np.float64(v))
            for dlo in (-1, 0, 1, None):
                if dlo is None:
                    pair = (hi, np.float32(0))
                else:
                    pair = (hi, np.nextafter(lo, np.float32(dlo * np.inf))
                            if dlo else lo)
                xs.append(pair if on_x else
                          zscan.split_two_float(np.float64(mid_x)))
                ys.append(zscan.split_two_float(np.float64(mid_y))
                          if on_x else pair)
    for z in (0.0, -0.0):
        for w in (0.0, -0.0, 1.0, -1.0):
            xs += [(np.float32(z), np.float32(0)), (np.float32(w),
                                                    np.float32(0))]
            ys += [(np.float32(w), np.float32(0)), (np.float32(z),
                                                    np.float32(0))]
    n = len(xs)
    reps = 41   # the rows again at every offset of a thread's eight rows
    xy = np.array([[a, b, c, e] for (a, b), (c, e) in zip(xs, ys)],
                  dtype=np.float32)
    xy = np.tile(xy, (reps, 1))
    rng = np.random.default_rng(2)
    days = rng.integers(0, 40, len(xy)).astype(np.int32)
    msd = rng.integers(0, MS_DAY, len(xy)).astype(np.int32)
    msd[::5] = 0
    msd[1::5] = MS_DAY - 1
    data = zscan.scan_data_from_numpy(
        *(np.ascontiguousarray(xy[:, j]) for j in range(4)), days, msd,
        len(xy), device)
    assert n * reps == data.n
    return data, zscan.stack_queries(qs)


@pytest.mark.gpu
def test_batch_kernels_exact_on_bounds(cuda):
    """Rows on each bound's hi word and hi + lo pair, and +-0.0 in bounds
    and coordinates: the bitmaps equal the plain version's bit for bit,
    and every box has candidate rows."""
    d, bq = _boundary_case(cuda)
    hits, cands = _check_batch(d, bq)
    per_query = kernels.compact_bits_plain(
        *kernels.scan_batch_bits_plain(d.cols, d.n, *bq.tables(cuda),
                                       bq.counts(cuda)))[2]
    assert (per_query[1] > 0).all() and (per_query[0] > 0).all()


@pytest.mark.gpu
def test_compact_prefix_past_int32(cuda):
    """Synthetic partials (no bitmaps) whose totals over the queries pass
    2^31: int32 offsets within each query, int64 totals, and the int64
    bases (the prefix of the totals) exact."""
    qp, nb = 64, 32_768
    parts = torch.full((2, qp, nb), 2048, dtype=torch.int32, device=cuda)
    parts[:, :, 7::13] = 5
    parts[1, 3] = 0
    offsets, totals = kernels.compact_prefix(parts)
    want_offsets, want_totals = kernels.compact_prefix_plain(parts.cpu())
    assert torch.equal(offsets.cpu(), want_offsets)
    assert torch.equal(totals.cpu(), want_totals)
    host = parts.cpu().numpy().astype(np.int64)
    assert np.array_equal(totals.cpu().numpy(), host.sum(axis=2))
    bases = np.cumsum(totals.cpu().numpy(), axis=1) - totals.cpu().numpy()
    assert bases[0, -1] > 2**31 and bases[1, -1] > 2**31
    assert np.array_equal(bases, np.cumsum(host.sum(axis=2), axis=1)
                          - host.sum(axis=2))


def _prefix_partials(qp, nb, fill, device, seed=0):
    if fill == "zero":
        return torch.zeros((2, qp, nb), dtype=torch.int32, device=device)
    if fill == "full":
        return torch.full((2, qp, nb), 2048, dtype=torch.int32, device=device)
    rng = np.random.default_rng(seed + qp * 7 + nb)
    parts = rng.integers(0, 2049, (2, qp, nb)).astype(np.int32)
    parts[:, :, rng.random(nb) < 0.5] = 0    # runs of empty blocks
    return torch.from_numpy(parts).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["random", "zero", "full"])
@pytest.mark.parametrize("nb", [1, 4095, 4097, 65536])
@pytest.mark.parametrize("qp", [1, 2, 7, 32])
def test_compact_prefix_lookback_matches_plain(cuda, qp, nb, fill):
    """2 to 64 rows of 1, a tile - 1, a tile + 1 and 16 tiles of
    partials, all zero, all full (2048) and random: offsets and totals
    equal the plain version's, over repeated launches on the same
    scratch (each launch a new epoch and ticket base)."""
    assert kernels.PREFIX_TILE == 4096
    parts = _prefix_partials(qp, nb, fill, cuda)
    want = kernels.compact_prefix_plain(parts)
    for _ in range(3):
        kernels.reset_launches()
        got = kernels.compact_prefix(parts)
        torch.cuda.synchronize()
        assert kernels.launches["compact_prefix"] == 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_compact_prefix_scratch_epochs_and_sizes(cuda):
    """Launches that alternate small and large partials on one scratch,
    a scratch grown mid-sequence, an epoch at its limit (the scratch is
    made anew), a second stream with a scratch of its own, and rows that
    are not 16-byte aligned."""
    shapes = [(32, 65536), (1, 1), (5, 9000), (32, 65536), (64, 70000),
              (2, 4097)]
    for i, (qp, nb) in enumerate(shapes):
        parts = _prefix_partials(qp, nb, "random", cuda, seed=i)
        got = kernels.compact_prefix(parts)
        want = kernels.compact_prefix_plain(parts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    parts = _prefix_partials(3, 20000, "random", cuda, seed=9)
    key = (parts.device, torch.cuda.current_stream(cuda).cuda_stream)
    old = kernels._prefix_scratch[key]
    old.epoch = kernels._PREFIX_EPOCHS - 1
    want = kernels.compact_prefix_plain(parts)
    for _ in range(2):
        got = kernels.compact_prefix(parts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels._prefix_scratch[key] is not old
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        got = kernels.compact_prefix(parts)
    side.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = torch.zeros(2 * 3 * 20000 + 1, dtype=torch.int32, device=cuda)
    off = flat[1:].view(2, 3, 20000)
    off.copy_(parts)
    got = kernels.compact_prefix(off)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [33, 2049, 1_000_000, 2**20 - 1])
def test_compact_empty_and_full_bitmaps(batch_data, n):
    """A query that matches every row (every bit up to n set) and one
    that matches none, and a batch of only the empty one."""
    d = batch_data[n]
    full = zscan.make_query([(-180.0, -90.0, 180.0, 90.0)], [])
    empty = zscan.make_query([(10.0, 10.0, 10.5, 10.5)],
                             [(200 * MS_DAY, 300 * MS_DAY)])
    hits, _ = _check_batch(d, zscan.stack_queries([full, empty, full]))
    assert len(hits) == 2 * d.n
    hits, cands = _check_batch(d, zscan.stack_queries([empty]))
    assert len(hits) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1024, 1030])
def test_batch_kernels_many_queries(batch_data, count):
    """Batches of over a thousand queries: each compaction warp sums a
    query's base from 1024 or more totals."""
    hits, _ = _check_batch(batch_data[2049], _mixed_batch(count, seed=5),
                           -(-count // 32))
    assert len(hits) > 0


@pytest.mark.gpu
def test_store_batched_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(19)
    n = 40_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    ids = [f"f{i}" for i in range(n)]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    qs = ["BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
          "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z",
          "BBOX(geom, -10, -10, 10, 10)",
          "(BBOX(geom, 0, 0, 30, 20) OR BBOX(geom, 100, -50, 140, -10)) AND "
          "dtg DURING 2020-01-05T00:00:00Z/2020-03-01T00:00:00Z"]
    stores[0].query(qs[0], "pts")   # builds the index
    kernels.reset_launches()
    got = stores[0].query_batched([Query("pts", q) for q in qs])
    assert kernels.launches["scan_batch_bits"] == 1
    assert kernels.launches["compact_bits"] == 1
    want = stores[1].query_batched([Query("pts", q) for q in qs])
    for g, w, q in zip(got, want, qs):
        assert "Fused device scan" in g.explain.text
        assert list(g.ids) == list(w.ids) == list(stores[1].query(q, "pts").ids)


@pytest.mark.gpu
def test_serving_planes_on_cuda_match_cpu(cuda):
    """Batched serving through the shared batcher under QoS (three
    weighted tenants) and full tracing on a CUDA store gives the CPU
    store's ids, query for query; every caller's trace holds a dispatch
    and its audit record carries its tenant and principal."""
    import threading
    from geomesa_tpu_torch.audit import AuditLogger, principal_scope
    from geomesa_tpu_torch.obs import tracer
    from geomesa_tpu_torch.obs.trace import TRACE_SAMPLE
    from geomesa_tpu_torch.scan.registry import batcher_registry, shared_batcher
    from geomesa_tpu_torch.tenants import (QOS_ENABLED, tenant_registry,
                                           tenant_scope)
    from geomesa_tpu_torch.utils.properties import SystemProperty
    rng = np.random.default_rng(23)
    n = 60_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    ids = [f"f{i}" for i in range(n)]
    log = AuditLogger()
    stores = [InMemoryDataStore(audit=log), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    qs = [f"BBOX(geom, {-170 + 20 * i}, -40, {-150 + 20 * i}, 40) AND dtg "
          f"DURING 2020-01-{5 + i % 20:02d}T00:00:00Z/2020-03-01T00:00:00Z"
          for i in range(16)]
    weights = [SystemProperty(f"geomesa.qos.tenant.t{k}.weight")
               for k in range(3)]
    QOS_ENABLED.set("true")
    TRACE_SAMPLE.set("1.0")
    for k, w in enumerate(weights):
        w.set(str(4 >> k))
    tracer.clear()
    got = [None] * len(qs)
    try:
        b = shared_batcher(stores[0], max_batch=8, linger_us=20_000)

        def run(i):
            with tenant_scope(f"t{i % 3}"), principal_scope(f"user{i % 3}"):
                got[i] = list(b.query(Query("pts", qs[i])).ids)
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
        traces = tracer.traces(limit=100)
    finally:
        QOS_ENABLED.set(None)
        TRACE_SAMPLE.set(None)
        for w in weights:
            w.set(None)
        tracer.clear()
        tenant_registry.reset()
        batcher_registry.clear()
    for q, g in zip(qs, got):
        assert g == list(stores[1].query(q, "pts").ids)
    assert len(traces) == len(qs)
    assert all("dispatch" in t["kinds"] for t in traces)
    events = log.query("pts")
    assert len(events) == len(qs)
    assert sorted((e.tenant, e.user) for e in events) == sorted(
        (f"t{i % 3}", f"user{i % 3}") for i in range(len(qs)))


@pytest.mark.gpu
def test_runtime_device_memory_matches_memory_stats(cuda):
    """The runtime plane's device sample is the allocator's own numbers
    for each card, taken with nothing allocated or freed between."""
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.obs.runtime import RuntimeCollector
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    rc = RuntimeCollector(registry=MetricsRegistry())
    rc.sample_device_memory()
    stats = torch.cuda.memory_stats(0)
    mem = rc.snapshot()["device_memory"]
    dev = mem["devices"]["cuda:0"]
    assert dev["bytes_in_use"] == stats["allocated_bytes.all.current"] \
        == torch.cuda.memory_allocated(0) > keep.numel() - 1
    assert dev["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"]
    assert mem["live_buffers"] >= 1 and mem["samples"] == 1
    gauges = rc._registry.snapshot()["gauges"]
    assert gauges['runtime.device.bytes{device="cuda:0"}'] == \
        dev["bytes_in_use"]
    del keep


@pytest.mark.gpu
def test_batch_kernels_split_wide_tables(batch_data):
    """Tables past the shared memory of one launch run as several
    launches over query groups, and still equal the plain version."""
    bq = _batch(32, k_boxes=64, intervals=8)
    b, t = bq.tables("cuda")
    group = kernels._batch_group(b, t)
    assert b.numel() * 4 + t.numel() * 4 > kernels.MAX_TABLE_BYTES
    hits, _ = _check_batch(batch_data[1_000_000], bq, -(-32 // group))
    assert len(hits) > 0


@pytest.mark.gpu
def test_batch_kernels_keep_subnormals(cuda):
    _, _, _, d = _data(100_000, 131_072, cuda, seed=3, scale=1e-42)
    bq = zscan.stack_queries([
        zscan.make_query([(-5e-41, -2e-41, 7e-41, 3e-41)], []),
        zscan.make_query([(0.0, 0.0, 2e-41, 2e-41)], [(0, 50 * MS_DAY)])])
    hits, _ = _check_batch(d, bq)
    assert 0 < len(hits) < 2 * d.n


# -- the predicate kernels (csrc/geom.cu, csrc/residual.cu) ------------------

def _star(cx, cy, r1, r2, k):
    a = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
    r = np.where(np.arange(2 * k) % 2 == 0, r1, r2)
    pts = np.c_[cx + r * np.cos(a), cy + r * np.sin(a)]
    pts = np.vstack([pts, pts[:1]])
    return "POLYGON((" + ", ".join(f"{float(x)!r} {float(y)!r}"
                                   for x, y in pts) + "))"


STAR = _star(-20.5, 10.25, 60, 25, 9)
# 2,400 edges: the kernel walks three shared-memory tiles
BIG_STAR = _star(3.0, -4.0, 70, 30, 1200)
HOLED = ("POLYGON((-120 -60, 120 -60, 120 60, -120 60, -120 -60), "
         "(-30 -30, 30 -30, 30 30, -30 30, -30 -30))")
MULTI = ("MULTIPOLYGON(((-100 -50, -20 -50, -20 20, -100 20, -100 -50)), "
         "((20 0, 90 0, 90 70, 20 70, 20 0), (40 20, 60 20, 60 40, 40 40, "
         "40 20)))")
ATTR_SPEC = ("name:String,age:Integer,big:Long,score:Double,flag:Boolean,"
             "dtg:Date,*geom:Point:srid=4326")


def _attr_batch(n, seed=6):
    rng = np.random.default_rng(seed)
    names = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    name = names[rng.integers(0, 40, n)]
    name[::29] = None
    age = rng.integers(0, 100, n).astype(object)
    age[::31] = None
    score = rng.uniform(0, 1, n)
    score[::17] = np.nan
    score[3::23] = 0.25
    score[4::23] = np.nextafter(0.25, 1)
    return FeatureBatch.from_dict(parse_spec("t", ATTR_SPEC),
                                  [f"f{i}" for i in range(n)], {
        "name": name, "age": age, "big": rng.integers(-(2**40), 2**40, n),
        "score": score, "flag": rng.integers(0, 2, n).astype(bool),
        "dtg": 1_609_459_200_000 + rng.integers(0, 300 * MS_DAY, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


RESIDUAL_FILTERS = [
    "name = 'w007'", "name <> 'w007'", "name < 'w010'", "name >= 'w035'",
    "name IN ('w001', 'w002', 'nope')", "name LIKE 'w00%'",
    "name ILIKE 'W01_'", "name IS NULL", "NOT (name = 'w007')",
    "age = 41", "age <> 41.5", "age BETWEEN 19.5 AND 30.5",
    "age IN (" + ", ".join(str(i) for i in range(300)) + ")", "age IS NULL",
    "big > -3", "big <= 1099511627776", "big BETWEEN -5000000000 AND 7",
    "score < 0.25 OR score > 0.9", "score = 0.25", "score <> 0.25",
    "NOT (score >= 0.25)", "score IS NULL", "flag = true", "flag <> 0.5",
    "dtg DURING 2021-03-01T00:00:00Z/2021-04-01T00:00:00Z",
    "dtg BEFORE 2021-02-01T00:00:00Z OR dtg TEQUALS 2021-05-01T00:00:00Z",
    "age > 50 AND name = 'w002' AND score <= 0.5 AND flag = false",
    "EXCLUDE OR (INCLUDE AND big < 0)",
]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 17, 255, 257, 1_000_003])
def test_residual_kernel_matches_plain(cuda, n):
    """Every leaf kind and the band bit, byte for byte against the plain
    version on the same device columns."""
    batch = _attr_batch(n)
    cols = residual.DeviceColumns(batch, cuda)
    for ecql in RESIDUAL_FILTERS:
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        kernels.reset_launches()
        got = prog.run(cols, n)
        torch.cuda.synchronize()
        assert kernels.launches["residual_mask"] == 1
        slots = [cols.get(name)["slot"] for name in prog.slots]
        want = kernels.residual_mask_plain(
            *(torch.from_numpy(a).to(cuda)
              for a in (prog.code, prog.consts, prog.table)), slots, n)
        assert torch.equal(got, want), ecql


@pytest.mark.gpu
@pytest.mark.parametrize("wkt", [STAR, BIG_STAR, HOLED, MULTI])
@pytest.mark.parametrize("n", [1, 257, 300_001])
def test_pip_kernel_matches_plain(cuda, wkt, n):
    """inside and band bit for bit against the plain version, with
    points on vertices and edges among uniform ones."""
    rng = np.random.default_rng(n)
    poly = parse_wkt(wkt)
    px, py = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    on = np.vstack(poly.coords_list())[:n]
    px[:len(on)], py[:len(on)] = on[:, 0], on[:, 1]
    edges = gscan.pack_polygon(poly, cuda).edges
    x32, y32 = (torch.from_numpy(a).to(cuda) for a in gscan.pip_points(px, py))
    kernels.reset_launches()
    got = kernels.pip_mask(x32, y32, edges, gscan.EDGE_EPS2)
    torch.cuda.synchronize()
    assert kernels.launches["pip_mask"] == 1
    want = kernels.pip_mask_plain(x32, y32, edges, gscan.EDGE_EPS2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n > 1000:
        assert 0 < int(got[0].sum()) < n and int(got[1].sum()) > 0


@pytest.mark.gpu
def test_predicate_wrappers_raise_on_cuda(cuda):
    """On CUDA tensors a wrapper launches or raises; it never falls back
    to its plain version."""
    e = gscan.pack_polygon(parse_wkt(STAR), cuda).edges
    x = torch.zeros(8, dtype=torch.float32, device=cuda)
    flat = torch.zeros(4 * 9, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kernels.pip_mask(x, x, flat[1:33].view(8, 4), gscan.EDGE_EPS2)
    with pytest.raises(ValueError, match="devices"):
        kernels.pip_mask(x, x, e.cpu(), gscan.EDGE_EPS2)
    batch = _attr_batch(100)
    cols = residual.DeviceColumns(batch, cuda)
    prog = residual.compile_program(parse_ecql("age > 5"), batch, cols)
    # the program is host data; the columns share one device
    with pytest.raises(ValueError, match="host"):
        kernels.residual_mask(*(torch.from_numpy(a).to(cuda) for a in
                                (prog.code, prog.consts, prog.table)),
                              [cols.get("age")["slot"]], 100)
    age = cols.get("age")["slot"]
    with pytest.raises(ValueError, match="devices"):
        kernels.residual_mask(
            *(torch.from_numpy(a) for a in (prog.code, prog.consts,
                                            prog.table)),
            [(age[0], age[1].cpu(), age[2])], 100)


@pytest.mark.gpu
def test_store_predicates_on_cuda_match_cpu(cuda):
    """The predicate path on the card, through both kernels, equals the
    same store on the CPU id for id."""
    batch = _attr_batch(60_000, seed=11)
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("t", ATTR_SPEC.replace("age:Integer",
                                               "age:Integer:index=true"))
        s.write("t", FeatureBatch(s.get_schema("t"), batch.ids,
                                  batch.columns))
    qs = [f"INTERSECTS(geom, {STAR}) AND dtg DURING "
          f"2021-02-01T00:00:00Z/2021-09-01T00:00:00Z",
          f"WITHIN(geom, {MULTI})", f"INTERSECTS(geom, {HOLED}) AND "
          f"score < 0.5",
          "score = 0.25 OR (name LIKE 'w01%' AND big > -3)",
          "BBOX(geom, -179, -89, 179, 89) AND NOT (name IN ('w001'))",
          "age >= 2", "IN ('f1', 'f77')"]
    kernels.reset_launches()
    for q in qs:
        assert list(stores[0].query(q, "t").ids) == \
            list(stores[1].query(q, "t").ids), q
    assert kernels.launches["pip_mask"] >= 3
    assert kernels.launches["residual_mask"] >= 3


# -- the redesigned predicate kernels: edges of the skip, tails, limits -------

def _adversarial_points(edges, n_random, seed):
    """Points on every vertex and edge midpoint, one ulp either side of
    each edge's expanded box (the kernel's skip margin) beside its ends
    and middle, seeded ones around the edges, and NaN, infinite and huge
    ones."""
    lox, hix, loy, hiy = (t.numpy() for t in kernels.pip_edge_terms_plain(
        torch.from_numpy(edges), gscan.EDGE_EPS2))
    x0, y0, x1, y1 = edges.T
    xs, ys = [x0, x1, (x0 + x1) / 2], [y0, y1, (y0 + y1) / 2]
    px, py = list(xs), list(ys)
    for lo, hi, along, other in ((lox, hix, px, py), (loy, hiy, py, px)):
        for bound, inward in ((lo, np.inf), (hi, -np.inf)):
            for at in (np.nextafter(bound, -inward), bound,
                       np.nextafter(bound, inward)):
                for c in (ys if along is px else xs):
                    along.append(at)
                    other.append(c)
    rng = np.random.default_rng(seed)
    scale = np.abs(edges).max()
    px.append(rng.uniform(-1, 1, n_random) * scale)
    py.append(rng.uniform(-1, 1, n_random) * scale)
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, 3e38, 2.0**61])
    sx, sy = np.meshgrid(special, special)
    px.append(sx.ravel())
    py.append(sy.ravel())
    return (np.concatenate(px).astype(np.float32),
            np.concatenate(py).astype(np.float32))


ODD_EDGES = np.array([[-180.0, 10.0, 180.0, 10.5], [180.0, -3.0, -180.0, -3.0],
                      [5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 0.0, 0.0],
                      [1e-3, 2e-3, 1.0001e-3, 2e-3],
                      [-7.25, 1e-30, -7.25, -1e-30],
                      [-9.0e5, 4.0e5, 1.0e6, -6.0e5]], dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("wkt", [STAR, HOLED, MULTI, "odd", "5000"])
def test_pip_kernel_skip_margins_match_plain(cuda, wkt):
    """inside and band bit for bit against the plain version on points at
    the skip's margins, NaN, ±inf and huge points, horizontal,
    zero-length, 360-degree and 1e6-scale edges, and 5,000 edges (ten
    shared tiles); every n from 1 to past the points of one block, none
    a multiple of the points per thread."""
    if wkt == "odd":
        edges = ODD_EDGES
    elif wkt == "5000":
        edges = gscan.pack_polygon(parse_wkt(_star(1.0, 2.0, 80, 35, 2500)),
                                   "cpu").edges.numpy()
    else:
        edges = gscan.pack_polygon(parse_wkt(wkt), "cpu").edges.numpy()
    px, py = _adversarial_points(edges, 20_000, seed=len(edges))
    e = torch.from_numpy(edges).to(cuda)
    for n in (1, 3, 1023, 1025, 4097, len(px)):
        x = torch.from_numpy(px[-n:].copy()).to(cuda)
        y = torch.from_numpy(py[-n:].copy()).to(cuda)
        got = kernels.pip_mask(x, y, e, gscan.EDGE_EPS2)
        want = kernels.pip_mask_plain(x, y, e, gscan.EDGE_EPS2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n


INF_SPEC = "v:Double,w:Float,dtg:Date,*geom:Point:srid=4326"
INF_FILTERS = ["v = 1e300", "v > 1e299", "v > 1e308", "v < -1e308",
               "w > 3.5e38", "w < -3.5e38", "v = 1e309", "v < 1e309",
               "v >= 1e309", "v <> 1e309", "v > -1e309", "v <= -1e309",
               "w = 1e309", "v IN (1e309, -1e309, 1e300)"]


def _inf_batch(n):
    rng = np.random.default_rng(9)
    v = rng.uniform(-1e3, 1e3, n)
    v[::7], v[1::7] = np.inf, -np.inf
    v[2::11] = np.nan
    v[3::13], v[4::13] = 1e300, -1e300
    v[5::17], v[6::17] = 1e308, 3.5e38
    w = np.round(rng.uniform(-2, 2, n), 2)
    w[::5], w[1::9] = np.inf, -np.inf
    w[2::11] = np.nan
    w[3::7], w[4::7] = 3.6e38, -3.6e38
    return FeatureBatch.from_dict(parse_spec("t", INF_SPEC),
                                  [f"f{i}" for i in range(n)], {
        "v": v, "w": w,
        "dtg": 1_609_459_200_000 + rng.integers(0, 10**9, n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


@pytest.mark.gpu
def test_residual_infinities_on_cuda(cuda):
    """±inf, NaN and values past the f32 range: the kernel equals its
    plain version byte for byte, and the store on the card returns the
    host evaluator's ids (the ±inf repair)."""
    from geomesa_tpu_torch.filters import evaluate
    batch = _inf_batch(20_011)
    cols = residual.DeviceColumns(batch, cuda)
    ds = InMemoryDataStore()
    ds.create_schema("t", INF_SPEC)
    ds.write("t", FeatureBatch(ds.get_schema("t"), batch.ids, batch.columns))
    for ecql in INF_FILTERS:
        f = parse_ecql(ecql)
        prog = residual.compile_program(f, batch, cols)
        got = prog.run(cols, batch.n)
        want = kernels.residual_mask_plain(
            *(torch.from_numpy(a) for a in (prog.code, prog.consts,
                                            prog.table)),
            [cols.get(name)["slot"] for name in prog.slots], batch.n)
        assert torch.equal(got, want), ecql
        truth = evaluate(f, batch)
        assert np.array_equal(residual.device_mask(f, batch, cols), truth)
        assert np.array_equal(ds.query(ecql, "t").rows,
                              np.flatnonzero(truth)), ecql


@pytest.mark.gpu
def test_residual_long_programs_match_plain(cuda):
    """Long programs (an IN of 48 values, 33 thresholds, ten vocab
    tables) and a short one run from device memory, byte for byte as
    the plain version."""
    n = 100_003
    batch = _attr_batch(n)
    cols = residual.DeviceColumns(batch, cuda)
    long_in = "age IN (" + ", ".join(str(i) for i in range(48)) + ")"
    many = " OR ".join(f"score = 0.{i:03d}" for i in range(33))
    tables = " OR ".join(f"name LIKE 'w{i}%'" for i in range(10))
    for ecql in ("age > 5 AND name LIKE 'w0%'", long_in, many, tables):
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        args = [torch.from_numpy(a) for a in (prog.code, prog.consts,
                                              prog.table)]
        slots = [cols.get(name)["slot"] for name in prog.slots]
        got = kernels.residual_mask(*args, slots, n)
        assert torch.equal(got, kernels.residual_mask_plain(*args, slots, n))


@pytest.mark.gpu
def test_residual_refuses_misaligned_columns(cuda):
    """The kernel reads 16-byte vectors: a column view that is not
    16-byte aligned raises; it does not fall back."""
    batch = _attr_batch(1_000)
    cols = residual.DeviceColumns(batch, cuda)
    prog = residual.compile_program(parse_ecql("age > 5"), batch, cols)
    hi, lo, valid = cols.get("age")["slot"]
    shifted = (hi[1:], lo[1:], valid[1:])
    with pytest.raises(ValueError, match="aligned"):
        kernels.residual_mask(*(torch.from_numpy(a) for a in
                                (prog.code, prog.consts, prog.table)),
                              [shifted], 999)


# -- the density kernel --------------------------------------------------------

def _density_inputs(n, bbox, weights, device, seed=0):
    """``n`` seeded points around ``bbox`` (a tenth outside each side,
    some on xmax/ymax, the first ones at +-1e30, +-inf and NaN), a
    mask of about nine in ten, and unit (None), integer or fractional
    weights, as the kernel's tensors on ``device``."""
    rng = np.random.default_rng(seed + n)
    xmin, ymin, xmax, ymax = bbox
    wx, wy = max(xmax - xmin, 1.0), max(ymax - ymin, 1.0)
    x = rng.uniform(xmin - 0.2 * wx, xmax + 0.2 * wx, n)
    y = rng.uniform(ymin - 0.2 * wy, ymax + 0.2 * wy, n)
    x[n // 3:n // 3 + n // 20] = xmax
    y[n // 2:n // 2 + n // 20] = ymax
    special = [1e30, -1e30, np.inf, -np.inf, np.nan]
    x[:min(n, 5)] = special[:min(n, 5)]
    y[5:min(n, 10)] = special[:max(0, min(n, 10) - 5)]
    mask = rng.random(n) < 0.9
    w = {"unit": None,
         "integer": rng.integers(-100, 1000, n).astype(np.float32),
         "fractional": rng.uniform(-3.0, 7.0, n).astype(np.float32)}[weights]
    xt, yt, wt, mt = aggregations.density_upload(x, y, mask, w, device)
    return (xt, yt, wt, mt, *aggregations.density_scalars(
        bbox, 1, 1)[:2])


def _grid_check(got, xt, yt, wt, mt, bbox, width, height, exact):
    """A kernel's grid against the plain version of the same rows
    (point x, y, weights, counted mask, on the card): equal with unit
    weights; with ``exact`` integer weights, equal on every cell whose
    sum |w| is under 2^24 (every partial sum an exact f32 integer); else
    each cell within 2 * n_cell * 2^-24 * sum |w|."""
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    want = kernels.density_grid_plain(xt, yt, wt, mt, xmin, ymin, sx, sy,
                                      width, height)
    if wt is None:
        assert torch.equal(got, want)
        return got
    cells = kernels.density_cells_plain(xt, yt, xmin, ymin, sx, sy, width,
                                        height)[mt]
    n_cell = torch.bincount(cells, minlength=width * height).double()
    abs_w = torch.bincount(cells, wt[mt].abs().double(),
                           minlength=width * height)
    bound = (2 * n_cell * 2.0**-24 * abs_w).view(height, width)
    diff = (got.double() - want.double()).abs()
    if exact:
        small = (abs_w < 2**24).view(height, width)
        assert bool((diff[small] == 0).all())
        bound = torch.where(small, torch.zeros_like(bound), bound)
    assert bool((diff <= bound).all())
    return got


def _density_check(xt, yt, wt, mt, bbox, width, height, exact):
    """The array loader's kernel against its plain version
    (``_grid_check``), launched once."""
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    kernels.reset_launches()
    got = kernels.density_grid(xt, yt, wt, mt, xmin, ymin, sx, sy, width,
                               height)
    torch.cuda.synchronize()
    assert kernels.launches["density_grid"] == (1 if xt.shape[0] else 0)
    return _grid_check(got, xt, yt, wt, mt, bbox, width, height, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["unit", "integer", "fractional"])
@pytest.mark.parametrize("width,height", [(1, 1), (256, 256), (2048, 1024)])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 4097, 1_000_000])
def test_density_kernel_matches_plain(cuda, n, width, height, weights):
    bbox = (-30.0, -20.0, 50.0, 40.0)
    xt, yt, wt, mt, _, _ = _density_inputs(n, bbox, weights, cuda)
    _density_check(xt, yt, wt, mt, bbox, width, height, weights != "fractional")


@pytest.mark.gpu
@pytest.mark.parametrize("bbox", [(3.0, 3.0, 3.0, 3.0), (0.0, 5.0, 0.0, 9.0),
                                  (-1e-3, 7.0, 2e-3, 7.000001),
                                  (-180.0, -90.0, 180.0, 90.0)])
@pytest.mark.parametrize("weights", ["unit", "integer"])
def test_density_kernel_degenerate_and_huge(cuda, bbox, weights):
    """Degenerate bboxes (a scale of 0: inf * 0 is NaN, read as 0), tiny
    ones, and points at +-1e30, +-inf and NaN, exactly."""
    xt, yt, wt, mt, _, _ = _density_inputs(100_003, bbox, weights, cuda, 7)
    _density_check(xt, yt, wt, mt, bbox, 300, 200, True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 1_000_000])
def test_density_kernel_every_row_in_one_cell(cuda, n):
    x = torch.full((n,), 2.5, device=cuda)
    y = torch.full((n,), -1.25, device=cuda)
    m = torch.ones(n, dtype=torch.bool, device=cuda)
    got = _density_check(x, y, None, m, (0, -2, 4, 0), 8, 8, True)
    assert int(got.max().item()) == n


@pytest.mark.gpu
def test_density_wrapper_raises_on_cuda(cuda):
    """Tensors on two devices raise; views at any offset are read as
    they are (the loaders read scalars: no alignment is required)."""
    x = torch.arange(64, dtype=torch.float32, device=cuda) / 16
    m = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        kernels.density_grid(x, x.cpu(), None, m, 0, 0, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="devices"):
        kernels.density_grid(x, x, None, m.cpu(), 0, 0, 1, 1, 4, 4)
    for xs, ms in ((x[1:33], m[:32]), (x[:32], m[1:33])):
        got = kernels.density_grid(xs, x[:32], None, ms, 0, 0, 1, 1, 4, 4)
        assert torch.equal(got, kernels.density_grid_plain(
            xs, x[:32], None, ms, 0, 0, 1, 1, 4, 4))
    ids = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        kernels.density_grid_rows(ids, (x, x, m.cpu()), None, 0, 0, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="int32"):
        kernels.density_grid_rows(ids.long(), (x, x, m), None, 0, 0, 1, 1,
                                  4, 4)


def _rows_store_cols(n, device, seed=0, one_cell=False):
    """DeviceColumns of a seeded batch of ``n`` rows on ``device``:
    points around (-30, -20, 50, 40) with the first ones at +-1e30, +-inf
    and NaN (a NaN point is null), Integer weights, Long weights past
    2^53, Double weights, Boolean weights, each about 5 % null; with
    ``one_cell`` every point at one place."""
    from geomesa_tpu_torch.features.batch import (BoolColumn, NumericColumn,
                                                  PointColumn)
    rng = np.random.default_rng(seed + n)
    x = rng.uniform(-46.0, 66.0, n)
    y = rng.uniform(-32.0, 52.0, n)
    if one_cell:
        x[:], y[:] = 2.5, -1.25
    special = [1e30, -1e30, np.inf, -np.inf, np.nan]
    x[:min(n, 5)] = special[:min(n, 5)]
    y[5:min(n, 10)] = special[:max(0, min(n, 10) - 5)]
    null = lambda: rng.random(n) >= 0.05   # noqa: E731
    sft = parse_spec("d", "wi:Integer,wl:Long,wd:Double,wb:Boolean,"
                     "*geom:Point")
    big = rng.integers(-2**62, 2**62, n)
    big[::3] = rng.integers(-1000, 1000, (n + 2) // 3)
    batch = FeatureBatch(sft, np.arange(n).astype(str).astype(object), {
        "wi": NumericColumn("wi", rng.integers(-100, 1000, n), null()),
        "wl": NumericColumn("wl", big, null()),
        "wd": NumericColumn("wd", rng.uniform(-3.0, 7.0, n), null()),
        "wb": BoolColumn("wb", rng.random(n) < 0.5, null()),
        "geom": PointColumn("geom", x, y, ~(np.isnan(x) | np.isnan(y)))})
    return residual.DeviceColumns(batch, device)


def _rows_check(cols, ids, attr, bbox, width, height, exact):
    """The rows loader's kernel against the plain version of the same
    gathered rows (``_grid_check``)."""
    point = cols.get("geom")["slot"]
    weight = None if attr is None else (cols.get(attr)["kind"],
                                        cols.get(attr)["slot"])
    xmin, ymin, sx, sy = aggregations.density_scalars(bbox, width, height)
    kernels.reset_launches()
    got = kernels.density_grid_rows(ids, point, weight, xmin, ymin, sx, sy,
                                    width, height)
    torch.cuda.synchronize()
    assert kernels.launches["density_grid"] == (1 if ids.shape[0] else 0)
    return _grid_check(got, *kernels.density_rows_gather(ids, point, weight),
                       bbox, width, height, exact)


def _switches(n, weight=None, rows=True):
    """The cell counts where the density kernel's path changes for n
    rows (the plan is monotone in the cells: block, then global)."""
    def path(cells):
        return kernels.density_plan(n, cells, 1, weight, rows)["path"]
    out, lo = [], 1
    hi = 1 << 22
    while path(lo) != path(hi):
        a, b = lo, hi    # path(a) != path(b): bisect to the first change
        while b - a > 1:
            mid = (a + b) // 2
            a, b = (mid, b) if path(mid) == path(a) else (a, mid)
        out.append(b)
        lo = b
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("attr", [None, "wi", "wl", "wd", "wb"])
def test_density_paths_at_their_switches(cuda, attr):
    """Both loaders on grids just below and just above each switch of
    the path (1 x cells grids over 1M rows), and 1x1: every path (global,
    block) runs and equals its plain version (integer weights exactly
    below 2^24 a cell, others within the bound)."""
    n = 1_000_000
    cols = _rows_store_cols(n, cuda)
    ids = torch.from_numpy(np.flatnonzero(
        np.random.default_rng(1).random(n) < 0.9).astype(np.int32)).to(cuda)
    kind = None if attr is None else cols.get(attr)["kind"]
    switches = _switches(ids.shape[0], kind)
    seen = set()
    bbox = (-30.0, -20.0, 50.0, 40.0)
    for cells in sorted({1, *[c - 1 for c in switches], *switches}):
        seen.add(kernels.density_plan(ids.shape[0], cells, 1, kind)["path"])
        _rows_check(cols, ids, attr, bbox, cells, 1, attr in ("wi", "wb"))
        # the same cells as a 2-d grid, where it factors
        if cells % 4 == 0:
            _rows_check(cols, ids, attr, bbox, cells // 4, 4,
                        attr in ("wi", "wb"))
    assert seen == set(kernels.DENSITY_PATHS)
    if attr is None:   # the array loader on the same rows
        point = cols.get("geom")["slot"]
        rows = ids.long()
        xt, yt = point[0][rows].contiguous(), point[1][rows].contiguous()
        mt = point[2][rows].contiguous()
        at = _switches(ids.shape[0], rows=False)
        for cells in sorted({1, *[c - 1 for c in at], *at}):
            _density_check(xt, yt, None, mt, bbox, cells, 1, True)


@pytest.mark.gpu
@pytest.mark.parametrize("width,height", [(1, 1), (64, 32), (256, 256),
                                          (2048, 1024)])
@pytest.mark.parametrize("attr", [None, "wi", "wl", "wd"])
def test_density_rows_every_row_in_one_cell(cuda, attr, width, height):
    """Every point at one place: one cell of a 1x1 grid and a 64x32
    grid (the block path) and of large grids (the global path's warp
    groups)."""
    n = 300_007
    cols = _rows_store_cols(n, cuda, one_cell=True)
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    _rows_check(cols, ids, attr, (0.0, -2.0, 4.0, 0.0), width, height,
                attr == "wi")


@pytest.mark.gpu
def test_density_rows_long_weights_round_through_f64(cuda):
    """A Long weight of 2^60 + 2^36 + 1 rounds to f64 (2^60 + 2^36, a
    tie in f32) and then to f32 (2^60, the even neighbour), as numpy's
    where(valid, v, 0.0).astype(float32) does; one rounding would give
    2^60 + 2^37."""
    from geomesa_tpu_torch.features.batch import NumericColumn, PointColumn
    v = 2**60 + 2**36 + 1
    sft = parse_spec("d", "wl:Long,*geom:Point")
    batch = FeatureBatch(sft, np.array(["a", "b"], dtype=object), {
        "wl": NumericColumn("wl", np.array([v, -v]), np.ones(2, bool)),
        "geom": PointColumn("geom", np.array([0.5, 1.5]), np.array([0.5, 0.5]),
                            np.ones(2, bool))})
    cols = residual.DeviceColumns(batch, cuda)
    got = kernels.density_grid_rows(
        torch.arange(2, dtype=torch.int32, device=cuda),
        cols.get("geom")["slot"], ("i64", cols.get("wl")["slot"]),
        *aggregations.density_scalars((0, 0, 2, 1), 2, 1), 2, 1)
    want = np.float32(np.float64(v))
    assert want == np.float32(2.0**60)
    assert got.cpu().numpy().tolist() == [[want, -want]]


@pytest.mark.gpu
def test_store_density_and_bin_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(13)
    n = 60_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    x[::101] = np.nan
    ms = 1_577_836_800_000 + rng.integers(0, 60 * MS_DAY, n)
    wt = rng.integers(0, 50, n)
    tone = rng.uniform(-10, 10, n)
    tone[::37] = np.nan
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "code:String,wt:Integer,tone:Double,"
                        "dtg:Date,*geom:Point:srid=4326")
        s.write_dict("pts", [f"f{i}" for i in range(n)], {
            "code": [f"c{i % 23}" for i in range(n)], "wt": wt, "tone": tone,
            "dtg": ms, "geom": (x, y)})
    ecql = ("BBOX(geom, -100, -50, 60, 70) AND dtg DURING "
            "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z")
    for attr in (None, "wt"):
        kernels.reset_launches()
        got = stores[0].density("pts", ecql, (-100, -50, 60, 70), 640, 480,
                                attr)
        assert kernels.launches["density_grid"] == 1
        assert np.array_equal(got, stores[1].density(
            "pts", ecql, (-100, -50, 60, 70), 640, 480, attr))
    got = stores[0].density("pts", "INCLUDE", (-180, -90, 180, 90), 37, 19,
                            "tone")
    want = stores[1].density("pts", "INCLUDE", (-180, -90, 180, 90), 37, 19,
                             "tone")
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= 2 * n * 2.0**-24 * np.nansum(np.abs(tone)))
    for kw in ({}, {"sort": True, "label": "code"}):
        assert stores[0].bin_query("pts", ecql, **kw) == stores[1].bin_query(
            "pts", ecql, **kw)


@pytest.mark.gpu
def test_store_residual_after_delete_on_cuda(cuda):
    """The residual kernel's prepared launches are keyed on column
    pointers; after a delete, and after remove_schema + create_schema of
    the same name, the columns are uploaded again (possibly at the same
    addresses). The CUDA store still answers as the CPU store does."""
    ecqls = ["BBOX(geom, -170, -80, 170, 80) AND age > 30",
             "age >= 10 AND score < 0.5 AND name LIKE 'w0%'"]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema(parse_spec("t", ATTR_SPEC))
        s.write("t", _attr_batch(50_000))

    def same():
        for e in ecqls:
            kernels.reset_launches()
            got = stores[0].query(e, "t")
            assert kernels.launches["residual_mask"] >= 1
            assert list(got.ids) == list(stores[1].query(e, "t").ids)
    same()
    for s in stores:
        s.delete("t", [f"f{i}" for i in range(0, 50_000, 7)])
    same()
    for s in stores:
        s.remove_schema("t")
        s.create_schema(parse_spec("t", ATTR_SPEC))
        s.write("t", _attr_batch(50_000, seed=8))
    same()


@pytest.mark.gpu
def test_store_stats_and_arrow_on_cuda_match_cpu(cuda):
    """The stats registry, the stats-based plans, stats_query,
    query_stream, analyze and arrow_ipc of a store on the card equal the
    same store's on the CPU (exact)."""
    spec = ATTR_SPEC.replace("name:String", "name:String:index=true")
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema(parse_spec("t", spec))
        for lo, hi in ((0, 30_000), (30_000, 80_000)):
            b = _attr_batch(80_000).take(np.arange(lo, hi))
            s.write("t", FeatureBatch(s.get_schema("t"), b.ids, b.columns))
    ecqls = ["INCLUDE", "name = 'w007' AND BBOX(geom, -10, -10, 10, 10)",
             "name = 'w007' AND dtg DURING 2021-02-01T00:00:00Z/"
             "2021-03-01T00:00:00Z",
             "BBOX(geom, -170, -80, 170, 80) AND dtg DURING "
             "2021-02-01T00:00:00Z/2021-09-01T00:00:00Z"]

    def same():
        kernels.reset_launches()
        for e in ecqls:
            got, want = stores[0].query(e, "t"), stores[1].query(e, "t")
            assert (got.plan.index, got.plan.cost) == (want.plan.index,
                                                       want.plan.cost), e
            assert list(got.ids) == list(want.ids), e
            for st in ("Count();MinMax(age);Enumeration(name)",
                       "DescriptiveStats(score)",
                       "Z3Histogram(geom,dtg,week,1024)"):
                assert stores[0].stats_query("t", st, e).to_json() == \
                    stores[1].stats_query("t", st, e).to_json()
            assert [list(w.ids) for w in stores[0].query_stream(
                e, "t", batch_rows=5_000)] == [list(w.ids) for w in stores[
                    1].query_stream(e, "t", batch_rows=5_000)]
        assert kernels.launches["scan_mask"] >= 1
    same()
    for s in stores:
        s.delete("t", [f"f{i}" for i in range(0, 80_000, 5)])
    same()
    assert [s.analyze("t").count.count for s in stores] == [64_000] * 2
    same()
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return
    for e in ecqls:
        assert stores[0].arrow_ipc("t", e, sort_by="age") == \
            stores[1].arrow_ipc("t", e, sort_by="age")


# -- the extent tristate (csrc/extent.cu) ------------------------------------

def extent_cases(n, seed=0):
    """(bounds f64 (n, 4), millis) with the tristate's edge cases: NaN
    (null) rows, boxes on and across the queries' f64 edges (which have
    no exact f32), boxes thinner than an f32 ulp, pre-1970 millis and
    millis on day boundaries."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 20, (n, 2))
    half = 10.0 ** rng.uniform(-7, 0.5, (n, 2))
    b = np.concatenate([c - half, c + half], axis=1)
    edges = np.array([0.1, 1 / 3, -2.7, 5.000000001, -7.3])
    k = rng.integers(0, len(edges), (n, 4))
    on = rng.random((n, 4)) < 0.15
    b = np.where(on, edges[k], b)
    b[:, [0, 2]] = np.sort(b[:, [0, 2]], axis=1)
    b[:, [1, 3]] = np.sort(b[:, [1, 3]], axis=1)
    b[rng.random(n) < 0.05] = np.nan
    ms = rng.integers(-40 * MS_DAY, 40 * MS_DAY, n)
    ms[rng.random(n) < 0.1] = rng.integers(-40, 40, n)[:1] * MS_DAY
    ms[rng.random(n) < 0.05] = -1
    return b, ms


# (boxes, intervals): single boxes on the data's edges, an inverted inner
# box (thinner than an f32 ulp), 64 boxes, 16 intervals, day-boundary
# intervals, the whole world with intervals, no boxes
EXTENT_QUERIES = [
    ([(0.1, 1 / 3, 5.000000001, 7.3)], [(-3 * MS_DAY, 5 * MS_DAY - 1)]),
    ([(-2.7, -7.3, 0.1, 1 / 3)], []),
    ([(0.1, 0.1, 0.1 + 1e-9, 0.1 + 1e-9)], [(-MS_DAY, -1)]),
    ([(x, y, x + 3.3, y + 2.1) for x in np.linspace(-20, 16, 8)
      for y in np.linspace(-20, 16, 8)],
     [(d * 5 * MS_DAY, d * 5 * MS_DAY + 2 * MS_DAY) for d in range(-8, 8)]),
    ([(-180.0, -90.0, 180.0, 90.0)], [(0, 0), (-40 * MS_DAY, -39 * MS_DAY)]),
    ([], [(0, 10 * MS_DAY)]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("with_times", [True, False])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_extent_tristate_matches_plain(cuda, n, with_times):
    """The kernel equals its plain version (torch.equal) on the edge
    cases, at row counts that are not a multiple of the block."""
    b, ms = extent_cases(n, seed=n)
    data = gscan.build_extent_data(b, ms if with_times else None, cuda)
    kernels.reset_launches()
    for boxes, intervals in EXTENT_QUERIES:
        o, i, t = gscan.extent_query(boxes, intervals).tables(cuda)
        got = kernels.extent_tristate(data.bounds, data.valid, data.times,
                                      o, i, t)
        want = kernels.extent_tristate_plain(data.bounds, data.valid,
                                             data.times, o, i, t)
        assert torch.equal(got, want), (boxes[:1], intervals[:1])
    assert kernels.launches["extent_tristate"] == len(EXTENT_QUERIES)


@pytest.mark.gpu
def test_extent_tristate_raises_on_cuda(cuda):
    """On CUDA tensors the wrapper launches or raises: a misaligned
    column, or query tables on another device, raise."""
    b, ms = extent_cases(64)
    data = gscan.build_extent_data(b, ms, cuda)
    o, i, t = gscan.extent_query(*EXTENT_QUERIES[0]).tables(cuda)
    flat = torch.zeros(4 * 65, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kernels.extent_tristate(flat[1:257].view(64, 4), data.valid,
                                data.times, o, i, t)
    words = torch.zeros(2 * 65, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        kernels.extent_tristate(data.bounds, data.valid,
                                words[1:129].view(64, 2), o, i, t)
    with pytest.raises(ValueError, match="devices"):
        kernels.extent_tristate(data.bounds, data.valid, data.times,
                                o.cpu(), i.cpu(), t.cpu())


@pytest.mark.gpu
def test_extent_store_on_cuda_matches_cpu(cuda, monkeypatch):
    """An extent store answers through the tristate kernel on the card,
    id for id with the same store on the CPU."""
    from geomesa_tpu_torch.geometry import LineString, Polygon
    monkeypatch.setenv("GEOMESA_SCAN_EXTENT_HOST_ROWS", "0")
    rng = np.random.default_rng(5)
    n = 20_000
    c = rng.uniform(-10, 10, (n, 2))
    w = rng.uniform(0.001, 0.2, (n, 1))
    geoms = [Polygon([p - w[j], (p[0] + w[j, 0], p[1] - w[j, 0]), p + w[j],
                      (p[0] - w[j, 0], p[1] + w[j, 0]), p - w[j]])
             if j % 3 else LineString([p, p + w[j] * (1, 2), p + w[j] * 3])
             for j, p in enumerate(c)]
    geoms[7] = None
    ms = rng.integers(0, 60 * MS_DAY, n)
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("t", "name:String,dtg:Date,*geom:Geometry:srid=4326")
        s.write("t", FeatureBatch.from_dict(
            s.get_schema("t"), [f"g{j}" for j in range(n)],
            {"name": ["a"] * n, "dtg": ms.astype("datetime64[ms]"),
             "geom": geoms}))
    qs = ["BBOX(geom, -2, -2, 3.1, 3.3)",
          "BBOX(geom, -2, -2, 3, 3) AND dtg DURING "
          "1970-01-10T00:00:00Z/1970-02-01T00:00:00Z",
          "INTERSECTS(geom, POLYGON((-5 -5, 5 -4, 6 6, -4 5, -5 -5)))",
          "DWITHIN(geom, POINT(1 1), 50, kilometers)",
          "CROSSES(geom, LINESTRING(-10 0.5, 10 0.7))",
          "dtg DURING 1970-01-10T00:00:00Z/1970-01-20T00:00:00Z"]
    kernels.reset_launches()
    for q in qs:
        got, want = stores[0].query(q, "t"), stores[1].query(q, "t")
        assert got.plan.index == want.plan.index, q
        assert list(got.ids) == list(want.ids), q
    assert kernels.launches["extent_tristate"] == len(qs)


# -- the join kernels (csrc/join.cu) -----------------------------------------

def _join_points(n, cap, device, seed=0, scale=(180.0, 90.0)):
    """(x64, y64, px, py): n seeded points (duplicates for ties) and their
    f32 columns on ``device`` with cap - n padding rows at the origin."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-scale[0], scale[0], n)
    y = rng.uniform(-scale[1], scale[1], n)
    dup = min(200, n // 4)
    x[n - dup:], y[n - dup:] = x[:dup], y[:dup]
    px = torch.zeros(cap, dtype=torch.float32, device=device)
    py = torch.zeros(cap, dtype=torch.float32, device=device)
    px[:n] = torch.from_numpy(x.astype(np.float32))
    py[:n] = torch.from_numpy(y.astype(np.float32))
    return x, y, px, py


def _same_f32(a, b) -> bool:
    """Equal bit for bit, every NaN equal to every NaN."""
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [0.25, 7.0])
@pytest.mark.parametrize("n,cap,k", [(1, 1, 1), (1000, 1024, 1),
                                     (300_001, 524_288, 1000),
                                     (1_000_000, 1_048_576, 37),
                                     (50_000, 65_536, 2049)])
def test_dwithin_counts_kernel_matches_plain(cuda, n, cap, k, radius):
    from geomesa_tpu_torch.utils.fp import f32_band
    x, y, px, py = _join_points(n, cap, cuda, seed=k)
    rng = np.random.default_rng(n)
    qx = rng.uniform(-170, 170, k).astype(np.float32)
    qy = rng.uniform(-80, 80, k).astype(np.float32)
    qx[0], qy[0] = x[0] + radius, y[0]   # a row on the threshold
    hi, lo = (float(np.float32(v)) for v in f32_band(radius, 360.0))
    args = (px, py, torch.from_numpy(qx).to(cuda),
            torch.from_numpy(qy).to(cuda), hi, lo, n)
    kernels.reset_launches()
    got = kernels.dwithin_counts(*args)
    want = kernels.dwithin_counts_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches["dwithin_counts"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _adversarial_join_case(n, cap, radius, k, device, seed=0):
    """f32 rows and queries for the dwithin kernel: rows near and at
    |x| = 180, at |x| = 1e6, NaN and +-inf coordinates, capacity padding
    at the origin; queries r away from rows (the band's edges), near 180
    and at 1e6, NaN and +-inf, one far outside the table."""
    rng = np.random.default_rng(seed)
    x = np.zeros(cap, np.float32)
    y = np.zeros(cap, np.float32)
    x[:n], y[:n] = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    x[:40] = np.float32(180.0) - rng.uniform(0, 1e-4, 40).astype(np.float32)
    x[40:60], x[60:70], x[70:80] = -180.0, 1e6, -1e6
    x[80:85], y[85:90] = np.nan, np.nan
    x[90:93], x[93:96], y[96:99] = np.inf, -np.inf, np.inf
    qx = rng.uniform(-170, 170, k).astype(np.float32)
    qy = rng.uniform(-80, 80, k).astype(np.float32)
    r = np.float32(radius)
    qx[0:4], qy[0:4] = x[200:204] + r, y[200:204]
    qx[4:8], qy[4:8] = x[204:208] - r, y[204:208]
    qx[8], qy[8] = np.float32(179.99), x[20]
    qx[9], qy[9] = x[60], y[60]
    qx[10], qx[11], qx[12], qy[13] = np.nan, np.inf, -np.inf, np.nan
    qx[14] = 5e3
    return [torch.from_numpy(a).to(device) for a in (x, y, qx, qy)]


@pytest.mark.gpu
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("radius", [0.0, 1e-6, 0.25, 90.0, 400.0])
@pytest.mark.parametrize("n,cap,k", [(6_000, 6_144, 48),
                                     (300_001, 524_288, 1500)])
def test_dwithin_counts_kernel_adversarial(cuda, n, cap, k, radius,
                                           presorted):
    """The tile walk on adversarial rows and queries, the x-sort done by
    the wrapper or passed in, equal to the all-pairs plain version."""
    from geomesa_tpu_torch.utils.fp import f32_band
    px, py, qx, qy = _adversarial_join_case(n, cap, radius, k, cuda, seed=k)
    hi, lo = (float(np.float32(v)) for v in f32_band(radius, 360.0))
    xsorted = kernels.sorted_by_x(px, py, n)[:2] if presorted else None
    kernels.reset_launches()
    got = kernels.dwithin_counts(px, py, qx, qy, hi, lo, n, xsorted)
    want = kernels.dwithin_counts_plain(px, py, qx, qy, hi, lo, n)
    torch.cuda.synchronize()
    assert kernels.launches["dwithin_counts"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[0].sum() + want[1].sum()) > 0


@pytest.mark.gpu
def test_dwithin_counts_kernel_wide_radius(cuda):
    """A wide radius (30 degrees: each slab about a sixth of the table)
    and one past the world (every slab the whole table)."""
    from geomesa_tpu_torch.utils.fp import f32_band
    _, _, px, py = _join_points(1_000_000, 1_048_576, cuda, seed=14)
    rng = np.random.default_rng(14)
    qx = torch.from_numpy(rng.uniform(-170, 170, 64).astype(np.float32))
    qy = torch.from_numpy(rng.uniform(-80, 80, 64).astype(np.float32))
    for radius in (30.0, 200.0):
        hi, lo = (float(np.float32(v)) for v in f32_band(radius, 360.0))
        args = (px, py, qx.to(cuda), qy.to(cuda), hi, lo, 1_000_000)
        got = kernels.dwithin_counts(*args)
        want = kernels.dwithin_counts_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _slabs(xs, centres, halves):
    from geomesa_tpu_torch.analytics.join import _slab_bounds
    return _slab_bounds(xs, centres.astype(np.float32),
                        halves.astype(np.float32))[:2]


@pytest.mark.gpu
@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("n,cap,k,odd", [(1, 1, 1, False),
                                         (10_000, 16_384, 3, False),
                                         (1_000_000, 1_048_576, 1000, False),
                                         (2_000_000, 2_097_152, 1000, True),
                                         (300_001, 524_288, 600, True)])
def test_slab_pairs_kernel_matches_plain(cuda, box, n, cap, k, odd):
    """The slab kernels' pairs against the plain version; ``odd``: NaN
    and +-inf rows, an empty slab and one that is the whole table, and
    slabs 200 degrees wide around small tests (overlapping, so tiles
    list more queries than a block takes); two launches a call (one
    where nothing matches, none where no slab meets a tile)."""
    from geomesa_tpu_torch.analytics.join import _sorted_by_x
    from geomesa_tpu_torch.utils.fp import f32_band
    _, _, px, py = _join_points(n, cap, cuda, seed=3)
    if odd:
        odd_vals = torch.tensor([np.nan, np.inf, -np.inf], device=cuda)
        px[:3], py[3:6], px[6:9] = odd_vals, odd_vals, float("nan")
    xs, ys, order = _sorted_by_x(px, py, n)
    rng = np.random.default_rng(k)
    cx, cy = rng.uniform(-170, 170, k), rng.uniform(-80, 80, k)
    if box:
        h = rng.uniform(0.0, 2.0, k)
        h[-1] = 0.0   # an empty slab
        b = np.stack([cx - h, cy - h / 2, cx + h, cy + h / 2], axis=1)
        los, widths = _slabs(xs, (b[:, 0] + b[:, 2]) / 2,
                             np.full(k, 100.0) if odd else h + 2e-4)
        qa, r2, eps = torch.from_numpy(b.astype(np.float32)), 0.0, 1e-4
    else:
        los, widths = _slabs(xs, cx, np.full(k, 100.0 if odd else 0.3))
        qa = torch.from_numpy(np.stack([cx, cy], 1).astype(np.float32))
        r2, eps = float(np.float32(f32_band(0.25, 360.0)[0])), 0.0
    if odd:
        widths[0] = 0
        los[1], widths[1] = 0, cap
        assert kernels.tile_lists(los, widths, cap).most > kernels.SLAB_GROUP
    args = (xs, ys, order, los, widths, qa.to(cuda), r2,
            float(np.float32(eps)), box)
    kernels.reset_launches()
    got = kernels.slab_pairs(*args)
    want = kernels.slab_pairs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    listed = kernels.tile_lists(los, widths, cap).total
    assert kernels.launches["slab_pairs"] == (
        0 if not listed else 2 if len(want[0]) else 1)


def _contains_case(cuda, n, cap, wkts, on_edges=0, odd_rows=False,
                   scale=(180.0, 90.0)):
    from geomesa_tpu_torch.analytics.join import (_contains_slab_setup,
                                                  _sorted_by_x,
                                                  pack_polygon_batch)
    x, y, px, py = _join_points(n, cap, cuda, seed=5, scale=scale)
    if odd_rows:   # rows with NaN and infinite coordinates
        odd = torch.tensor([np.nan, np.inf, -np.inf], device=cuda)
        px[on_edges:on_edges + 3] = odd
        py[on_edges + 3:on_edges + 6] = odd
    polys = [parse_wkt(w) for w in wkts]
    if on_edges:   # points on the first polygon's first edge: the band
        e = np.asarray(polys[0].shell if hasattr(polys[0], "shell")
                       else polys[0].parts[0].shell)
        t = np.linspace(0, 1, on_edges)
        ex = e[0, 0] + t * (e[1, 0] - e[0, 0])
        ey = e[0, 1] + t * (e[1, 1] - e[0, 1])
        px[:on_edges] = torch.from_numpy(ex.astype(np.float32)).to(cuda)
        py[:on_edges] = torch.from_numpy(ey.astype(np.float32)).to(cuda)
    xs, ys, order = _sorted_by_x(px, py, n)
    b64 = np.array([p.envelope.as_tuple() for p in polys])
    los, widths, _, _ = _contains_slab_setup(xs, b64)
    edges, evalid, boxes = pack_polygon_batch(polys)
    return (xs, ys, order, los, widths, torch.from_numpy(boxes).to(cuda),
            torch.from_numpy(edges).to(cuda),
            torch.from_numpy(evalid.sum(1).astype(np.int32)).to(cuda))


CONTAINS_WKTS = [STAR, HOLED, MULTI, BIG_STAR,
                 "POLYGON((10 10, 10.3 10, 10.3 10.2, 10 10.2, 10 10))",
                 "POLYGON((200 200, 201 200, 201 201, 200 201, 200 200))"]


@pytest.mark.gpu
@pytest.mark.parametrize("band_cap", [256, 3])
@pytest.mark.parametrize("n,cap", [(1, 1), (300_001, 524_288),
                                   (2_000_000, 2_097_152)])
def test_contains_counts_kernel_matches_plain(cuda, n, cap, band_cap):
    """Counts and the first band rows of each polygon: a star, holes, a
    multipolygon, 2,400 edges (more than one shared-memory tile), a
    small rectangle, one outside the data; points on an edge."""
    tables = _contains_case(cuda, n, cap, CONTAINS_WKTS,
                            on_edges=min(n, 600))
    eps, eps2 = float(np.float32(gscan.EDGE_EPS)), gscan.EDGE_EPS2
    kernels.reset_launches()
    got = kernels.contains_counts(*tables, eps, eps2, band_cap)
    want = kernels.contains_counts_plain(*tables, eps, eps2, band_cap)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if n > 1:
        assert int(want[1][0]) > band_cap   # the band overflows the cap
        assert kernels.launches["contains_counts"] == 2
        polys = list(range(len(CONTAINS_WKTS)))
        rows = kernels.contains_band_rows(*tables, eps, eps2, polys, 1024)
        assert torch.equal(rows, kernels.contains_band_rows_plain(
            *tables, eps, eps2, polys, 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("band_cap", [256, 3])
def test_contains_counts_kernel_adversarial(cuda, band_cap):
    """A polygon whose slab is the whole table, one with an empty slab,
    NaN and infinite rows, points on edges: the counts pass, the rows
    pass and contains_band_rows equal their plain versions."""
    whole = "POLYGON((-200 -100, 200 -100, 200 100, -200 100, -200 -100))"
    wkts = CONTAINS_WKTS + [whole]
    tables = _contains_case(cuda, 300_001, 524_288, wkts, on_edges=600,
                            odd_rows=True)
    assert int(tables[4][-1]) == 300_001 - 3 and int(tables[4][5]) == 0
    eps, eps2 = float(np.float32(gscan.EDGE_EPS)), gscan.EDGE_EPS2
    kernels.reset_launches()
    got = kernels.contains_counts(*tables, eps, eps2, band_cap)
    want = kernels.contains_counts_plain(*tables, eps, eps2, band_cap)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launches["contains_counts"] == 2
    polys = [0, len(wkts) - 1, 3]
    rows = kernels.contains_band_rows(*tables, eps, eps2, polys, 2048)
    assert torch.equal(rows, kernels.contains_band_rows_plain(
        *tables, eps, eps2, polys, 2048))


@pytest.mark.gpu
@pytest.mark.parametrize("kpolys", [700, 1300])
def test_contains_counts_kernel_long_lists(cuda, kpolys):
    """Thin rectangles stacked over one x range, so each tile lists
    hundreds of polygons (a block stages them 256 at a time) or more
    than a block takes (1,024: two blocks a tile)."""
    rng = np.random.default_rng(kpolys)
    wkts = [f"POLYGON(({cx - w} {cy - 0.05}, {cx + w} {cy - 0.05}, "
            f"{cx + w} {cy + 0.05}, {cx - w} {cy + 0.05}, "
            f"{cx - w} {cy - 0.05}))"
            for cx, w, cy in zip(rng.uniform(-1, 1, kpolys),
                                 rng.uniform(0.5, 2, kpolys),
                                 np.linspace(-78, 78, kpolys))]
    tables = _contains_case(cuda, 20_000, 32_768, wkts, scale=(3.0, 80.0))
    assert kernels.tile_lists(tables[3], tables[4], 32_768).most > 256
    eps, eps2 = float(np.float32(gscan.EDGE_EPS)), gscan.EDGE_EPS2
    got = kernels.contains_counts(*tables, eps, eps2, 8)
    want = kernels.contains_counts_plain(*tables, eps, eps2, 8)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[0].sum()) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("n,cap,nq,kpad,layout", [
    (1, 1, 1, 1, ""), (100, 128, 1, 128, ""), (2_500, 3_000, 2, 3_000, ""),
    (3_000, 4_096, 3, 4_096, ""), (1_000_000, 1_048_576, 8, 256, ""),
    (50_000, 65_536, 32, 8_192, ""), (2_000_000, 2_097_152, 2, 64, ""),
    (2_000_000, 2_097_152, 32, 256, "x"), (2_000_000, 2_000_000, 1, 256,
                                            "far"),
    (1_000_000, 1_048_576, 64, 128, ""), (500_000, 524_288, 9, 64, "equal"),
    (1_000_000, 1_048_576, 8, 1, "nan"), (300_000, 300_000, 2, 8_192, "x")])
def test_knn_kernel_matches_plain(cuda, n, cap, nq, kpad, layout):
    """The window of each query: ties (duplicated points), capacity rows
    at +inf (the tail when kpad > n), NaN rows last; rows sorted by x
    and by distance from the first query (farthest first), every row on
    one point, a NaN query; 1 to 64 queries (several groups), kpad 1 to
    8,192; the launches of the call's plan."""
    _, _, px, py = _join_points(n, cap, cuda, seed=nq)
    if n > 10:
        px[3:6] = float("nan")
    rng = np.random.default_rng(kpad)
    qx = torch.from_numpy(rng.uniform(-170, 170, nq).astype(np.float32))
    qy = torch.from_numpy(rng.uniform(-80, 80, nq).astype(np.float32))
    qx[0], qy[0] = px[0].cpu(), py[0].cpu()
    if layout == "x":
        o = torch.sort(px[:n], stable=True).indices
        px[:n], py[:n] = px[:n][o].clone(), py[:n][o].clone()
    elif layout == "far":
        d2 = (px[:n] - qx[0].item()) ** 2 + (py[:n] - qy[0].item()) ** 2
        o = torch.sort(d2, descending=True, stable=True).indices
        px[:n], py[:n] = px[:n][o].clone(), py[:n][o].clone()
    elif layout == "equal":
        px[:n], py[:n] = 3.5, -1.25
    elif layout == "nan":
        qx[0] = float("nan")
    args = (px, py, qx.to(cuda), qy.to(cuda), kpad, n)
    kernels.reset_launches()
    got = kernels.knn_topk(*args)
    want = kernels.knn_topk_plain(*args)
    torch.cuda.synchronize()
    assert _same_f32(got[0], want[0]) and torch.equal(got[1], want[1])
    plan = kernels.knn_plan(min(cap, n + kpad), nq, kpad)
    assert kernels.launches["knn_topk"] == plan["launches"] == 3


@pytest.mark.gpu
def test_join_wrappers_raise_on_cuda(cuda):
    _, _, px, py = _join_points(1000, 1024, cuda)
    q = torch.zeros(1, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="kpad"):
        kernels.knn_topk(px, py, q, q, 16_384, 1000)
    with pytest.raises(ValueError):
        kernels.dwithin_counts(px, py, q, q.cpu(), 1.0, 0.5, 1000)
    tables = _contains_case(cuda, 1000, 1024, [STAR])
    bad = list(tables)
    bad[6] = torch.zeros(8 * 4 + 1, dtype=torch.float32,
                         device=cuda)[1:].view(1, 8, 4)
    bad[7] = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.contains_counts(*bad, 1e-4, 1e-8, 4)


@pytest.mark.gpu
def test_analytics_on_cuda_match_cpu(cuda):
    """The processes and QueryBatcher.knn on a CUDA store equal a CPU
    store's, id for id."""
    from geomesa_tpu_torch.analytics import processes
    from geomesa_tpu_torch.scan.batcher import QueryBatcher
    rng = np.random.default_rng(12)
    n = 200_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    x[:100], y[:100] = x[100:200], y[100:200]
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("pts", "kind:String,*geom:Point:srid=4326")
        s.write_dict("pts", [f"p{i}" for i in range(n)],
                     {"kind": [f"k{i % 3}" for i in range(n)],
                      "geom": (x, y)})
    polys = [parse_wkt(STAR), parse_wkt(HOLED)]
    qx, qy = rng.uniform(-170, 170, 8), rng.uniform(-80, 80, 8)
    kernels.reset_launches()
    out = []
    for s in stores:
        r = [processes.knn_process(s, "pts", 1.0, 2.0, 50),
             processes.knn_process(s, "pts", qx, qy, 100),
             processes.knn_process(s, "pts", 1.0, 2.0, 20, ecql="kind = 'k1'"),
             processes.proximity_process(s, "pts", qx, qy, 2.0),
             processes.proximity_process(s, "pts", qx, qy, 2.0,
                                         counts_only=True),
             processes.contains_process(s, "pts", polys),
             processes.contains_process(s, "pts", polys, counts_only=False),
             QueryBatcher(s, max_batch=8).knn("pts", -3.0, 4.0, 10)]
        out.append(r)
    for a, b in zip(*out):
        a = a if isinstance(a, list) else [a]
        b = b if isinstance(b, list) else [b]
        for u, v in zip(a, b):
            for p, q in zip(u, v):
                if isinstance(p, list):
                    assert all(np.array_equal(i, j) for i, j in zip(p, q))
                else:
                    assert (p is None and q is None) or np.array_equal(p, q)
    assert all(kernels.launches[k] > 0 for k in
               ("dwithin_counts", "slab_pairs", "contains_counts",
                "knn_topk"))


@pytest.mark.gpu
def test_geometry_less_and_versioned_stores_on_cuda_match_cpu(cuda):
    """A schema without a geometry (its dense fullscan residual through
    residual_mask) and a version-1 point schema before and after
    reindex, on a CUDA store and a CPU store, id for id."""
    rng = np.random.default_rng(14)
    n = 300_000
    ids = [f"e{i}" for i in range(n)]
    plain = {"name": [f"n{i}" for i in rng.integers(0, 40, n)],
             "age": rng.integers(0, 90, n), "score": rng.uniform(0, 1, n)}
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = rng.integers(0, 30 * MS_DAY, n) + 1_500_000_000_000
    stores = [InMemoryDataStore(), InMemoryDataStore(device="cpu")]
    for s in stores:
        s.create_schema("ev", "name:String:index=true,age:Integer,"
                              "score:Double")
        s.write_dict("ev", ids, plain)
        s.create_schema("pts", "dtg:Date,*geom:Point:srid=4326;"
                               "geomesa.index.version='1'")
        s.write_dict("pts", ids, {"dtg": ms, "geom": (x, y)})
    kernels.reset_launches()
    plain_q = ["score > 0.3", "name = 'n7'", "IN ('e1', 'e99')",
               "age < 5 OR score > 0.99"]
    point_q = ["BBOX(geom, -30, -30, 30, 30) AND dtg DURING "
               "2017-07-15T00:00:00Z/2017-07-25T00:00:00Z",
               "BBOX(geom, 100, -50, 140, -10)"]
    for reindexed in (False, True):
        for tn, qs in (("ev", plain_q), ("pts", point_q)):
            for q in qs:
                got, want = (s.query(q, tn) for s in stores)
                assert got.plan.index == want.plan.index
                assert np.array_equal(got.ids, want.ids)
        for s in stores:
            s.reindex("pts")
    assert kernels.launches["residual_mask"] >= 1
    assert stores[0]._state("pts").zindex.version == 2


# -- standing filters (csrc/standing.cu) ---------------------------------------

def _standing_case(f, k, a, chunk, n_valid, device, seed=0):
    """Seeded rows and tables for one standing launch: rows with NaN
    coordinates and attributes, pre-1970 days, rows sitting on box
    bounds' hi words; slots dead, box_any, with invalid boxes and with
    catch-all times."""
    rng = np.random.default_rng(seed)
    xhi = rng.uniform(-180, 180, chunk).astype(np.float32)
    yhi = rng.uniform(-90, 90, chunk).astype(np.float32)
    xlo = rng.uniform(0, 1e-5, chunk).astype(np.float32)
    ylo = rng.uniform(0, 1e-5, chunk).astype(np.float32)
    xhi[rng.random(chunk) < 0.03] = np.nan
    tday = rng.integers(-400, 400, chunk).astype(np.int32)
    tms = rng.integers(0, MS_DAY, chunk).astype(np.int32)
    av = rng.uniform(0, 100, (a, chunk)).astype(np.float32)
    av[rng.random((a, chunk)) < 0.05] = np.nan
    cx, cy = rng.uniform(-170, 170, (f, k)), rng.uniform(-80, 80, (f, k))
    w = rng.uniform(0.5, 40, (f, k))
    boxes = np.zeros((f, k, 8), np.float32)
    boxes[..., 0], boxes[..., 2] = cx - w, cx + w
    boxes[..., 4], boxes[..., 6] = cy - w, cy + w
    boxes[..., 1::2] = rng.uniform(0, 1e-5, (f, k, 4))
    # rows on a box's hi words, so the lo compare decides
    hit = rng.integers(0, chunk, f)
    boxes[np.arange(f), 0, 0] = xhi[hit]
    box_valid = rng.random((f, k)) < 0.8
    box_any = rng.random(f) < 0.1
    lo = rng.integers(-400, 300, f)
    times = np.stack([lo, rng.integers(0, MS_DAY, f), lo + rng.integers(
        0, 300, f), rng.integers(0, MS_DAY, f)], axis=1).astype(np.int32)
    times[::5] = (-(2 ** 30), 0, 2 ** 30, MS_DAY)
    alo = rng.uniform(0, 60, (f, a))
    attrs = np.stack([alo, np.zeros_like(alo), alo + 30, np.zeros_like(alo)],
                     axis=2).astype(np.float32)
    attr_any = rng.random((f, a)) < 0.5
    alive = rng.random(f) < 0.9
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    rows = [t(xhi), t(xlo), t(yhi), t(ylo), t(tday), t(tms), t(av), t(av + 1)]
    tables = [t(boxes), t(box_valid), t(box_any), t(times), t(attrs),
              t(attr_any), t(alive)]
    return rows, tables


def _canonical_grid(grid):
    """A grid's mode and cell starts, its cell lists as sorted (cell,
    slot) keys and its everywhere slots sorted: the kernels list them in
    no set order."""
    f = grid.mode.shape[0]
    start = grid.cell_start.long()
    cell = torch.repeat_interleave(
        torch.arange(kernels.STANDING_CELLS, device=start.device),
        start[1:] - start[:-1])
    return (grid.mode, grid.cell_start,
            torch.sort(cell * f + grid.cell_slots.long()).values,
            torch.sort(grid.every).values)


def _standing_check(rows, tables, chunks):
    """The kernels' pairs, counts and grid (``standing_pairs`` through the
    wrappers over ``chunks``) against the plain version's on the same
    tensors (one chunk), pair for pair; the launches each step made."""
    n_valid = sum(c[1] for c in chunks)
    kernels.reset_launches()
    ids, counts, grid = kernels.standing_pairs(chunks, tables)
    torch.cuda.synchronize()
    made = dict(kernels.launches)
    want = kernels.standing_pairs_plain([(rows, n_valid, 0)], tables)
    assert torch.equal(counts, want[1])
    assert torch.equal(ids, want[0])
    for a, b in zip(_canonical_grid(grid), _canonical_grid(want[2])):
        assert torch.equal(a, b)
    entries = int(grid.cell_slots.shape[0])
    assert made["standing_grid"] == (3 if entries else 2)
    live = sum(1 for c in chunks if c[1])
    assert made["standing_count"] == live
    assert made["standing_offsets"] == 1
    assert made["standing_write"] == (live if len(ids) else 0)
    assert made["standing_sort"] == (1 if len(ids) else 0)
    assert made["compact_prefix"] == made["compact_bits"] == 0
    return ids, counts, grid


@pytest.mark.gpu
@pytest.mark.parametrize("f,k,a,chunk,n_valid", [
    (1000, 1, 1, 1024, 1024), (300, 8, 2, 5000, 4321), (64, 1, 0, 17, 13),
    (129, 2, 3, 2048, 2048), (7, 1, 1, 70_000, 69_999)])
def test_standing_kernel_matches_plain(cuda, f, k, a, chunk, n_valid):
    """The grid, count, offsets, write and sort kernels against the plain
    version, pair for pair, on one chunk and on views of a longer upload
    cut into three chunks, as the dispatch passes them."""
    rows, tables = _standing_case(f, k, a, chunk, n_valid, cuda)
    ids, counts, grid = _standing_check(rows, tables, [(rows, n_valid, 0)])
    assert len(ids) and int(counts.sum()) == len(ids)
    big = [torch.cat([c, c]) if c.dim() == 1 else torch.cat([c, c], dim=1)
           for c in rows]
    views = ([c[chunk:] for c in big[:6]] + [c[:, chunk:] for c in big[6:]])
    step = -(-chunk // 3)
    chunks = [([c[s:s + step] for c in views[:6]]
               + [c[:, s:s + step] for c in views[6:]],
               max(min(step, n_valid - s), 0), s)
              for s in range(0, chunk, step)]
    got = _standing_check(views, tables, chunks)
    assert torch.equal(got[0], ids) and torch.equal(got[1], counts)


@pytest.mark.gpu
def test_standing_grid_edges_and_nan(cuda):
    """The grid's edges on the card, against the plain version: boxes'
    hi bounds on whole degrees and on the last f32 below one, rows on
    those words and next to them, NaN coordinates, attributes and bounds,
    rows and bounds past the world (and infinite), world-sized boxes,
    K = 4 overlapping boxes of a slot, box_any slots, dead slots; and a
    segment longer than the sort's tile (its bitmap path)."""
    rng = np.random.default_rng(19)
    f32 = np.float32
    f, k, n = 400, 4, 30_000
    up, down = f32(np.inf), f32(-np.inf)

    def bounds(lo, hi):
        e = rng.integers(lo, hi, (f, k)).astype(f32)
        w = rng.integers(0, 12, (f, k)).astype(f32)
        on = rng.random((2, f, k)) < 0.5
        return (np.where(on[0], e, np.nextafter(e, up)),
                np.where(on[1], e + w, np.nextafter(e + w + 1, down)))
    boxes = np.zeros((f, k, 8), f32)
    boxes[..., 0], boxes[..., 2] = bounds(-178, 160)
    boxes[..., 4], boxes[..., 6] = bounds(-88, 70)
    boxes[..., 1::2] = rng.choice([-1e-6, 0, 1e-6], (f, k, 4))
    boxes[:5, 0] = (-180, 0, 180, 0, -90, 0, 90, 0)        # world-sized
    boxes[5:10, 0] = (-1e38, 0, np.inf, 0, -np.inf, 0, 1e38, 0)
    boxes[10:20, 1, 0] = np.nan                            # a NaN bound
    boxes[20:30, 0, 2] = 400                               # past the world
    box_valid = rng.random((f, k)) < 0.9
    box_valid[:10, 0] = True
    box_any = np.zeros(f, bool)
    box_any[30:40] = True
    times = np.tile(np.array([-(2 ** 30), 0, 2 ** 30, MS_DAY], np.int32),
                    (f, 1))
    times[30:35] = (0, 0, 100, 0)
    attrs = np.zeros((f, 1, 4), f32)
    attrs[:, 0] = (10, 0, 60, 0)
    attr_any = rng.random((f, 1)) < 0.7
    alive = rng.random(f) < 0.95
    pick = rng.integers(40, f * k, n)
    bx = boxes.reshape(f * k, 8)[pick]
    side = rng.integers(0, 2, (2, n))
    xhi = bx[np.arange(n), 2 * side[0]].copy()
    yhi = bx[np.arange(n), 4 + 2 * side[1]].copy()
    step = rng.choice([up, down], (2, n))
    half = n // 2
    xhi[half:] = np.nextafter(xhi[half:], step[0, half:])
    yhi[half:] = np.nextafter(yhi[half:], step[1, half:])
    xhi[:200] = rng.choice([-1e30, -200, 180.5, np.inf, -np.inf, np.nan],
                           200)
    yhi[200:400] = rng.choice([-95, 90.5, 1e30, np.nan], 200)
    # a dense cell: 9,000 rows inside slot 41's first box (a long segment)
    boxes[41, 0] = (10.0, 0, 12.0, 0, 20.0, 0, 22.0, 0)
    box_valid[41, 0], alive[41], attr_any[41] = True, True, True
    xhi[1000:10_000] = rng.uniform(10.2, 11.8, 9000)
    yhi[1000:10_000] = rng.uniform(20.2, 21.8, 9000)
    xlo = rng.choice([-1e-6, 0, 1e-6], n).astype(f32)
    ylo = rng.choice([-1e-6, 0, 1e-6], n).astype(f32)
    xlo[rng.random(n) < 0.02] = np.nan
    av = rng.uniform(0, 100, (1, n)).astype(f32)
    av[rng.random((1, n)) < 0.05] = np.nan
    tday = rng.integers(-50, 150, n).astype(np.int32)
    tms = rng.integers(0, MS_DAY, n).astype(np.int32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
    rows = [t(xhi), t(xlo), t(yhi), t(ylo), t(tday), t(tms), t(av),
            t(np.zeros_like(av))]
    tables = [t(boxes), t(box_valid), t(box_any), t(times), t(attrs),
              t(attr_any), t(alive)]
    chunks = [([c[s:s + 8192] for c in rows[:6]]
               + [c[:, s:s + 8192] for c in rows[6:]],
               min(8192, n - 1 - s), s) for s in range(0, n, 8192)]
    ids, counts, grid = _standing_check(rows, tables, chunks)
    mode = grid.mode.cpu().numpy()
    assert (mode[:10][alive[:10]] == kernels.STANDING_EVERYWHERE).all()
    assert (mode[~alive] == kernels.STANDING_NOWHERE).all()
    assert int(counts[41]) > kernels.STANDING_SORT_TILE


@pytest.mark.gpu
def test_standing_set_on_cuda_matches_cpu(cuda):
    """2,000 standing filters (boxes, times, speed ranges, LIKEs, ORs)
    against 50k rows on a CUDA set and a CPU set: the same hits, in
    several chunks too, with the device tables kept in place through
    churn."""
    from geomesa_tpu_torch.scan.standing import (CQ_DEVICE_MAX_CELLS,
                                                 StandingFilterSet)
    rng = np.random.default_rng(15)
    spec = "name:String,speed:Double,dtg:Date,*geom:Point:srid=4326"
    n = 50_000
    batch = FeatureBatch.from_dict(
        parse_spec("g", spec), [f"r{i}" for i in range(n)],
        {"name": [f"u{i % 500}" for i in range(n)],
         "speed": rng.uniform(0, 300, n),
         "dtg": 1_467_331_200_000 + rng.integers(0, 120 * MS_DAY, n),
         "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})

    def ecql(i):
        cx, cy = rng.uniform(-170, 170), rng.uniform(-80, 80)
        w = rng.uniform(0.5, 10)
        box = (f"bbox(geom,{cx - w:.4f},{cy - w:.4f},"
               f"{cx + w:.4f},{cy + w:.4f})")
        return {3: f"{box} AND dtg DURING 2016-07-01T00:00:00Z/"
                   f"2016-09-01T00:00:00Z",
                5: f"{box} AND speed BETWEEN 10 AND 50",
                7: f"{box} AND name LIKE 'u{i % 100}%'",
                8: f"{box} OR bbox(geom,0,0,5,5)"}.get(i % 10, box)

    filters = [parse_ecql(ecql(i)) for i in range(2000)]
    sets = [StandingFilterSet(batch.sft, device=d) for d in (cuda, "cpu")]
    for s in sets:
        for i, f in enumerate(filters):
            s.register(f"q{i}", f)
    kernels.reset_launches()
    got, want = (s.dispatch(batch) for s in sets)
    assert kernels.launches["standing_count"] >= 1
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert sum(map(len, got.values())) > 0
    ptrs = [t.data_ptr() for t in sets[0].device_tables()]
    for s in sets:
        for i in range(100):
            s.unregister(f"q{i}")
            s.register(f"q{i}r", filters[-1 - i])
    old = CQ_DEVICE_MAX_CELLS.get()
    try:
        CQ_DEVICE_MAX_CELLS.set(str(1 << 20))
        got, want = (s.dispatch(batch) for s in sets)
    finally:
        CQ_DEVICE_MAX_CELLS.set(old)
    assert [t.data_ptr() for t in sets[0].device_tables()] == ptrs
    assert all(np.array_equal(got[k], want[k]) for k in got)


# -- the result cache and the ingest pipeline on the card ---------------------

def _tile_store(n=200_000, seed=12):
    rng = np.random.default_rng(seed)
    ds = InMemoryDataStore()
    ds.create_schema("tiles", "w:Integer,dtg:Date,*geom:Point:srid=4326")
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ds.write_dict("tiles", [f"t{i}" for i in range(n)], {
        "w": rng.integers(0, 9, n), "dtg": rng.integers(0, 50 * MS_DAY, n),
        "geom": (x, y)})
    return ds, x, y


@pytest.mark.gpu
def test_cold_density_herd_makes_one_launch(cuda):
    """8 threads asking one cold tile at once: one density kernel launch
    (the leader's; the others wait on its flight or hit its entry), and
    each caller gets its own copy of the same grid."""
    import threading
    ds, _, _ = _tile_store()
    ds.density("tiles", "INCLUDE", (-180, -90, 180, 90), 8, 8)   # warm-up
    kernels.reset_launches()
    m0 = ds.result_cache.misses
    barrier, out = threading.Barrier(8), [None] * 8

    def go(i):
        barrier.wait(30.0)
        out[i] = ds.density("tiles", "INCLUDE", (-45, -45, 0, 0), 256, 256)
    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launches["density_grid"] == 1
    assert ds.result_cache.misses == m0 + 1
    assert len({id(g) for g in out}) == 8
    assert all(g.tobytes() == out[0].tobytes() for g in out)
    assert float(out[0].sum()) > 0


@pytest.mark.gpu
def test_cached_cuda_grids_equal_uncached(cuda):
    """A cached grid's bytes equal a fresh launch's at the same version
    and the CPU store's, for several tiles and weights; N cached calls
    make one launch, and a write makes the next call launch again."""
    from geomesa_tpu_torch.cache import CACHE_ENABLED
    ds, x, _ = _tile_store()
    cpu = InMemoryDataStore(device="cpu")
    cpu.create_schema("tiles", ds.get_schema("tiles").to_spec())
    st = ds._state("tiles")
    cpu.write("tiles", FeatureBatch(cpu.get_schema("tiles"), st.batch.ids,
                                    st.batch.columns))
    tiles = [((-180, -90, 180, 90), 64, 32, None, "INCLUDE"),
             ((-45, -45, 0, 0), 256, 256, None, "INCLUDE"),
             ((0, 0, 45, 45), 256, 256, "w",
              "dtg DURING 1970-01-05T00:00:00Z/1970-02-01T00:00:00Z")]
    for bbox, w, h, attr, ecql in tiles:
        kernels.reset_launches()
        grids = [ds.density("tiles", ecql, bbox, w, h, attr)
                 for _ in range(4)]
        assert kernels.launches["density_grid"] == 1
        CACHE_ENABLED.thread_local_set("false")
        try:
            fresh = ds.density("tiles", ecql, bbox, w, h, attr)
        finally:
            CACHE_ENABLED.thread_local_set(None)
        assert kernels.launches["density_grid"] == 2
        want = cpu.density("tiles", ecql, bbox, w, h, attr)
        for g in grids:
            assert g.tobytes() == fresh.tobytes() == want.tobytes()
    for s in (ds, cpu):
        s.write_dict("tiles", ["new"], {"w": [1], "dtg": [MS_DAY],
                                        "geom": ([-10.0], [-10.0])})
    kernels.reset_launches()
    g = ds.density("tiles", "INCLUDE", (-45, -45, 0, 0), 256, 256)
    assert kernels.launches["density_grid"] == 1
    # INCLUDE: every row counts, those outside the box in its edge cells
    assert float(g.sum()) == len(x) + 1
    assert g.tobytes() == cpu.density("tiles", "INCLUDE", (-45, -45, 0, 0),
                                      256, 256).tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("durable", [False, True])
def test_ingest_pipeline_on_cuda_matches_brute_force(cuda, tmp_path,
                                                     durable):
    """Staged batches through the group-commit writer into a store on
    the card: the count is the rows staged, groups are at most the
    batches, and a BBOX+time query equals the float64 brute force."""
    from geomesa_tpu_torch.ingest import IngestPipeline
    kw = ({"durable_dir": str(tmp_path / "d"), "wal_fsync": "always"}
          if durable else {})
    ds = InMemoryDataStore(**kw)
    ds.create_schema("boats", "dtg:Date,*geom:Point:srid=4326")
    sft = ds.get_schema("boats")
    rng = np.random.default_rng(16)
    n, per = 200_000, 8_192
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = rng.integers(0, 30 * MS_DAY, n)
    with IngestPipeline(ds, group_rows=65_536) as pipe:
        acks = [pipe.write("boats", FeatureBatch.from_dict(
            sft, [f"b{i}" for i in range(lo, min(lo + per, n))],
            {"dtg": ms[lo:lo + per], "geom": (x[lo:lo + per],
                                               y[lo:lo + per])}))
            for lo in range(0, n, per)]
        for a in acks:
            a.wait(timeout=60.0)
    assert ds.count("boats") == n
    ecql = ("BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
            "1970-01-05T00:00:00Z/1970-01-20T00:00:00Z")
    want = np.flatnonzero((x >= -80) & (x <= -60) & (y >= 30) & (y <= 45)
                          & (ms > 4 * MS_DAY) & (ms < 19 * MS_DAY))
    got = sorted(int(str(i)[1:]) for i in ds.query(ecql, "boats").ids)
    assert got == want.tolist()
    ds.close()


# -- the mesh (parallel/, store/mesh_store.py) on the card ---------------------

def _mesh_rows(n, seed):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 100 * MS_DAY, n)
    x[:64] = x[64:128]        # duplicate points: KNN ties
    y[:64] = y[64:128]
    return x, y, ms


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8])
def test_parallel_on_cuda_matches_cpu_mesh(cuda, k):
    """Every sharded program on k shards of the card against the same
    program on k CPU shards (the kernels' plain versions): hit rows,
    counts, batched rows, the density grid bit for bit, contains counts,
    the ring's (sure, band), KNN ids in order, tristate states; and each
    program launched its kernels on the card."""
    from geomesa_tpu_torch import parallel as par
    from geomesa_tpu_torch.geometry.base import Polygon
    from geomesa_tpu_torch.parallel import mesh as pmesh
    n = 200_003
    x, y, ms = _mesh_rows(n, 5)
    dev_mesh, cpu_mesh = par.data_mesh(k), par.data_mesh(k, device="cpu")
    assert all(d.type == "cuda" for d in dev_mesh.devices)
    on = par.shard_scan_data(x, y, ms, dev_mesh)
    off = par.shard_scan_data(x, y, ms, cpu_mesh)
    q = zscan.make_query([(-80.0, 30.0, -60.0, 45.0), (x[3], y[3], 20, 20)],
                         [(int(ms[0]), int(ms[0]) + 40 * MS_DAY)])
    kernels.reset_launches()
    assert np.array_equal(par.exact_hit_rows(on, q),
                          par.exact_hit_rows(off, q))
    assert par.distributed_count(on, q) == par.distributed_count(off, q)
    bq = zscan.stack_queries([q, zscan.make_query([(-10, -10, 10, 10)], [])])
    for a, b in zip(pmesh.batch_exact_hit_rows(on, bq),
                    pmesh.batch_exact_hit_rows(off, bq)):
        assert np.array_equal(a, b)
    bbox = (-180.0, -90.0, 180.0, 90.0)
    assert par.distributed_density(on, q, bbox, 360, 180).tobytes() == \
        par.distributed_density(off, q, bbox, 360, 180).tobytes()
    polys = [Polygon([(cx - 3, cy - 2), (cx + 3, cy - 2), (cx + 3, cy + 2),
                      (cx - 3, cy + 2)])
             for cx, cy in ((0.0, 0.0), (x[9], y[9]), (100.0, -40.0))]
    assert np.array_equal(pmesh.distributed_contains_counts(on, polys),
                          pmesh.distributed_contains_counts(off, polys))
    left = [par.shard_points(x[:20_000], y[:20_000], m)
            for m in (dev_mesh, cpu_mesh)]
    right = [par.shard_points(x[20_000:60_000], y[20_000:60_000], m)
             for m in (dev_mesh, cpu_mesh)]
    got = [par.ring_dwithin_counts(*lp[:3], *rp[:3], m, 1.5)
           for lp, rp, m in zip(left, right, (dev_mesh, cpu_mesh))]
    assert all(np.array_equal(a, b) for a, b in zip(*got))
    sp = [par.shard_points_split(x, y, m) for m in (dev_mesh, cpu_mesh)]
    for qx, qy, kk in ((x[70], y[70], 10), (12.3, -45.6, 50)):
        assert np.array_equal(
            par.distributed_knn(None, None, sp[0][1], dev_mesh, n, qx, qy,
                                kk, split=sp[0][0]),
            par.distributed_knn(None, None, sp[1][1], cpu_mesh, n, qx, qy,
                                kk, split=sp[1][0]))
    bounds = np.stack([x, y, x + 0.5, y + 0.25], axis=1)[:50_001]
    eq = gscan.extent_query([(-20.0, -15.0, 31.5, 42.25)],
                            [(int(ms[0]), int(ms[0]) + 30 * MS_DAY)])
    assert np.array_equal(
        par.distributed_tristate(par.shard_extent_data(
            bounds, ms[:50_001], dev_mesh), eq),
        par.distributed_tristate(par.shard_extent_data(
            bounds, ms[:50_001], cpu_mesh), eq))
    for name in ("scan_mask", "scan_count", "scan_batch_bits",
                 "compact_bits", "compact_prefix", "density_grid",
                 "contains_counts", "dwithin_counts", "knn_topk",
                 "extent_tristate"):
        assert kernels.launches[name] >= k, name
    join.clear_xsort_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8])
def test_mesh_store_on_cuda_matches_cpu(cuda, k, monkeypatch):
    """DistributedDataStore on k shards of the card against the same
    store on k CPU shards and against the single CUDA store: ids in
    order, counts, density, KNN, histogram, query_batched, Arrow bytes."""
    from geomesa_tpu_torch import DistributedDataStore
    from geomesa_tpu_torch.parallel import data_mesh
    n = 120_007
    x, y, ms = _mesh_rows(n, 6)
    ids = [f"f{i}" for i in range(n)]
    rng = np.random.default_rng(6)
    data = {"age": rng.integers(0, 100, n), "dtg": ms, "geom": (x, y)}
    spec = "age:Integer,dtg:Date,*geom:Point:srid=4326"
    mesh_cuda = DistributedDataStore(data_mesh(k))
    mesh_cpu = DistributedDataStore(data_mesh(k, device="cpu"))
    single = InMemoryDataStore()
    for s in (mesh_cuda, mesh_cpu, single):
        s.create_schema("pts", spec)
        s.write_dict("pts", ids, data)
    ecqls = ["BBOX(geom, -80, 30, -60, 45) AND dtg DURING "
             "2020-01-10T00:00:00Z/2020-02-20T00:00:00Z",
             "BBOX(geom, -180, -90, 180, 0)",
             "BBOX(geom, -20, -15, 31.5, 42.25) AND age > 50"]
    for host, thr in (("0", "1.0"), ("0", "0"), (None, None)):
        for var, v in (("GEOMESA_SCAN_HOST_ROWS", host),
                       ("GEOMESA_SCAN_INDEX_THRESHOLD", thr)):
            if v is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, v)
        for e in ecqls:
            got = list(mesh_cuda.query(e, "pts").ids)
            assert got == list(mesh_cpu.query(e, "pts").ids)
            assert got == list(single.query(e, "pts").ids)
            assert mesh_cuda.query_count(e, "pts") == len(got)
    kernels.reset_launches()
    bbox = (-180.0, -90.0, 180.0, 90.0)
    g = mesh_cuda.density("pts", ecqls[1], bbox, 256, 128)
    assert g.tobytes() == mesh_cpu.density("pts", ecqls[1], bbox, 256,
                                           128).tobytes()
    assert kernels.launches["density_grid"] == k
    assert list(mesh_cuda.knn("pts", x[70], y[70], 20)) == list(
        mesh_cpu.knn("pts", x[70], y[70], 20))
    assert np.array_equal(mesh_cuda.histogram("pts", "age", 10, 0, 100),
                          mesh_cpu.histogram("pts", "age", 10, 0, 100))
    res = mesh_cuda.query_batched([Query("pts", e) for e in ecqls[:2]])
    assert [list(r.ids) for r in res] == [
        list(single.query(e, "pts").ids) for e in ecqls[:2]]
    assert mesh_cuda.arrow_ipc("pts", ecqls[0]) == mesh_cpu.arrow_ipc(
        "pts", ecqls[0])
    assert kernels.launches["knn_topk"] > 0
    assert kernels.launches["scan_batch_bits"] >= k
