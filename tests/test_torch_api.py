"""The port's ``GeoMesaIndex`` (``api/``) against the JAX package's on
the CPU: insert (one value and batches), query by bbox, by interval (the
unquoted ``dtg BETWEEN <ms> AND <ms>``), by CQL and by their conjunction,
with and without ids, get, delete and size, with both serializers, on
the same seeded values. Tolerance: exact: the values, the ids and their
order are equal."""

import numpy as np
import pytest

import geomesa_tpu.api as j_api
import geomesa_tpu_torch.api as t_api
from geomesa_tpu_torch.store.memory import InMemoryDataStore

T0 = 1_500_000_000_000
QUERIES = [
    {},
    {"bbox": (-90, 30, -70, 40)},
    {"bbox": (-180, -90, 180, 90)},
    {"interval": (T0 + 10**9, T0 + 4 * 10**9)},
    {"interval": (T0, T0)},
    {"bbox": (-95, 25, -65, 45), "interval": (T0 + 10**9, T0 + 6 * 10**9)},
    {"cql": "dtg > 1505000000000"},
    {"cql": "BBOX(geom, -80, 30, -70, 40) OR dtg < 1500500000000"},
    {"bbox": (-90, 30, -70, 40), "cql": "dtg BETWEEN 1501000000000 AND "
                                        "1508000000000"},
    {"bbox": (10, 10, 20, 20)},
]


def _values(kind: str, n: int):
    if kind == "pickle":
        return [{"i": i, "tags": (f"t{i % 3}", i / 7), "b": bytes([i % 256])}
                for i in range(n)]
    return [{"i": i, "name": f"v{i}", "w": [i, i * 0.5]} for i in range(n)]


def _pair(kind: str, n=300, seed=3):
    """A JAX index and the port's (on a CPU store), with the same
    values: a batch insert, then single inserts with and without a
    time."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-100, -60, n), rng.uniform(20, 50, n)
    t = T0 + rng.integers(0, 10**10, n)
    vals = _values(kind, n + 2)
    ser = {"pickle": "PickleSerializer", "json": "JsonSerializer"}[kind]
    ji = j_api.GeoMesaIndex.memory(getattr(j_api, ser)())
    ti = t_api.GeoMesaIndex(getattr(t_api, ser)(),
                            store=InMemoryDataStore(device="cpu"))
    for idx in (ji, ti):
        idx.insert_batch([f"f{i}" for i in range(n)], vals[:n], x, y, t)
        assert idx.insert("solo", vals[n], -75.0, 38.0, T0 + 123) == "solo"
        idx.insert("notime", vals[n + 1], -76.0, 39.0)
    return ji, ti


@pytest.mark.parametrize("kind", ["pickle", "json"])
@pytest.mark.parametrize("q", range(len(QUERIES)))
@pytest.mark.parametrize("with_ids", [False, True])
def test_query_equals_reference(kind, q, with_ids):
    ji, ti = _pair(kind)
    want = ji.query(**QUERIES[q], with_ids=with_ids)
    got = ti.query(**QUERIES[q], with_ids=with_ids)
    assert got == want


@pytest.mark.parametrize("kind", ["pickle", "json"])
def test_get_delete_size_equal_reference(kind):
    ji, ti = _pair(kind)
    assert ti.size() == ji.size() == 302
    for fid in ("f0", "f17", "solo", "notime", "missing"):
        assert ti.get(fid) == ji.get(fid)
    for idx in (ji, ti):
        idx.delete("f17")
        idx.delete("solo")
    assert ti.size() == ji.size() == 300
    assert ti.get("f17") is None and ji.get("f17") is None
    for q in QUERIES:
        assert ti.query(**q, with_ids=True) == ji.query(**q, with_ids=True)


def test_interval_is_inclusive_epoch_millis():
    _, ti = _pair("json")
    hit = ti.query(interval=(T0 + 123, T0 + 123), with_ids=True)
    assert [fid for fid, _ in hit] == ["solo"]
    assert ti.query(interval=(0, 0), with_ids=True) == [("notime", ti.get(
        "notime"))]


def test_existing_store_and_type_reused():
    ds = InMemoryDataStore(device="cpu")
    a = t_api.GeoMesaIndex(t_api.JsonSerializer(), store=ds, type_name="v")
    a.insert("x", {"k": 1}, 1.0, 2.0, 5)
    b = t_api.GeoMesaIndex(t_api.JsonSerializer(), store=ds, type_name="v")
    assert b.size() == 1 and b.get("x") == {"k": 1}
    assert ds.get_type_names() == ["v"]


def test_memory_defaults_to_cuda(monkeypatch):
    import geomesa_tpu_torch.store.memory as memory
    seen = []
    real = memory.resolve_device

    def spy(device):
        seen.append(device)
        return real("cpu")
    monkeypatch.setattr(memory, "resolve_device", spy)
    t_api.GeoMesaIndex.memory(t_api.PickleSerializer())
    t_api.GeoMesaIndex(t_api.PickleSerializer())
    t_api.GeoMesaIndex.memory(t_api.PickleSerializer(), device="cpu")
    assert seen == [None, None, "cpu"]
    monkeypatch.undo()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_api.GeoMesaIndex.memory(t_api.PickleSerializer())


def test_value_serializer_is_abstract():
    with pytest.raises(NotImplementedError):
        t_api.ValueSerializer().to_bytes(1)
    with pytest.raises(NotImplementedError):
        t_api.ValueSerializer().from_bytes(b"")
