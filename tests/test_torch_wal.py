"""The port's durability stack (geomesa_tpu_torch/wal, integrity, the
file bus's wire format and the store's durable_dir) against the JAX
package's, on the CPU, at small sizes: WAL frame and segment bytes,
record payloads read across packages, durable directories written by
one package and recovered by the other, seeded sequences of schema
operations, labelled writes, updates, deletes, checkpoints, aborts and
torn tails on a port store (device="cpu") beside a JAX store, the fault
disk (failed fsyncs, bit flips, torn writes), checkpoint verification,
the z-key index's state_dict/load_state, and replay's id set.

Tolerance: exact everywhere (bytes, ids in order, column values with
NaN bit patterns, RecoveryReport fields but the wall time)."""

import os
import threading

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JaxBatch
from geomesa_tpu.features.sft import parse_spec as jax_parse_spec
from geomesa_tpu.index.api import Query as JaxQuery
from geomesa_tpu.index.zkeys import ZKeyIndex as JaxZKeyIndex
from geomesa_tpu.integrity import verify as jax_verify
from geomesa_tpu.store.memory import InMemoryDataStore as JaxStore
from geomesa_tpu.wal import log as jax_log
from geomesa_tpu_torch import InMemoryDataStore, Query
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.index.zkeys import ZKeyIndex
from geomesa_tpu_torch.integrity import (FaultDisk, flip_bit,
                                         verify_checkpoint, verify_wal)
from geomesa_tpu_torch.integrity import faultfs
from geomesa_tpu_torch.metrics import MetricsRegistry
from geomesa_tpu_torch.store import filebus
from geomesa_tpu_torch.wal import (CREATE_SCHEMA, DELETE, WRITE,
                                   DurabilityError, DurableStore, Journal,
                                   WriteAheadLog, decode_delete,
                                   decode_schema, decode_write,
                                   encode_delete, encode_schema,
                                   encode_write)
from geomesa_tpu_torch.wal import log as wal_log
from geomesa_tpu_torch.wal import recovery
from geomesa_tpu_torch.wal.snapshot import checkpoint_dirs

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
PLAIN_SPEC = "kind:String:index=true,val:Integer,dtg:Date"
MS_DAY = 86_400_000
QUERIES = [
    ("pts", "BBOX(geom, -100, -50, 100, 50)"),
    ("pts", "BBOX(geom, -180, -90, 0, 90) AND dtg DURING "
            "2020-01-05T00:00:00Z/2020-02-10T00:00:00Z"),
    ("pts", "name = 'n3' OR name = 'upd'"),
    ("pts", "INCLUDE"),
    ("ev", "kind = 'k2' AND val > 10"),
    ("ev", "INCLUDE"),
]
AUTHS = [[], ["a"], ["a", "b"]]
LABELS = [None, "a", "a&b", "b"]


def _point_data(rng, n):
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[rng.random(n) < 0.05] = np.nan
    return {"name": [None if i % 11 == 0 else f"n{int(v)}"
                     for i, v in enumerate(rng.integers(0, 6, n))],
            "dtg": 1_577_836_800_000 + rng.integers(0, 60 * MS_DAY, n),
            "geom": (x, np.where(np.isnan(x), np.nan, y))}


def _event_data(rng, n):
    return {"kind": [f"k{int(v)}" for v in rng.integers(0, 4, n)],
            "val": rng.integers(-50, 50, n).tolist(),
            "dtg": 1_577_836_800_000 + rng.integers(0, 60 * MS_DAY, n)}


def _query_ids(store, jstore):
    """Every query under every auth set, in both stores: (port, JAX)."""
    got, want = [], []
    for tn, ecql in QUERIES:
        if tn not in store.get_type_names():
            assert tn not in jstore.get_type_names()
            continue
        for auths in AUTHS:
            got.append(list(store.query(Query(tn, ecql, auths=auths)).ids))
            want.append(list(jstore.query(JaxQuery(tn, ecql,
                                                   auths=auths)).ids))
        assert store.count(tn) == jstore.count(tn)
    return got, want


def _cols(batch):
    """A batch's ids and columns as comparable plain data."""
    if batch is None:
        return None
    out = {"ids": [str(i) for i in batch.ids]}
    for a in batch.sft.attributes:
        c = batch.col(a.name)
        if hasattr(c, "x"):
            out[a.name] = (c.x.tobytes(), c.y.tobytes(), list(c.valid))
        elif hasattr(c, "millis"):
            out[a.name] = (c.millis.tobytes(), list(c.valid))
        else:
            out[a.name] = [c.value(i) for i in range(c.n)]
    return out


def _state(store):
    """Each type's rows, columns and labels, as the store holds them."""
    out = {}
    for tn in store.get_type_names():
        st = store._types[tn]
        b = st.batch
        vis = st._vis if hasattr(st, "_vis") else st.vis
        labels = (None if vis is None or not st.has_vis
                  else [None if v is None else str(v) for v in vis])
        out[tn] = (_cols(b), labels)
    return out


def _report(rep):
    d = rep.to_json_object()
    d.pop("wall_time_s")
    d["errors"] = len(d["errors"])
    return d


# -- the log's bytes ------------------------------------------------------

@pytest.mark.parametrize("segment_bytes", [64, 300, 1 << 20])
@pytest.mark.parametrize("policy", ["always", "interval", "never"])
def test_frames_equal_the_reference(tmp_path, segment_bytes, policy):
    """The same payloads appended to both logs give the same segment
    files, byte for byte: header, CRC frames, rotation points."""
    rng = np.random.default_rng(segment_bytes)
    payloads = [bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
                for k in rng.integers(0, 200, 25)]
    kinds = rng.integers(1, 6, 25)
    mine = WriteAheadLog(str(tmp_path / "p"), fsync=policy,
                         segment_bytes=segment_bytes, interval_ms=5,
                         registry=MetricsRegistry())
    ref = jax_log.WriteAheadLog(str(tmp_path / "j"), fsync=policy,
                                segment_bytes=segment_bytes, interval_ms=5)
    for k, p in zip(kinds, payloads):
        assert mine.append(int(k), p) == ref.append(int(k), p)
    mine.close()
    ref.close()
    segs = [os.path.basename(p) for _, p in
            wal_log.list_segments(str(tmp_path / "p"))]
    assert segs == [os.path.basename(p) for _, p in
                    jax_log.list_segments(str(tmp_path / "j"))]
    for name in segs:
        with open(tmp_path / "p" / name, "rb") as a, \
                open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read()
    assert wal_log.inspect_dir(str(tmp_path / "j")) \
        == jax_log.inspect_dir(str(tmp_path / "p"))
    got = list(WriteAheadLog(str(tmp_path / "j"), fsync="never").records())
    assert got == [(i + 1, int(k), p)
                   for i, (k, p) in enumerate(zip(kinds, payloads))]


@pytest.mark.parametrize("tail", [b"\x01", b"\x01\x02\x03 torn append",
                                  b"\x00" * 40])
def test_torn_tail_truncated_like_the_reference(tmp_path, tail):
    """A partial frame after the last record: both logs drop it on open,
    truncate the segment to the same bytes and go on at the same LSN."""
    for d in ("p", "j"):
        wal = WriteAheadLog(str(tmp_path / d), fsync="never")
        for i in range(5):
            wal.append(WRITE, f"rec{i}".encode())
        wal.abort()
        _, seg = wal_log.list_segments(str(tmp_path / d))[-1]
        with open(seg, "ab") as f:
            f.write(tail)
    mine = WriteAheadLog(str(tmp_path / "p"), fsync="never")
    ref = jax_log.WriteAheadLog(str(tmp_path / "j"), fsync="never")
    assert mine.torn_tail_records == ref.torn_tail_records == 1
    assert mine.next_lsn == ref.next_lsn == 6
    assert mine.append(DELETE, b"x") == ref.append(DELETE, b"x")
    mine.close()
    ref.close()
    (_, a), (_, b) = (wal_log.list_segments(str(tmp_path / d))[-1]
                      for d in ("p", "j"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_payloads_read_across_packages():
    """WRITE payloads (JSON header + Arrow IPC) and DELETE payloads of
    either package decode in the other; schema records are equal bytes."""
    rng = np.random.default_rng(3)
    data = _point_data(rng, 40)
    ids = [f"f{i}" for i in range(40)]
    vis = [LABELS[i % 4] for i in range(40)]
    sft, jsft = parse_spec("pts", SPEC), jax_parse_spec("pts", SPEC)
    batch = FeatureBatch.from_dict(sft, ids, data)
    jbatch = JaxBatch.from_dict(jsft, ids, data)
    for raw in (encode_write("pts", batch, vis),
                jax_log.encode_write("pts", jbatch, vis)):
        for dec in (decode_write, jax_log.decode_write):
            tn, out, vout = dec(raw)
            assert tn == "pts" and vout == tuple(vis)
            assert _cols(out) == _cols(batch)
    for raw in (encode_delete("pts", [1, "two"]),
                jax_log.encode_delete("pts", [1, "two"])):
        assert decode_delete(raw) == jax_log.decode_delete(raw) \
            == ("pts", ("1", "two"))
    assert encode_schema(sft) == jax_log.encode_schema(jsft)
    assert decode_schema(encode_schema(sft)) \
        == jax_log.decode_schema(encode_schema(sft))


def test_record_past_two_million_rows():
    """Batches of 4M rows convert to Arrow in the port: the id column
    and a string column of 4M distinct values, and a WRITE record of
    them round-trips. (The JAX package's to_arrow raises TypeError at
    this size: pyarrow turns a numpy unicode array of more than about 2M
    rows into a ChunkedArray.)"""
    from geomesa_tpu_torch.features.batch import DateColumn, StringColumn
    n = 4_000_000
    ids = np.arange(n).astype(str).astype(object)
    dtg = DateColumn("dtg", np.arange(n), np.ones(n, dtype=bool))
    sft = parse_spec("ev", "kind:String,dtg:Date")
    rb = FeatureBatch(sft, ids, {
        "kind": StringColumn("kind", np.arange(n, dtype=np.int32),
                             ids), "dtg": dtg}).to_arrow()
    assert len(rb.column("kind").dictionary) == n
    batch = FeatureBatch(parse_spec("ev", "dtg:Date"), ids, {"dtg": dtg})
    tn, out, vis = decode_write(encode_write("ev", batch))
    assert tn == "ev" and vis is None and out.n == n
    assert np.array_equal(out.ids, ids)
    assert np.array_equal(out.col("dtg").millis, dtg.millis)
    jbatch = JaxBatch.from_dict(jax_parse_spec("ev", "dtg:Date"), ids,
                                {"dtg": np.arange(n)})
    with pytest.raises(TypeError, match="ChunkedArray"):
        jbatch.to_arrow()


# -- durable directories across packages ----------------------------------

def _history(store, rng, checkpoint=True):
    """A short mixed history on a durable store: two schemas (one
    without a geometry), labelled writes, an update (delete, then
    write), a rewrite of existing ids, deletes, a checkpoint, a dropped
    and re-created schema."""
    store.create_schema("pts", SPEC)
    store.create_schema("ev", PLAIN_SPEC)
    store.create_schema("gone", SPEC)
    store.write_dict("pts", [f"p{i}" for i in range(300)],
                     _point_data(rng, 300),
                     visibilities=[LABELS[i % 4] for i in range(300)])
    store.write_dict("ev", [f"e{i}" for i in range(200)],
                     _event_data(rng, 200))
    store.write_dict("gone", ["g0", "g1"], _point_data(rng, 2))
    if checkpoint:
        store.checkpoint()
    store.delete("pts", [f"p{i}" for i in range(0, 40, 3)])
    store.write_dict("pts", [f"p{i}" for i in range(0, 40, 3)],
                     dict(_point_data(rng, 14), name=["upd"] * 14))
    store.write_dict("pts", [f"p{i}" for i in range(100, 110)],
                     _point_data(rng, 10))
    store.write_dict("pts", [f"q{i}" for i in range(50)],
                     _point_data(rng, 50))
    store.delete("ev", [f"e{i}" for i in range(0, 200, 7)] + ["nope"])
    store.remove_schema("gone")
    store.create_schema("gone", PLAIN_SPEC)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_reference_directory_recovers_in_the_port(tmp_path, checkpoint):
    root = str(tmp_path / "d")
    j = JaxStore(durable_dir=root, wal_fsync="never")
    _history(j, np.random.default_rng(1), checkpoint)
    j.journal.abort()
    ref = JaxStore(durable_dir=root, wal_fsync="never")
    ref.journal.abort()
    mine = InMemoryDataStore(device="cpu", durable_dir=root,
                             wal_fsync="never")
    assert _report(mine.journal.last_report) \
        == _report(ref.journal.last_report)
    assert _state(mine) == _state(ref)
    got, want = _query_ids(mine, ref)
    assert got == want
    mine.close()


@pytest.mark.parametrize("checkpoint", [False, True])
def test_port_directory_recovers_in_the_reference(tmp_path, checkpoint):
    root = str(tmp_path / "d")
    p = InMemoryDataStore(device="cpu", durable_dir=root, wal_fsync="never")
    _history(p, np.random.default_rng(2), checkpoint)
    p.journal.abort()
    mine = InMemoryDataStore(device="cpu", durable_dir=root,
                             wal_fsync="never")
    mine.journal.abort()
    ref = JaxStore(durable_dir=root, wal_fsync="never")
    assert _report(mine.journal.last_report) \
        == _report(ref.journal.last_report)
    assert _state(mine) == _state(ref)
    got, want = _query_ids(mine, ref)
    assert got == want
    ref.close()


# -- seeded operation sequences -------------------------------------------

def _random_ops(seed: int, steps: int = 40):
    """A seeded list of store operations on two types."""
    rng = np.random.default_rng(seed)
    ops, live, next_id = [], {"pts": [], "ev": []}, 0
    for _ in range(steps):
        r = rng.random()
        tn = "pts" if rng.random() < 0.7 else "ev"
        if r < 0.35 or not live[tn]:
            n = int(rng.integers(1, 80))
            ids = [f"{tn}{next_id + i}" for i in range(n)]
            next_id += n
            vis = ([LABELS[int(v)] for v in rng.integers(0, 4, n)]
                   if tn == "pts" and rng.random() < 0.5 else None)
            ops.append(("write", tn, ids, int(rng.integers(1 << 30)), vis))
            live[tn] += ids
        elif r < 0.5:   # update: delete, then write the same ids
            k = min(len(live[tn]), int(rng.integers(1, 20)))
            ids = [str(v) for v in rng.choice(live[tn], k, replace=False)]
            ops.append(("delete", tn, ids))
            ops.append(("write", tn, ids, int(rng.integers(1 << 30)), None))
        elif r < 0.58:  # rewrite of held ids: recovery collapses them
            k = min(len(live[tn]), int(rng.integers(1, 10)))
            ids = [str(v) for v in rng.choice(live[tn], k, replace=False)]
            ops.append(("write", tn, ids, int(rng.integers(1 << 30)), None))
        elif r < 0.72:
            k = min(len(live[tn]), int(rng.integers(1, 25)))
            ids = [str(v) for v in rng.choice(live[tn], k, replace=False)]
            ops.append(("delete", tn, ids + [f"absent{next_id}"]))
            live[tn] = [i for i in live[tn] if i not in set(ids)]
        elif r < 0.8:
            ops.append(("checkpoint",))
        elif r < 0.9:
            ops.append(("crash", bool(rng.random() < 0.5)))
        else:
            ops.append(("drop", tn))
            live[tn] = []
    ops.append(("crash", True))
    return ops


def _open(kind, root):
    if kind == "port":
        return InMemoryDataStore(device="cpu", durable_dir=root,
                                 wal_fsync="never")
    return JaxStore(durable_dir=root, wal_fsync="never")


def _apply(store, op):
    if op[0] == "write":
        _, tn, ids, seed, vis = op
        if tn not in store.get_type_names():
            store.create_schema(tn, SPEC if tn == "pts" else PLAIN_SPEC)
        rng = np.random.default_rng(seed)
        data = (_point_data if tn == "pts" else _event_data)(rng, len(ids))
        store.write_dict(tn, ids, data, visibilities=vis)
    elif op[0] == "delete":
        if op[1] in store.get_type_names():
            store.delete(op[1], op[2])
    elif op[0] == "checkpoint":
        store.checkpoint()
    elif op[0] == "drop":
        store.remove_schema(op[1])


@pytest.mark.parametrize("seed", range(8))
def test_seeded_sequences_match_the_reference(tmp_path, seed):
    """The same operations on a port store and a JAX store, each in its
    own directory: after every abort (a torn partial frame appended to
    the last segment half the time) and reopen, both hold the same rows
    in the same order, answer every query with the same ids, and report
    the same recovery."""
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    stores = {k: _open(k, r) for k, r in roots.items()}
    for op in _random_ops(seed):
        if op[0] != "crash":
            for s in stores.values():
                _apply(s, op)
            continue
        for k, s in stores.items():
            s.journal.abort()
            if op[1]:
                _, seg = wal_log.list_segments(
                    os.path.join(roots[k], "log"))[-1]
                with open(seg, "ab") as f:
                    f.write(b"\x07\x00\x00\x00torn")
        stores = {k: _open(k, r) for k, r in roots.items()}
        mine, ref = stores["port"], stores["jax"]
        assert _report(mine.journal.last_report) \
            == _report(ref.journal.last_report)
        assert _state(mine) == _state(ref)
        got, want = _query_ids(mine, ref)
        assert got == want
    for s in stores.values():
        s.close()


def test_reindex_after_recovery(tmp_path):
    """A recovered type's rows carry schema objects of their own; a
    reindex must still reach them. The JAX store raises ValueError
    (schema mismatch) at the next flush after such a reindex, so the
    oracle is a fresh JAX store given the same rows."""
    rng = np.random.default_rng(14)
    ids = [f"f{i}" for i in range(400)]
    data = _point_data(rng, 400)
    more = _point_data(rng, 50)
    for kind in ("port", "jax"):
        ds = _open(kind, str(tmp_path / kind))
        ds.create_schema("pts", SPEC)
        ds.write_dict("pts", ids, data)
        ds.checkpoint()
        ds.close()
    mine = _open("port", str(tmp_path / "port"))
    mine.reindex("pts", 1)
    mine.write_dict("pts", [f"m{i}" for i in range(50)], more)
    ref = _open("jax", str(tmp_path / "jax"))
    ref.reindex("pts", 1)
    with pytest.raises(ValueError, match="schema mismatch"):
        ref.write_dict("pts", [f"m{i}" for i in range(50)], more)
        ref.count("pts")
        ref.query("INCLUDE", "pts")
    fresh = JaxStore()
    fresh.create_schema("pts", SPEC)
    fresh.reindex("pts", 1)
    fresh.write_dict("pts", ids, data)
    fresh.write_dict("pts", [f"m{i}" for i in range(50)], more)
    assert mine.get_schema("pts").index_version == 1
    for _tn, ecql in QUERIES[:4]:
        assert list(mine.query(ecql, "pts").ids) \
            == list(fresh.query(ecql, "pts").ids)
    mine.close()


def test_recovery_deletes_only_held_ids(tmp_path, monkeypatch):
    """Replaying a write of new ids calls no delete; a write of held ids
    deletes just those; rows and order equal the JAX recovery's."""
    root = str(tmp_path / "d")
    p = InMemoryDataStore(device="cpu", durable_dir=root, wal_fsync="never")
    p.create_schema("pts", SPEC)
    rng = np.random.default_rng(4)
    for c in range(5):    # five chunks of new ids
        p.write_dict("pts", [f"c{c}-{i}" for i in range(100)],
                     _point_data(rng, 100))
    p.write_dict("pts", ["c0-1", "c3-7", "new"], _point_data(rng, 3))
    p.journal.abort()
    calls = []
    real = InMemoryDataStore.delete

    def spy(self, type_name, ids):
        calls.append(sorted(map(str, ids)))
        return real(self, type_name, ids)
    monkeypatch.setattr(InMemoryDataStore, "delete", spy)
    mine = InMemoryDataStore(device="cpu", durable_dir=root,
                             wal_fsync="never")
    assert calls == [["c0-1", "c3-7"]]
    ref = JaxStore(durable_dir=root, wal_fsync="never")
    assert _state(mine) == _state(ref)
    assert mine.count("pts") == 501
    assert _report(mine.journal.last_report) \
        == _report(ref.journal.last_report)


def test_replay_into_another_store_raises():
    """Replay reads each type's ids from the store's rows, so a store
    without them is refused before any record applies."""
    sft = parse_spec("pts", SPEC)
    with pytest.raises(TypeError, match="cannot replay into a object"):
        recovery.replay_into(object(),
                             [(1, CREATE_SCHEMA, encode_schema(sft))])


def test_durable_store_wrapper(tmp_path):
    """DurableStore journals before it delegates and replays into a
    fresh inner store."""
    root = str(tmp_path / "w")
    ds = DurableStore(InMemoryDataStore(device="cpu"), root, fsync="never")
    ds.create_schema("pts", SPEC)
    rng = np.random.default_rng(6)
    ds.write_dict("pts", [f"f{i}" for i in range(50)], _point_data(rng, 50))
    ds.delete("pts", ["f3", "f4"])
    ds.checkpoint()
    ds.write_dict("pts", ["f3", "z"], _point_data(rng, 2))
    want = list(ds.query("INCLUDE", "pts").ids)
    ds.journal.abort()
    re = DurableStore(InMemoryDataStore(device="cpu"), root, fsync="never")
    assert list(re.query("INCLUDE", "pts").ids) == want
    assert re.recovery.checkpoint_lsn > 0 and re.count("pts") == 50
    with pytest.raises(ValueError, match="already exists"):
        re.create_schema("pts", SPEC)
    re.close()


# -- faults ---------------------------------------------------------------

def _small_store(tmp_path, policy="always"):
    ds = InMemoryDataStore(device="cpu", durable_dir=str(tmp_path / "d"),
                           wal_fsync=policy)
    ds.create_schema("pts", SPEC)
    ds.write_dict("pts", ["a", "b", "c"],
                  _point_data(np.random.default_rng(8), 3))
    return ds


MUTATIONS = [
    ("write", lambda ds: ds.write_dict(
        "pts", ["x"], _point_data(np.random.default_rng(9), 1))),
    ("delete", lambda ds: ds.delete("pts", ["a"])),
    ("create_schema", lambda ds: ds.create_schema("other", SPEC)),
    ("remove_schema", lambda ds: ds.remove_schema("pts")),
    ("checkpoint", lambda ds: ds.checkpoint()),
]


@pytest.mark.parametrize("name,mutate", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_failed_fsync_poisons_and_leaves_the_store_unchanged(
        tmp_path, name, mutate):
    """A failed fsync poisons the log: the write that hit it and every
    later mutation raise DurabilityError before any state changes; the
    store keeps serving reads; a reopen recovers every acked row."""
    ds = _small_store(tmp_path)
    before = _state(ds)
    with FaultDisk().add("fsync", match="log", kind="fsync") as disk:
        with pytest.raises(DurabilityError):
            ds.write_dict("pts", ["x"],
                          _point_data(np.random.default_rng(9), 1))
    assert disk.injected and ds.journal.poisoned
    with pytest.raises(DurabilityError):
        mutate(ds)
    assert _state(ds) == before
    assert ds.get_type_names() == ["pts"]
    assert sorted(ds.query("INCLUDE", "pts").ids) == ["a", "b", "c"]
    ds.close()   # skips the doomed sync
    re = InMemoryDataStore(device="cpu", durable_dir=str(tmp_path / "d"),
                           wal_fsync="always")
    assert {"a", "b", "c"} <= set(re.query("INCLUDE", "pts").ids) \
        <= {"a", "b", "c", "x"}
    assert not re.journal.poisoned
    re.write_dict("pts", ["new"], _point_data(np.random.default_rng(1), 1))
    re.close()


@pytest.mark.parametrize("kind", ["eio", "enospc"])
def test_failed_append_poisons(tmp_path, kind):
    ds = _small_store(tmp_path, policy="never")
    with FaultDisk().add("write", match="log", kind=kind):
        with pytest.raises(DurabilityError):
            ds.delete("pts", ["a"])
    with pytest.raises(DurabilityError):
        ds.delete("pts", ["b"])
    assert ds.count("pts") == 3
    ds.journal.abort()


def _two_checkpoints(tmp_path, kind):
    ds = _open(kind, str(tmp_path / kind))
    rng = np.random.default_rng(10)
    ds.create_schema("pts", SPEC)
    ds.write_dict("pts", [f"a{i}" for i in range(30)], _point_data(rng, 30))
    ds.checkpoint()
    ds.write_dict("pts", [f"b{i}" for i in range(30)], _point_data(rng, 30))
    ds.checkpoint()
    ds.write_dict("pts", ["tail"], _point_data(rng, 1))
    ds.close()
    return str(tmp_path / kind)


@pytest.mark.parametrize("all_corrupt", [False, True])
def test_bit_flipped_checkpoint_falls_back(tmp_path, all_corrupt):
    """A bit-flipped newest checkpoint is skipped (and quarantined) and
    recovery loads the prior one; with every checkpoint corrupt it
    replays the whole log. Both packages report the same."""
    reports, states = [], []
    for kind in ("port", "jax"):
        root = _two_checkpoints(tmp_path, kind)
        dirs = checkpoint_dirs(root)
        for _lsn, path in (dirs if all_corrupt else dirs[-1:]):
            flip_bit(os.path.join(path, "pts.bin"))
        re = _open(kind, root)
        reports.append(_report(re.journal.last_report))
        states.append(_state(re))
        re.close()
        assert len(checkpoint_dirs(root)) == (0 if all_corrupt else 1)
        assert os.path.exists(dirs[-1][1] + ".corrupt")
    assert reports[0] == reports[1]
    assert reports[0]["checkpoints_skipped"] == (2 if all_corrupt else 1)
    assert states[0] == states[1]
    assert states[0]["pts"][0]["ids"][-1] == "tail"


def test_checkpoint_readback_guards_truncation(tmp_path):
    """A checkpoint bit-flipped on its way to disk fails read-back:
    OSError, the log is not truncated, recovery replays it all."""
    ds = _small_store(tmp_path, policy="never")
    want = _state(ds)
    with FaultDisk().add("write", match="pts.bin", kind="bitflip"):
        with pytest.raises(OSError, match="read-back"):
            ds.checkpoint()
    ds.close()
    re = InMemoryDataStore(device="cpu", durable_dir=str(tmp_path / "d"))
    assert re.journal.last_report.checkpoint_lsn == 0
    assert _state(re) == want
    re.close()


def test_torn_checkpoint_write_leaves_only_debris(tmp_path):
    ds = _small_store(tmp_path, policy="never")
    ds.checkpoint()
    ds.write_dict("pts", ["d"], _point_data(np.random.default_rng(2), 1))
    with FaultDisk().add("write", match="snapshots", kind="torn"):
        with pytest.raises(faultfs.CrashPoint):
            ds.checkpoint()
    snap = str(tmp_path / "d" / "snapshots")
    assert sum(d.endswith(".tmp") for d in os.listdir(snap)) == 1
    assert len(checkpoint_dirs(str(tmp_path / "d"))) == 1
    want = _state(ds)
    ds.close()
    re = InMemoryDataStore(device="cpu", durable_dir=str(tmp_path / "d"))
    assert _state(re) == want
    re.close()


def test_verify_matches_the_reference(tmp_path):
    """verify_checkpoint and verify_wal read a directory as the JAX
    package's do: clean, bit rot, a truncated file, a mid-history
    corrupt segment."""
    root = str(tmp_path / "d")
    ds = DurableStore(InMemoryDataStore(device="cpu"), root, fsync="never",
                      segment_bytes=2048)
    ds.create_schema("pts", SPEC)
    rng = np.random.default_rng(12)
    ds.write_dict("pts", [f"f{k}" for k in range(50)], _point_data(rng, 50))
    ds.checkpoint()
    for i in range(12):
        ds.write_dict("pts", [f"f{i}-{k}" for k in range(5)],
                      _point_data(rng, 5))
    ds.close()
    ckpt = checkpoint_dirs(root)[-1][1]
    logdir = os.path.join(root, "log")

    def same():
        a, b = verify_checkpoint(ckpt), jax_verify.verify_checkpoint(ckpt)
        assert a == b
        c, d = verify_wal(logdir), jax_verify.verify_wal(logdir)
        assert c == d
        return a, c
    ok, wal_ok = same()
    assert ok["ok"] and wal_ok["ok"] and wal_ok["segments"] >= 3
    with open(os.path.join(ckpt, "junk"), "w") as f:
        f.write("x")
    assert same()[0]["unreferenced"] == ["junk"]
    flip_bit(os.path.join(ckpt, "pts.bin"))
    assert not same()[0]["ok"]
    with open(os.path.join(ckpt, "pts.bin"), "r+b") as f:
        f.truncate(10)
    assert not same()[0]["ok"]
    segs = wal_log.list_segments(logdir)
    flip_bit(segs[0][1])
    assert not same()[1]["ok"]


def test_group_commit_under_threads(tmp_path):
    """Appenders on many threads under the "always" policy: every record
    lands once, in LSN order, and the fsyncs never outnumber them."""
    import sys
    reg = MetricsRegistry()
    wal = WriteAheadLog(str(tmp_path / "g"), fsync="always", registry=reg)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    lsns: list = []
    lock = threading.Lock()

    def work(t):
        for i in range(25):
            lsn = wal.append(WRITE, f"{t}:{i}".encode())
            with lock:
                lsns.append(lsn)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(lsns) == list(range(1, 401))
    assert wal.durable_lsn == 400
    fsyncs = reg.snapshot()["counters"]["wal.fsyncs"]
    assert 1 <= fsyncs <= 400
    wal.close()
    recs = list(WriteAheadLog(str(tmp_path / "g"), fsync="never").records())
    assert [r[0] for r in recs] == list(range(1, 401))
    assert sorted(r[2] for r in recs) == sorted(
        f"{t}:{i}".encode() for t in range(16) for i in range(25))


def test_interval_policy_and_properties(tmp_path, monkeypatch):
    """The fsync policy comes from geomesa.wal.fsync when not given;
    the interval flusher makes appends durable within its cadence."""
    monkeypatch.setenv("GEOMESA_WAL_FSYNC", "interval")
    monkeypatch.setenv("GEOMESA_WAL_INTERVAL_MS", "5")
    j = Journal(str(tmp_path / "i"), registry=MetricsRegistry())
    assert j.wal.fsync_policy == "interval" and j.wal.interval_ms == 5.0
    lsn = j.wal.append(WRITE, b"x")
    for _ in range(400):
        if j.wal.durable_lsn >= lsn:
            break
        threading.Event().wait(0.005)
    assert j.wal.durable_lsn == lsn
    j.close()
    monkeypatch.setenv("GEOMESA_WAL_FSYNC", "sometimes")
    with pytest.raises(ValueError, match="unknown fsync policy"):
        WriteAheadLog(str(tmp_path / "bad"))


@pytest.mark.parametrize("kind", ["eio", "enospc", "torn", "bitflip",
                                  "fsync"])
def test_fault_disk_kinds(tmp_path, kind):
    """Each fault fires once on its matching call, as the reference's
    fault disk does, and the pass-through is untouched when none is
    armed."""
    path = str(tmp_path / "f.bin")
    data = bytes(range(64))
    op = "fsync" if kind == "fsync" else "write"
    disk = FaultDisk().add(op, match="f.bin", kind=kind, skip=1)
    with disk, open(path, "wb") as f:
        faultfs.write(f, data, path)          # skipped: passes through
        faultfs.fsync(f.fileno(), path) if op == "fsync" else None
        err = {"eio": OSError, "enospc": OSError, "torn": faultfs.CrashPoint,
               "fsync": OSError}.get(kind)
        if err is None:
            faultfs.write(f, data, path)      # bit flip: silent
        else:
            with pytest.raises(err):
                if op == "fsync":
                    faultfs.fsync(f.fileno(), path)
                else:
                    faultfs.write(f, data, path)
        faultfs.write(f, data, path)          # spent: passes through
    assert disk.injected == [(op, path, kind)] and disk.pending() == 0
    with open(path, "rb") as f:
        raw = f.read()
    middle = {"eio": b"", "enospc": b"", "torn": data[:32],
              "fsync": b"", "bitflip": data[:32] + bytes([data[32] ^ 1])
              + data[33:]}[kind]
    assert raw == data + middle + data
    assert faultfs.active() is None


# -- the z-key index's persisted state -------------------------------------

@pytest.mark.parametrize("dtg", [True, False])
@pytest.mark.parametrize("version", [1, 2])
def test_index_state_matches_the_reference(dtg, version):
    """state_dict holds the JAX index's keys, dtypes and arrays; each
    package's state loads in the other; a stale state or one of another
    version installs nothing."""
    rng = np.random.default_rng(version)
    n = 5000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = 1_577_836_800_000 + rng.integers(0, 90 * MS_DAY, n) if dtg else None
    mine = ZKeyIndex(x, y, ms, "week", version=version)
    ref = JaxZKeyIndex(x, y, ms, "week", version=version)
    assert mine.state_dict() == {} and ref.state_dict() == {}
    mine._build_z2()
    mine._build_z3()
    ref.warm()
    a, b = mine.state_dict(), ref.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    fresh, jfresh = (ZKeyIndex(x, y, ms, "week", version=version),
                     JaxZKeyIndex(x, y, ms, "week", version=version))
    assert fresh.load_state(b) and jfresh.load_state(a)
    assert all(np.array_equal(fresh.state_dict()[k], b[k]) for k in b)
    boxes = [(-80.0, 30.0, -60.0, 45.0)]
    iv = [(1_577_836_800_000 + MS_DAY, 1_577_836_800_000 + 40 * MS_DAY)] \
        if dtg else []
    for name in (["z3"] if dtg else []) + ["z2"]:
        got = fresh.query_rows(name, boxes, iv, None, None)
        want = mine.query_rows(name, boxes, iv, None, None)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    stale = ZKeyIndex(x[:-1], y[:-1], None if ms is None else ms[:-1],
                      "week", version=version)
    assert not stale.load_state(b) and stale.state_dict() == {}
    other = ZKeyIndex(x, y, ms, "week", version=3 - version)
    assert not other.load_state(b) and other.state_dict() == {}
    assert not JaxZKeyIndex(x, y, ms, "week",
                            version=3 - version).load_state(a)


def test_store_index_state_and_warm_index():
    """index_state exports the built orders; warm_index installs them
    into the next build when they cover its rows, and a stale state
    changes nothing; query ids stay those of the JAX store."""
    rng = np.random.default_rng(13)
    ids = [f"f{i}" for i in range(3000)]
    data = _point_data(rng, 3000)
    ds = InMemoryDataStore(device="cpu")
    ds.create_schema("pts", SPEC)
    assert ds.index_state("pts") is None
    ds.write_dict("pts", ids, data)
    q = ("BBOX(geom, -100, -50, 100, 50) AND dtg DURING "
         "2020-01-05T00:00:00Z/2020-02-10T00:00:00Z")
    want = list(ds.query(q, "pts").ids)
    state = ds.index_state("pts")
    assert "z3_perm" in state and state["index_version"][0] == 2
    for rows, adopted in ((3000, True), (2999, False)):
        re = InMemoryDataStore(device="cpu")
        re.create_schema("pts", SPEC)
        re.write_dict("pts", ids[:rows],
                      {k: (v[0][:rows], v[1][:rows]) if k == "geom"
                       else v[:rows] for k, v in data.items()})
        re.warm_index("pts", state)
        got = list(re.query(q, "pts").ids)
        st = re._types["pts"]
        assert st.zindex_warm is None
        assert (st.zindex._z3 is not None
                and st.zindex._z3[3] is state["z3_perm"]) == adopted
        if adopted:
            assert got == want
    jds = JaxStore()
    jds.create_schema("pts", SPEC)
    jds.write_dict("pts", ids, data)
    assert list(jds.query(q, "pts").ids) == want
    with pytest.raises(ValueError, match="not durable"):
        ds.checkpoint()


def test_warm_index_dropped_by_a_same_count_update(monkeypatch):
    """An update that keeps the row count (delete k ids, write them at
    new positions) drops a warm state installed before it: the next
    build sorts the rows the table has, and the index-pruned tier's ids
    equal those of a JAX store given the same operations without the
    state. Exact."""
    # the index-pruned device tier in both packages, small as the table is
    monkeypatch.setenv("GEOMESA_SCAN_HOST_ROWS", "0")
    monkeypatch.setenv("GEOMESA_SCAN_INDEX_THRESHOLD", "1.0")
    rng = np.random.default_rng(14)
    ids = [f"f{i}" for i in range(3000)]
    data = _point_data(rng, 3000)
    moved, moved_data = ids[:400], _point_data(rng, 400)
    q = ("BBOX(geom, -100, -50, 100, 50) AND dtg DURING "
         "2020-01-05T00:00:00Z/2020-02-10T00:00:00Z")
    ds = InMemoryDataStore(device="cpu")
    ds.create_schema("pts", SPEC)
    ds.write_dict("pts", ids, data)
    ds.query(q, "pts")
    state = ds.index_state("pts")
    re, jds = InMemoryDataStore(device="cpu"), JaxStore()
    for store in (re, jds):
        store.create_schema("pts", SPEC)
        store.write_dict("pts", ids, data)
        if store is re:
            store.warm_index("pts", state)
        store.delete("pts", moved)
        store.write_dict("pts", moved, moved_data)
    assert re.count("pts") == 3000
    res = re.query(q, "pts")
    assert "Index-pruned device scan" in res.explain.text
    assert list(res.ids) == list(jds.query(q, "pts").ids)
    st = re._types["pts"]
    assert st.zindex_warm is None and st.zindex._z3[3] is not state["z3_perm"]


def test_filebus_atomic_writes(tmp_path):
    """write_bytes_atomic/write_json_atomic leave no tmp file and route
    through the fault disk under the destination's name."""
    path = str(tmp_path / "m.json")
    filebus.write_json_atomic(path, {"a": 1})
    with open(path) as f:
        assert f.read() == '{"a": 1}'
    with FaultDisk().add("write", match="m.json", kind="eio"):
        with pytest.raises(OSError):
            filebus.write_bytes_atomic(path, b"zz")
    with open(path) as f:
        assert f.read() == '{"a": 1}'
    assert sorted(os.listdir(tmp_path))[0] == "m.json"
    assert filebus.segment_name(42) == "000000000042.msg"
