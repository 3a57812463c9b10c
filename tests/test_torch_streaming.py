"""The port's streaming tiers (geomesa_tpu_torch/store/live.py,
filebus.py, socketbus.py, stream.py, lambda_store.py, continuous.py and
resilience/policy.py) against the JAX package's, on the CPU.

Each scenario is a case of the JAX package's own tests
(tests/test_filebus.py, test_socketbus.py, test_stream.py,
test_streaming.py's TestContinuousQueries, test_fs_store.py's
TestLiveStore, TestLambdaStore and its lambda regressions, and
test_wal.py's live and lambda durability cases). It runs once in each
package on the same writes (the port's stores on device="cpu"), keeps
the JAX test's assertions in both, and returns what it saw; the two
packages' answers must be equal. Across packages: a FileBus root and a
SocketBroker root written by either are replayed by the other, each
package's SocketBus talks to the other's broker, and a durable live
directory recovers in the other package.

Sockets: every broker binds port 0 (or a port it held), is stopped in a
``finally``, and every wait has its own timeout of 10 s or less; no
assertion is on a time. Tolerance: exact (ids, messages, offsets,
column values)."""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
MS = lambda s: int(np.datetime64(s, "ms").astype(np.int64))  # noqa: E731
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _api(pkg: str):
    """One package's streaming surface, the port's stores on the CPU."""
    if pkg == "jax":
        from geomesa_tpu import store as st
        from geomesa_tpu.features import FeatureBatch, parse_spec
        from geomesa_tpu.index.api import Query
        from geomesa_tpu.scan.aggregations import decode_bin_records
        from geomesa_tpu.store import continuous, filebus, lambda_store, live
        from geomesa_tpu.store import socketbus, stream
        dev = {}
    else:
        from geomesa_tpu_torch import store as st
        from geomesa_tpu_torch.features import FeatureBatch, parse_spec
        from geomesa_tpu_torch.index.api import Query
        from geomesa_tpu_torch.scan.aggregations import decode_bin_records
        from geomesa_tpu_torch.store import (continuous, filebus,
                                             lambda_store, live, socketbus,
                                             stream)
        dev = {"device": "cpu"}
    return types.SimpleNamespace(
        pkg=pkg, parse_spec=parse_spec, FeatureBatch=FeatureBatch,
        Query=Query, decode_bin_records=decode_bin_records,
        GeoMessage=live.GeoMessage, MessageBus=live.MessageBus,
        Live=lambda *a, **k: live.LiveDataStore(*a, **dev, **k),
        Lambda=lambda *a, **k: lambda_store.LambdaDataStore(*a, **dev, **k),
        Memory=lambda **k: st.InMemoryDataStore(**dev, **k),
        Stream=lambda *a, **k: stream.StreamDataStore(*a, **dev, **k),
        FileTailSource=stream.FileTailSource,
        IterableSource=stream.IterableSource,
        FileBus=filebus.FileBus, encode=filebus._encode,
        decode=filebus._decode, SocketBroker=socketbus.SocketBroker,
        SocketBus=socketbus.SocketBus, ProtocolError=socketbus.ProtocolError,
        Publisher=continuous.ContinuousQueryPublisher,
        Subscriber=continuous.ContinuousQuerySubscriber,
        PUBLISH_ROWS=continuous.CQ_PUBLISH_BATCH_ROWS,
        PERSISTENT=lambda_store.LAMBDA_QUERY_PERSISTENT,
        TRANSIENT=lambda_store.LAMBDA_QUERY_TRANSIENT)


APIS = {}


def api(pkg):
    if pkg not in APIS:
        APIS[pkg] = _api(pkg)
    return APIS[pkg]


def make_batch(a, ids, xs, ys, type_name="live"):
    sft = a.parse_spec(type_name, SPEC)
    n = len(ids)
    return a.FeatureBatch.from_dict(sft, ids, {
        "name": [f"n{i}" for i in range(n)],
        "dtg": np.full(n, MS("2024-01-01")),
        "geom": (np.asarray(xs, float), np.asarray(ys, float))})


def ids_of(res):
    return sorted(str(i) for i in res.ids)


def msg_key(m):
    """A GeoMessage as plain values: kind, type, ids, timestamp, labels
    and the batch's ids and columns."""
    rows = None
    if m.batch is not None:
        rows = (m.batch.ids.astype(str).tolist(),
                m.batch.to_arrow().to_pydict())
    return (m.kind, m.type_name, tuple(m.ids), m.timestamp_ms,
            m.visibilities, rows)


def both(scenario, *args):
    """Run a scenario in both packages; their answers must be equal."""
    got = {pkg: scenario(api(pkg), *args) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    return got["torch"]


# -- the wire format and the file bus (tests/test_filebus.py) ---------------

def fb_roundtrip_create(a, tmp):
    msg = a.GeoMessage("create", "live", make_batch(a, ["a", "b"], [1.0, 2.0],
                                                    [3.0, 4.0]),
                       timestamp_ms=1234)
    raw = a.encode(msg)
    out = a.decode(raw)
    assert out.kind == "create" and out.timestamp_ms == 1234
    assert out.batch.ids.tolist() == ["a", "b"]
    assert out.batch.col("geom").x.tolist() == [1.0, 2.0]
    assert out.batch.col("name").value(0) == "n0"
    return msg_key(out), raw


def fb_roundtrip_delete_clear(a, tmp):
    msg = a.decode(a.encode(a.GeoMessage("delete", "live", ids=("x", "y"))))
    assert msg.kind == "delete" and msg.ids == ("x", "y")
    assert msg.batch is None
    assert a.decode(a.encode(a.GeoMessage("clear", "live"))).kind == "clear"
    return msg_key(msg)


def fb_visibilities_roundtrip(a, tmp):
    sft = a.parse_spec("t", "v:Integer,*geom:Point")
    batch = a.FeatureBatch.from_dict(
        sft, np.array(["a", "b"], dtype=object),
        {"v": [1, 2], "geom": ([0.0, 1.0], [0.0, 1.0])})
    out = a.decode(a.encode(a.GeoMessage("create", "t", batch,
                                         timestamp_ms=5,
                                         visibilities=("admin", None))))
    assert out.visibilities == ("admin", None) and out.batch.n == 2
    out2 = a.decode(a.encode(a.GeoMessage("create", "t", batch)))
    assert out2.visibilities is None
    return msg_key(out), msg_key(out2)


def fb_publish_poll_apply(a, tmp):
    bus = a.FileBus(tmp)
    producer = a.Live(bus=a.FileBus(tmp, group="prod"))
    producer.create_schema(a.parse_spec("live", SPEC))
    consumer = a.Live(bus=bus)
    consumer.create_schema(a.parse_spec("live", SPEC))
    producer.write("live", make_batch(a, ["a", "b"], [0, 1], [0, 1]))
    assert consumer.count("live") == 0  # nothing until poll
    assert consumer.poll() == 1
    assert consumer.count("live") == 2
    producer.delete("live", ["a"])
    consumer.poll()
    got = ids_of(consumer.query("INCLUDE", "live"))
    assert got == ["b"]
    return got, bus.offset("live")


def fb_offsets_checkpoint_and_resume(a, tmp):
    bus = a.FileBus(tmp, group="g1")
    store = a.Live(bus=bus)
    store.create_schema(a.parse_spec("live", SPEC))
    store.write("live", make_batch(a, ["a"], [0], [0]))
    bus.poll()
    assert bus.offset("live") == 1
    bus2 = a.FileBus(tmp, group="g1")
    assert bus2.offset("live") == 1
    store2 = a.Live(bus=bus2)
    store2.create_schema(a.parse_spec("live", SPEC))
    assert store2.poll() == 0
    store3 = a.Live(bus=a.FileBus(tmp, group="g2"))
    store3.create_schema(a.parse_spec("live", SPEC))
    assert store3.poll() == 1
    assert store3.count("live") == 1
    return ids_of(store3.query("INCLUDE", "live"))


def fb_no_double_delivery_after_auto_create(a, tmp):
    prod = a.Live(bus=a.FileBus(tmp, group="p"))
    prod.create_schema(a.parse_spec("live", SPEC))
    cons_bus = a.FileBus(tmp, group="c")
    cons = a.Live(bus=cons_bus)
    cons_bus.subscribe("live", cons._on_message)
    events = []
    prod.write("live", make_batch(a, ["a"], [0], [0]))
    cons_bus.poll()  # triggers auto-create; must not re-subscribe
    cons.add_listener("live", lambda m: events.append(m.kind))
    prod.write("live", make_batch(a, ["b"], [1], [1]))
    cons_bus.poll()
    assert events == ["create"]
    assert cons.count("live") == 2
    return events, ids_of(cons.query("INCLUDE", "live"))


def fb_stale_claim_skipped(a, tmp):
    bus = a.FileBus(tmp)
    store = a.Live(bus=bus)
    store.create_schema(a.parse_spec("live", SPEC))
    store.write("live", make_batch(a, ["a"], [0], [0]))
    stale = os.path.join(tmp, "topics", "live", f"{2:012d}.msg")
    open(stale, "w").close()
    old = os.path.getmtime(stale) - 60
    os.utime(stale, (old, old))
    store.write("live", make_batch(a, ["b"], [1], [1]))  # becomes seq 3
    assert bus.poll() == 2
    assert store.count("live") == 2
    return bus.offset("live")


def fb_corrupt_message_skipped_after_grace(a, tmp):
    bus = a.FileBus(tmp)
    store = a.Live(bus=bus)
    store.create_schema(a.parse_spec("live", SPEC))
    store.write("live", make_batch(a, ["a"], [0], [0]))
    bus.poll()
    bad = os.path.join(tmp, "topics", "live", f"{2:012d}.msg")
    with open(bad, "wb") as f:
        f.write(b"\x00\x01garbage")
    old = os.path.getmtime(bad) - 60
    os.utime(bad, (old, old))
    store.write("live", make_batch(a, ["b"], [1], [1]))  # seq 3
    assert bus.poll() == 1
    assert store.count("live") == 2
    assert bus.offset("live") == 3
    assert a.FileBus(tmp, group=bus.group).offset("live") == 3
    return ids_of(store.query("INCLUDE", "live"))


def fb_poll_max_messages_cap(a, tmp):
    bus = a.FileBus(tmp)
    got = []
    bus.subscribe("t1", got.append)
    bus.subscribe("t2", got.append)
    pub = a.FileBus(tmp, group="w")
    seqs = [pub.publish(t, a.GeoMessage("clear", t))
            for t in ("t1", "t2") for _ in range(5)]
    assert bus.poll(max_messages=3) == 3
    assert len(got) == 3
    assert bus.poll() == 7
    return seqs, [msg_key(m) for m in got]


def fb_delete_for_unknown_type_is_noop(a, tmp):
    prod = a.Live(bus=a.FileBus(tmp, group="p"))
    prod.create_schema(a.parse_spec("live", SPEC))
    prod.delete("live", ["ghost"])
    prod.write("live", make_batch(a, ["a"], [0], [0]))
    cons_bus = a.FileBus(tmp, group="c")
    cons = a.Live(bus=cons_bus)
    cons_bus.subscribe("live", cons._on_message)
    assert cons_bus.poll() == 2
    assert cons.count("live") == 1
    return ids_of(cons.query("INCLUDE", "live"))


def fb_consumer_auto_creates_schema(a, tmp):
    prod = a.Live(bus=a.FileBus(tmp, group="p"))
    prod.create_schema(a.parse_spec("live", SPEC))
    prod.write("live", make_batch(a, ["a"], [0], [0]))
    cons_bus = a.FileBus(tmp, group="c")
    cons = a.Live(bus=cons_bus)
    cons_bus.subscribe("live", cons._on_message)
    cons_bus.poll()
    assert cons.count("live") == 1
    assert cons.get_schema("live").geom_field == "geom"
    return ids_of(cons.query("INCLUDE", "live"))


FILEBUS = [fb_roundtrip_create, fb_roundtrip_delete_clear,
           fb_visibilities_roundtrip, fb_publish_poll_apply,
           fb_offsets_checkpoint_and_resume,
           fb_no_double_delivery_after_auto_create, fb_stale_claim_skipped,
           fb_corrupt_message_skipped_after_grace, fb_poll_max_messages_cap,
           fb_delete_for_unknown_type_is_noop,
           fb_consumer_auto_creates_schema]


@pytest.mark.parametrize("scenario", FILEBUS, ids=lambda f: f.__name__)
def test_filebus(scenario, tmp_path):
    both(lambda a: scenario(a, str(tmp_path / a.pkg)))


_WRITER = r"""
import sys
import numpy as np
from geomesa_tpu_torch.features import parse_spec
from geomesa_tpu_torch.store.{mod} import {bus}
from geomesa_tpu_torch.store.live import LiveDataStore

args, n = sys.argv[1:-1], int(sys.argv[-1])
store = LiveDataStore(bus={bus}(*args, group="writer"), device="cpu")
sft = parse_spec("live", "name:String,dtg:Date,*geom:Point:srid=4326")
store.create_schema(sft)
ms = int(np.datetime64("2024-01-01", "ms").astype(np.int64))
for k in range(3):
    ids = [f"w{{k}}-{{i}}" for i in range(n)]
    store.write_dict("live", ids, {{
        "name": [f"x{{i}}" for i in range(n)],
        "dtg": np.full(n, ms),
        "geom": (np.linspace(0, 10, n), np.linspace(0, 10, n)),
    }})
store.delete("live", ["w0-0"])
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "geomesa_tpu" or m.startswith("geomesa_tpu.")]
print("WROTE", ",".join(bad))
"""


def _run_writer(mod, bus, *args):
    """The writer process: imports only geomesa_tpu_torch."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _WRITER.format(mod=mod, bus=bus), *args, "5"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "WROTE "   # no jax, no reference


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_filebus_writer_subprocess_feeds_reader(pkg, tmp_path):
    a = api(pkg)
    root = str(tmp_path / "bus")
    reader = a.Live(bus=a.FileBus(root, group="reader"))
    reader.create_schema(a.parse_spec("live", SPEC))
    _run_writer("filebus", "FileBus", root)
    assert reader.bus.wait_for(lambda: reader.count("live") == 14,
                               timeout_s=10)
    ids = set(ids_of(reader.query("INCLUDE", "live")))
    assert "w0-0" not in ids and "w2-4" in ids
    assert reader.query("BBOX(geom, -1, -1, 5, 5)", "live").n > 0


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_filebus_root_replays_across_packages(writer, reader, tmp_path):
    """A root one package wrote (creates with labels, deletes, clears,
    two topics, a consumer group's offsets) is replayed by the other
    with equal messages and offsets, and both resume alike."""
    w, r = api(writer), api(reader)
    root = str(tmp_path / "bus")
    pub = w.FileBus(root, group="w")
    sent = []
    for k in range(3):
        m = w.GeoMessage("create", "live",
                         make_batch(w, [f"a{k}", f"b{k}"], [k, k + 1],
                                    [0, 1]), timestamp_ms=10 + k,
                         visibilities=("x", None))
        sent.append(msg_key(m))
        pub.publish("live", m)
    for m in (w.GeoMessage("delete", "live", ids=("a0",), timestamp_ms=20),
              w.GeoMessage("clear", "other", timestamp_ms=21)):
        sent.append(msg_key(m))
        pub.publish("live" if m.kind == "delete" else "other", m)
    consumed = w.FileBus(root, group="g")
    consumed.subscribe("live", lambda m: None)
    assert consumed.poll(max_messages=2) == 2
    got, resumed = [], []
    rb = r.FileBus(root, group="fresh")
    rb.subscribe("live", lambda m: got.append(msg_key(m)))
    rb.subscribe("other", lambda m: got.append(msg_key(m)))
    assert rb.poll() == 5
    assert got == sent
    rg = r.FileBus(root, group="g")
    assert rg.offset("live") == 2
    rg.subscribe("live", lambda m: resumed.append(msg_key(m)))
    assert rg.poll() == 2 and resumed == sent[2:4]
    assert r.FileBus(root, group="w").publish(
        "live", r.GeoMessage("clear", "live")) == 5


# -- the socket bus (tests/test_socketbus.py) --------------------------------

class _Broker:
    """A broker on port 0 that is stopped whatever happens."""

    def __init__(self, a, **kw):
        self.a, self.kw = a, kw

    def __enter__(self):
        self.b = self.a.SocketBroker(**self.kw).start()
        return self.b

    def __exit__(self, *exc):
        self.b.stop()


def _bus(a, b, group, **kw):
    return a.SocketBus(b.host, b.port, group=group, timeout_s=10.0, **kw)


def sb_publish_poll_apply(a, tmp):
    with _Broker(a) as b:
        producer = a.Live(bus=_bus(a, b, "prod"))
        producer.create_schema(a.parse_spec("live", SPEC))
        consumer = a.Live(bus=_bus(a, b, "cons"))
        consumer.create_schema(a.parse_spec("live", SPEC))
        producer.write("live", make_batch(a, ["a", "b"], [0, 1], [0, 1]))
        assert consumer.count("live") == 0
        assert consumer.poll() == 1
        assert consumer.count("live") == 2
        producer.delete("live", ["a"])
        consumer.poll()
        got = ids_of(consumer.query("INCLUDE", "live"))
        assert got == ["b"]
        return got, consumer.bus.offset("live")


def sb_offsets_resume_across_reconnect(a, tmp):
    with _Broker(a) as b:
        bus = _bus(a, b, "g1")
        store = a.Live(bus=bus)
        store.create_schema(a.parse_spec("live", SPEC))
        store.write("live", make_batch(a, ["a"], [0], [0]))
        bus.poll()
        assert bus.offset("live") == 1
        bus2 = _bus(a, b, "g1")
        assert bus2.offset("live") == 1
        store2 = a.Live(bus=bus2)
        store2.create_schema(a.parse_spec("live", SPEC))
        assert store2.poll() == 0
        store3 = a.Live(bus=_bus(a, b, "g2"))
        store3.create_schema(a.parse_spec("live", SPEC))
        assert store3.poll() == 1
        assert store3.count("live") == 1
        return ids_of(store3.query("INCLUDE", "live"))


def sb_consumer_auto_creates_schema(a, tmp):
    with _Broker(a) as b:
        prod = a.Live(bus=_bus(a, b, "p"))
        prod.create_schema(a.parse_spec("live", SPEC))
        prod.write("live", make_batch(a, ["a"], [0], [0]))
        cons_bus = _bus(a, b, "c")
        cons = a.Live(bus=cons_bus)
        cons_bus.subscribe("live", cons._on_message)
        cons_bus.poll()
        assert cons.count("live") == 1
        assert cons.get_schema("live").geom_field == "geom"
        return ids_of(cons.query("INCLUDE", "live"))


def _parked_poll(a, b, cons, publisher_bus, topic):
    """Park a long poll, publish to ``topic`` from ``publisher_bus`` while
    it is parked, and return what the poll delivered."""
    result = {}
    th = threading.Thread(
        target=lambda: result.setdefault("n", cons.poll(wait_s=5.0)))
    th.start()
    time.sleep(0.3)  # the consumer is parked in the broker
    publisher_bus.publish(topic, a.GeoMessage("clear", topic))
    th.join(timeout=10)
    assert not th.is_alive()
    return result.get("n")


def sb_long_poll_wakes_on_publish(a, tmp):
    with _Broker(a) as b:
        cons = _bus(a, b, "lp")
        got = []
        cons.subscribe("t", got.append)
        n = _parked_poll(a, b, cons, _bus(a, b, "pub"), "t")
        assert n == 1 and len(got) == 1
        return n, [msg_key(m) for m in got]


def sb_wakes_on_publish_to_any_subscribed_topic(a, tmp):
    with _Broker(a) as b:
        cons = _bus(a, b, "multi")
        got = []
        cons.subscribe("t1", got.append)
        cons.subscribe("t2", got.append)
        n = _parked_poll(a, b, cons, _bus(a, b, "p"), "t2")
        assert n == 1 and len(got) == 1
        return n, [msg_key(m) for m in got]


def sb_same_bus_publish_does_not_block_behind_parked_poll(a, tmp):
    with _Broker(a) as b:
        bus = _bus(a, b, "shared")
        got = []
        bus.subscribe("t", got.append)
        n = _parked_poll(a, b, bus, bus, "t")    # the same SocketBus
        assert n == 1
        return n, [msg_key(m) for m in got]


def sb_poll_max_messages_cap(a, tmp):
    with _Broker(a) as b:
        bus = _bus(a, b, "cap")
        got = []
        bus.subscribe("t1", got.append)
        bus.subscribe("t2", got.append)
        pub = _bus(a, b, "w")
        seqs = [pub.publish(t, a.GeoMessage("clear", t))
                for t in ("t1", "t2") for _ in range(5)]
        assert bus.poll(max_messages=3) == 3
        assert len(got) == 3
        assert bus.poll() == 7
        return seqs, [msg_key(m) for m in got]


def sb_broker_restart_replays_filebus_layout(a, tmp):
    root = os.path.join(tmp, "log")
    with _Broker(a, root=root) as b1:
        bus = _bus(a, b1, "g")
        bus.publish("live", a.GeoMessage(
            "create", "live", make_batch(a, ["a"], [0], [0]),
            timestamp_ms=1))
        bus.publish("live", a.GeoMessage("delete", "live", ids=("x",)))
    fb = a.FileBus(root, group="fbreader")
    seen = []
    fb.subscribe("live", seen.append)
    assert fb.poll() == 2
    assert [m.kind for m in seen] == ["create", "delete"]
    with _Broker(a, root=root) as b2:
        bus2 = _bus(a, b2, "g2")
        store = a.Live(bus=bus2)
        store.create_schema(a.parse_spec("live", SPEC))
        assert bus2.poll() == 2
        assert store.count("live") == 1
        return [msg_key(m) for m in seen], ids_of(store.query("INCLUDE",
                                                              "live"))


def sb_publish_dedup_and_bad_frames(a, tmp):
    """A retried publish (same key) is acknowledged with its first seq and
    appended once; garbage and oversized frames drop the connection."""
    import socket
    import struct
    with _Broker(a) as b:
        raw = a.encode(a.GeoMessage("clear", "t"))
        from importlib import import_module
        sb = import_module(a.SocketBus.__module__)
        with socket.create_connection((b.host, b.port), timeout=10) as s:
            for _ in range(2):
                sb._send_frame(s, {"op": "publish", "topic": "t",
                                   "key": "k1"}, raw)
            acks = [sb._recv_frame(s)[0] for _ in range(2)]
            sb._send_frame(s, {"op": "nope"})
            unknown = sb._recv_frame(s)[0]
        with socket.create_connection((b.host, b.port), timeout=10) as s:
            s.sendall(struct.pack(">II", 1 << 30, 0))
            assert s.recv(16) == b""      # dropped, nothing allocated
        cons = _bus(a, b, "c")
        got = []
        cons.subscribe("t", got.append)
        assert cons.poll() == 1
        return acks, unknown, len(got)


SOCKETBUS = [sb_publish_poll_apply, sb_offsets_resume_across_reconnect,
             sb_consumer_auto_creates_schema, sb_long_poll_wakes_on_publish,
             sb_wakes_on_publish_to_any_subscribed_topic,
             sb_same_bus_publish_does_not_block_behind_parked_poll,
             sb_poll_max_messages_cap,
             sb_broker_restart_replays_filebus_layout,
             sb_publish_dedup_and_bad_frames]


@pytest.mark.parametrize("scenario", SOCKETBUS, ids=lambda f: f.__name__)
def test_socketbus(scenario, tmp_path):
    both(lambda a: scenario(a, str(tmp_path / a.pkg)))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_socketbus_writer_subprocess_feeds_reader(pkg, tmp_path):
    a = api(pkg)
    with _Broker(a) as b:
        reader = a.Live(bus=_bus(a, b, "reader"))
        reader.create_schema(a.parse_spec("live", SPEC))
        _run_writer("socketbus", "SocketBus", b.host, str(b.port))
        assert reader.bus.wait_for(lambda: reader.count("live") == 14,
                                   timeout_s=10)
        ids = set(ids_of(reader.query("INCLUDE", "live")))
        assert "w0-0" not in ids and "w2-4" in ids
        assert reader.query("BBOX(geom, -1, -1, 5, 5)", "live").n > 0


@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_socketbus_talks_to_the_other_packages_broker(client, server,
                                                      tmp_path):
    """Each package's SocketBus against the other's broker: publish,
    long poll, server-committed offsets, and a root= log the restarted
    broker of the client's package replays."""
    c, s = api(client), api(server)
    root = str(tmp_path / "log")
    with _Broker(s, root=root) as b:
        prod = c.Live(bus=_bus(c, b, "p"))
        prod.create_schema(c.parse_spec("live", SPEC))
        prod.write("live", make_batch(c, ["a", "b", "c"], [0, 1, 2],
                                      [0, 1, 2]), timestamp_ms=7)
        prod.delete("live", ["b"])
        cons = c.Live(bus=_bus(c, b, "g"))
        cons.create_schema(c.parse_spec("live", SPEC))
        assert cons.bus.wait_for(lambda: cons.count("live") == 2,
                                 timeout_s=10)
        assert ids_of(cons.query("INCLUDE", "live")) == ["a", "c"]
        assert _bus(c, b, "g").offset("live") == 2
    with _Broker(c, root=root) as b2:
        again = c.Live(bus=_bus(c, b2, "g"))
        again.create_schema(c.parse_spec("live", SPEC))
        assert again.bus.offset("live") == 2 and again.poll() == 0
        fresh = c.Live(bus=_bus(c, b2, "fresh"))
        fresh.create_schema(c.parse_spec("live", SPEC))
        assert fresh.poll() == 2
        assert ids_of(fresh.query("INCLUDE", "live")) == ["a", "c"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_broker_root_replays_across_packages(writer, reader, tmp_path):
    w, r = api(writer), api(reader)
    root = str(tmp_path / "log")
    sent = []
    with _Broker(w, root=root) as b:
        bus = _bus(w, b, "g")
        for k in range(3):
            m = w.GeoMessage("create", "live",
                             make_batch(w, [f"v{k}"], [k], [k]),
                             timestamp_ms=k, visibilities=("a&b",))
            sent.append(msg_key(m))
            bus.publish("live", m)
        bus.subscribe("live", lambda m: None)
        assert bus.poll(max_messages=1) == 1
    got = []
    with _Broker(r, root=root) as b:
        bus = _bus(r, b, "g")
        assert bus.offset("live") == 1
        bus.subscribe("live", lambda m: got.append(msg_key(m)))
        assert bus.poll() == 2
        fresh = _bus(r, b, "h")
        fresh.subscribe("live", lambda m: None)
        assert fresh.poll() == 3
    assert got == sent[1:]


class _Flaky(Exception):
    retryable = True


def _retry_run(pkg):
    import random
    if pkg == "jax":
        from geomesa_tpu.metrics import MetricsRegistry
        from geomesa_tpu.resilience.policy import (RetryBudget, RetryPolicy,
                                                   default_retryable)
    else:
        from geomesa_tpu_torch.metrics import MetricsRegistry
        from geomesa_tpu_torch.resilience.policy import (RetryBudget,
                                                         RetryPolicy,
                                                         default_retryable)
    reg = MetricsRegistry()
    sleeps = []
    pol = RetryPolicy(max_attempts=4, base_s=0.01, cap_s=0.05,
                      total_deadline_s=5.0, sleep=sleeps.append,
                      rng=random.Random(3), registry=reg)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("reset")
        return "ok"

    def throw(e):
        def fn():
            raise e
        return fn
    assert pol.call(flaky, name="x") == "ok"
    with pytest.raises(ValueError):
        pol.call(throw(ValueError("no")))
    with pytest.raises(_Flaky):          # tagged retryable: 3 retries
        pol.call(throw(_Flaky()))
    budget = RetryBudget(capacity=1.0, ratio=0.5)
    tight = RetryPolicy(max_attempts=10, base_s=0.0, cap_s=0.0,
                        budget=budget, sleep=lambda s: None, registry=reg)
    with pytest.raises(ConnectionError):
        tight.call(throw(ConnectionError()))
    late = RetryPolicy(max_attempts=10, base_s=10.0, cap_s=10.0,
                       total_deadline_s=0.001, sleep=sleeps.append,
                       rng=random.Random(1), registry=reg)
    with pytest.raises(ConnectionError):
        late.call(throw(ConnectionError()))
    assert len(calls) == 3 and len(sleeps) == 5
    snap = reg.snapshot()["counters"]
    return (len(calls), sleeps, budget.tokens,
            snap.get("resilience.retries"), snap.get("resilience.retries.x"),
            snap.get("resilience.budget.exhausted"),
            default_retryable(OSError()), default_retryable(ValueError()))


def test_retry_policy():
    """RetryPolicy and RetryBudget as the JAX package's: full-jitter
    backoff from a seeded rng, the attempt cap, a non-retryable error,
    a tagged retryable one, the budget's deposits and withdrawals, the
    deadline; the same sleeps and counters in both."""
    assert _retry_run("torch") == _retry_run("jax")


# -- the stream store (tests/test_stream.py) ---------------------------------

STREAM_SPEC = "name:String,count:Integer,dtg:Date,*geom:Point"
CONF = {
    "type": "delimited-text", "format": "CSV", "id-field": "$1",
    "fields": [
        {"name": "name", "transform": "$1"},
        {"name": "count", "transform": "$2::int"},
        {"name": "dtg", "transform": "isoDate($3)"},
        {"name": "geom", "transform": "point($4::double, $5::double)"},
    ]}
L1 = "alpha,5,2021-01-01T00:00:00Z,-75.1,38.2"
L2 = "beta,6,2021-01-02T00:00:00Z,10.0,20.0"
L3 = "gamma,7,2021-01-03T00:00:00Z,100.0,-20.0"


def st_tail_grows_with_file(a, tmp):
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "feed.csv")
    store = a.Stream("obs", CONF, a.FileTailSource(path), spec=STREAM_SPEC)
    ticks = [store.tick()]
    with open(path, "w") as f:
        f.write(L1 + "\n")
    ticks.append(store.tick())
    with open(path, "a") as f:
        f.write(L2 + "\n" + "gamma,7,2021-01-03T")  # partial line
    ticks.append(store.tick())
    with open(path, "a") as f:
        f.write("00:00:00Z,100.0,-20.0\n")
    ticks.append(store.tick())
    assert ticks == [0, 1, 1, 1]
    assert store.count("obs") == 3
    res = ids_of(store.query("BBOX(geom, -80, 30, -70, 40)", "obs"))
    assert res == ["alpha"]
    return ticks, res, ids_of(store.query("INCLUDE", "obs"))


def st_multibyte_lines_keep_byte_offsets(a, tmp):
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "feed.csv")
    src = a.FileTailSource(path)
    with open(path, "w", encoding="utf-8") as f:
        f.write("éé-café,1,2021-01-01T00:00:00Z,1.0,2.0\n")
    first = src.poll()
    assert first == ["éé-café,1,2021-01-01T00:00:00Z,1.0,2.0"]
    with open(path, "a", encoding="utf-8") as f:
        f.write(L2 + "\n")
    assert src.poll() == [L2]
    return first


def st_listeners_fire(a, tmp):
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "feed.csv")
    store = a.Stream("obs", CONF, a.FileTailSource(path), spec=STREAM_SPEC)
    events = []
    store.add_listener(lambda m: events.append(m.kind))
    with open(path, "w") as f:
        f.write(L1 + "\n")
    store.tick()
    assert events == ["create"]
    return events


def st_truncated_feed_restarts(a, tmp):
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "feed.csv")
    src = a.FileTailSource(path)
    with open(path, "w") as f:
        f.write(L1 + "\n" + L2 + "\n")
    assert len(src.poll()) == 2
    with open(path, "w") as f:   # rotation: smaller file, same path
        f.write(L3 + "\n")
    assert src.poll() == [L3]
    return True


def st_dict_records_via_json_converter(a, tmp):
    conf = {"type": "json", "id-field": "$1",
            "fields": [
                {"path": "$.id"},
                {"name": "name", "path": "$.name"},
                {"name": "count", "path": "$.c", "transform": "$3::int"},
                {"name": "dtg", "path": "$.t", "transform": "isoDate($4)"},
                {"path": "$.x"},
                {"path": "$.y"},
                {"name": "geom",
                 "transform": "point($5::double, $6::double)"}]}
    recs = [{"id": "a", "name": "x", "c": 1,
             "t": "2021-01-01T00:00:00Z", "x": 1.0, "y": 2.0},
            {"id": "b", "name": "y", "c": 2,
             "t": "2021-01-02T00:00:00Z", "x": 3.0, "y": 4.0}]
    store = a.Stream("obs", conf, a.IterableSource(iter(recs)),
                     spec=STREAM_SPEC)
    assert store.tick() == 2
    assert store.count("obs") == 2
    return ids_of(store.query("INCLUDE", "obs"))


def st_drain_in_batches(a, tmp):
    store = a.Stream("obs", CONF, a.IterableSource(iter([L1, L2, L3]),
                                                   batch=2),
                     spec=STREAM_SPEC)
    ticks = [store.tick() for _ in range(3)]
    assert ticks == [2, 1, 0]
    assert store.count("obs") == 3
    return ids_of(store.query("BBOX(geom, 0, -30, 110, 30)", "obs"))


def st_ttl_expiry(a, tmp):
    store = a.Stream("obs", CONF, a.IterableSource(iter([L1]), batch=10),
                     spec=STREAM_SPEC, ttl_millis=0)
    store.tick()
    time.sleep(0.01)
    store.tick()
    assert store.count("obs") == 0
    return store.count("obs")


def st_bad_records_counted_not_fatal(a, tmp):
    store = a.Stream("obs", CONF,
                     a.IterableSource(iter([L1, "not,enough,columns"]),
                                      batch=10), spec=STREAM_SPEC)
    assert store.tick() == 1
    assert store.count("obs") == 1
    return ids_of(store.query("INCLUDE", "obs"))


STREAM = [st_tail_grows_with_file, st_multibyte_lines_keep_byte_offsets,
          st_listeners_fire, st_truncated_feed_restarts,
          st_dict_records_via_json_converter, st_drain_in_batches,
          st_ttl_expiry, st_bad_records_counted_not_fatal]


@pytest.mark.parametrize("scenario", STREAM, ids=lambda f: f.__name__)
def test_stream(scenario, tmp_path):
    both(lambda a: scenario(a, str(tmp_path / a.pkg)))


# -- continuous queries (tests/test_streaming.py TestContinuousQueries) ------

CQ_SPEC = "name:String,age:Integer,dtg:Date,*geom:Point:srid=4326"


def cq_batch(a, sft, n, seed=11, id_prefix="f"):
    rng = np.random.default_rng(seed)
    ids = np.array([f"{id_prefix}{i}" for i in range(n)], dtype=object)
    return a.FeatureBatch.from_dict(sft, ids, {
        "name": np.array([f"n{i % 17}" for i in range(n)], dtype=object),
        "age": np.arange(n),
        "dtg": (np.int64(1704067200000)
                + rng.integers(0, 10**9, n).astype(np.int64)),
        "geom": (rng.uniform(-100, -60, n), rng.uniform(25, 50, n))})


def _cq_live(a):
    sft = a.parse_spec("pts", CQ_SPEC)
    store = a.Live()
    store.create_schema(sft)
    return store, sft


def drain_ids(batches):
    return [str(i) for b in batches for i in b.ids]


def cq_filter_pushes_only_matching_rows(a, tmp):
    store, sft = _cq_live(a)
    pub = a.Publisher(store)
    cq = pub.register("young", "pts", "age < 10")
    got = []
    a.Subscriber("young", bus=store.bus).on_batch(got.append)
    store.write("pts", cq_batch(a, sft, 100))
    assert cq.matched == 10
    assert sorted(drain_ids(got)) == sorted(f"f{i}" for i in range(10))
    ages = np.concatenate([b.columns["age"].values for b in got])
    assert ages.max() < 10
    return drain_ids(got), ages.tolist()


def cq_publish_chunks_to_knob(a, tmp):
    store, sft = _cq_live(a)
    old = a.PUBLISH_ROWS.get()
    try:
        a.PUBLISH_ROWS.set("32")
        pub = a.Publisher(store)
        cq = pub.register("all", "pts", "INCLUDE")
        got = []
        a.Subscriber("all", bus=store.bus).on_batch(got.append)
        store.write("pts", cq_batch(a, sft, 100))
        assert [b.n for b in got] == [32, 32, 32, 4]
        assert cq.published == 4
    finally:
        a.PUBLISH_ROWS.set(old)
    return drain_ids(got)


def cq_bin_over_the_wire_push(a, tmp):
    store, sft = _cq_live(a)
    pub = a.Publisher(store)
    pub.register("bin", "pts", "age < 25")
    frames = []
    a.Subscriber("bin", bus=store.bus).on_bin(frames.append)
    store.write("pts", cq_batch(a, sft, 100))
    recs = np.concatenate([a.decode_bin_records(f) for f in frames])
    assert len(recs) == 25
    return frames


def cq_deletes_forward_to_subscribers(a, tmp):
    store, sft = _cq_live(a)
    pub = a.Publisher(store)
    pub.register("cq", "pts", "age < 10")
    kinds = []
    a.Subscriber("cq", bus=store.bus).on_message(
        lambda m: kinds.append((m.kind, tuple(m.ids))))
    store.write("pts", cq_batch(a, sft, 20))
    store.delete("pts", ["f0", "f1"])
    assert kinds[-1][0] == "delete"
    return kinds


def cq_resume_exactly_once_across_broker_restart(a, tmp):
    """Subscriber offsets survive a broker kill/restart with a durable
    log: every post-restart delta arrives exactly once, and a fresh
    subscriber in the same group resumes from the committed offset."""
    root = os.path.join(tmp, "cqlog")
    broker = a.SocketBroker(root=root).start()
    port = broker.port
    store, sft = _cq_live(a)
    pub_bus = _bus(a, broker, "cq-pub")
    sub = None
    try:
        pub = a.Publisher(store, bus=pub_bus)
        pub.register("hot", "pts", "age < 50")
        sub = a.Subscriber("hot", host=broker.host, port=port, group="g1",
                           timeout_s=10.0)
        seen = []
        sub.on_batch(lambda b: seen.extend(str(i) for i in b.ids))
        store.write("pts", cq_batch(a, sft, 100, id_prefix="a"))
        sub.poll(wait_s=2.0)
        assert sorted(seen) == sorted(f"a{i}" for i in range(50))
        committed = sub.offset()
        broker.stop()
        broker = a.SocketBroker(port=port, root=root).start()
        store.write("pts", cq_batch(a, sft, 100, id_prefix="b"))
        deadline = time.monotonic() + 10.0
        while len(seen) < 100 and time.monotonic() < deadline:
            sub.poll(wait_s=1.0)
        assert sorted(seen[50:]) == sorted(f"b{i}" for i in range(50))
        assert len(seen) == len(set(seen))
        assert sub.offset() > committed
        sub2 = a.Subscriber("hot", host=broker.host, port=port, group="g1",
                            timeout_s=10.0)
        replays = []
        sub2.on_batch(lambda b: replays.extend(b.ids))
        sub2.poll(wait_s=0.5)
        assert replays == []
        sub2.close()
        return seen, sub.offset()
    finally:
        if sub is not None:
            sub.close()
        pub_bus.close()
        broker.stop()


CQ = [cq_filter_pushes_only_matching_rows, cq_publish_chunks_to_knob,
      cq_bin_over_the_wire_push, cq_deletes_forward_to_subscribers,
      cq_resume_exactly_once_across_broker_restart]


@pytest.mark.parametrize("scenario", CQ, ids=lambda f: f.__name__)
def test_continuous_queries(scenario, tmp_path):
    both(lambda a: scenario(a, str(tmp_path / a.pkg)))


# -- the live and lambda stores (tests/test_fs_store.py, test_wal.py) --------

def write_sample(a, ds, n=5000, seed=0, type_name="events"):
    rng = np.random.default_rng(seed)
    ds.write_dict(type_name, [f"e{seed}_{i}" for i in range(n)], {
        "kind": [f"k{i % 4}" for i in range(n)],
        "dtg": rng.integers(MS("2017-01-01"), MS("2017-01-20"), n),
        "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))})


def live_stream_and_query(a, tmp):
    ds = a.Live()
    ds.create_schema("live", "kind:String,dtg:Date,*geom:Point")
    write_sample(a, ds, n=1000, type_name="live")
    assert ds.count("live") == 1000
    res = ds.query("BBOX(geom, -90, -45, 90, 45)", "live")
    assert 0 < res.n < 1000
    return ids_of(res)


def live_upsert_semantics(a, tmp):
    ds = a.Live()
    ds.create_schema("u", "v:Integer,*geom:Point")
    ds.write_dict("u", ["a"], {"v": [1], "geom": ([0.0], [0.0])})
    ds.write_dict("u", ["a"], {"v": [2], "geom": ([1.0], [1.0])})
    assert ds.count("u") == 1
    f = next(ds.query("IN ('a')", "u").features())
    assert f["v"] == 2
    return f["v"]


def live_delete_clear_listeners(a, tmp):
    ds = a.Live(a.MessageBus())
    ds.create_schema("l", "v:Integer,*geom:Point")
    events = []
    ds.add_listener("l", lambda m: events.append(m.kind))
    ds.write_dict("l", ["x", "y"], {"v": [1, 2],
                                    "geom": ([0.0, 1.0], [0.0, 1.0])})
    ds.delete("l", ["x"])
    assert ds.count("l") == 1
    ds.clear("l")
    assert ds.count("l") == 0
    assert events == ["create", "delete", "clear"]
    return events


def live_two_stores_one_bus(a, tmp):
    bus = a.MessageBus()
    producer, consumer = a.Live(bus), a.Live(bus)
    producer.create_schema("t", "v:Integer,*geom:Point")
    consumer.create_schema("t", "v:Integer,*geom:Point")
    producer.write_dict("t", ["m"], {"v": [7], "geom": ([2.0], [2.0])})
    assert consumer.count("t") == 1
    return ids_of(consumer.query("INCLUDE", "t"))


def live_expiry(a, tmp):
    ds = a.Live(ttl_millis=1000)
    ds.create_schema("e", "v:Integer,*geom:Point")
    ds.write_dict("e", ["old"], {"v": [1], "geom": ([0.0], [0.0])},
                  timestamp_ms=1_000_000)
    ds.write_dict("e", ["new"], {"v": [2], "geom": ([1.0], [1.0])},
                  timestamp_ms=1_002_000)
    assert ds.expire("e", now_ms=1_002_500) == 1
    assert ids_of(ds.query("INCLUDE", "e")) == ["new"]
    return ids_of(ds.query("INCLUDE", "e"))


def live_listener_error_reaches_writer_after_apply(a, tmp):
    """On the in-process bus a listener runs inside ``write``, after the
    cache applied the message: its error reaches the caller."""
    ds = a.Live()
    ds.create_schema("t", "v:Integer,*geom:Point")

    def bad(m):
        raise RuntimeError("listener failed")
    ds.add_listener("t", bad)
    with pytest.raises(RuntimeError, match="listener failed"):
        ds.write_dict("t", ["a", "b"], {"v": [1, 2],
                                        "geom": ([0.0, 1.0], [0.0, 1.0])})
    assert ds.count("t") == 2
    return ids_of(ds.query("INCLUDE", "t"))


def live_bin_and_arrow_surface(a, tmp):
    ds = a.Live()
    ds.create_schema("live", "kind:String,dtg:Date,*geom:Point")
    write_sample(a, ds, n=300, type_name="live")
    q = "BBOX(geom, -90, -45, 90, 45)"
    res = ds.query_batched([a.Query("live", q), a.Query("live", "INCLUDE")])
    return ds.bin_query("live", q, sort=True), [ids_of(r) for r in res], \
        len(ds.arrow_ipc("live", q)) > 0


def lam_two_tier_union_and_persist(a, tmp):
    ds = a.Lambda(persist_after_millis=1000)
    ds.create_schema("lam", "v:Integer,dtg:Date,*geom:Point")
    ds.write_dict("lam", ["a"], {"v": [1], "dtg": [MS("2017-01-01")],
                                 "geom": ([0.0], [0.0])},
                  timestamp_ms=1_000_000)
    ds.write_dict("lam", ["b"], {"v": [2], "dtg": [MS("2017-01-02")],
                                 "geom": ([1.0], [1.0])},
                  timestamp_ms=1_005_000)
    assert ds.count("lam") == 2
    assert ds.persist("lam", now_ms=1_004_000) == 1
    assert ds.count("lam") == 2
    rt = ds.query(a.Query("lam", "INCLUDE", hints={a.TRANSIENT: True}))
    rp = ds.query(a.Query("lam", "INCLUDE", hints={a.PERSISTENT: True}))
    assert ids_of(rt) == ["b"] and ids_of(rp) == ["a"]
    return ids_of(rt), ids_of(rp)


def lam_transient_wins_collisions(a, tmp):
    ds = a.Lambda(persist_after_millis=10)
    ds.create_schema("c", "v:Integer,*geom:Point")
    ds.persistent.write_dict("c", ["x"], {"v": [1], "geom": ([0.0], [0.0])})
    ds.write_dict("c", ["x"], {"v": [99], "geom": ([5.0], [5.0])})
    res = ds.query("INCLUDE", "c")
    assert res.n == 1
    assert next(res.features())["v"] == 99
    return 99


def lam_persistent_only_type_surface(a, tmp):
    p = a.Memory()
    p.create_schema("only_p", "v:Integer,*geom:Point")
    p.write_dict("only_p", ["a"], {"v": [1], "geom": ([0.0], [0.0])})
    lam = a.Lambda(persistent=p)
    assert "only_p" in lam.get_type_names()
    assert lam.count("only_p") == 1
    lam.write_dict("only_p", ["b"], {"v": [2], "geom": ([1.0], [1.0])})
    assert lam.count("only_p") == 2
    with pytest.raises(KeyError):
        lam.write_dict("ghost", ["x"], {"v": [1], "geom": ([0.0], [0.0])})
    return ids_of(lam.query("INCLUDE", "only_p"))


def lam_stale_persistent_version_hidden(a, tmp):
    ds = a.Lambda(persist_after_millis=10)
    ds.create_schema("s", "status:String,*geom:Point")
    ds.persistent.write_dict("s", ["f1"], {"status": ["open"],
                                           "geom": ([0.0], [0.0])})
    ds.write_dict("s", ["f1"], {"status": ["closed"],
                                "geom": ([0.0], [0.0])})
    assert ds.query("status = 'open'", "s").n == 0
    return ids_of(ds.query("status = 'closed'", "s"))


def lam_union_sort_and_limit(a, tmp):
    ds = a.Lambda(persist_after_millis=10)
    ds.create_schema("s2", "v:Integer,*geom:Point")
    ds.persistent.write_dict("s2", ["p1", "p2"], {
        "v": [5, 1], "geom": ([0.0, 1.0], [0.0, 1.0])})
    ds.write_dict("s2", ["t1", "t2"], {
        "v": [3, 9], "geom": ([2.0, 3.0], [2.0, 3.0])})
    res = ds.query(a.Query("s2", "INCLUDE", sort_by="v", max_features=3))
    vals = [f["v"] for f in res.features()]
    assert vals == [1, 3, 5]
    return vals, [str(i) for i in res.ids]


def lam_visibility_travels_with_persist(a, tmp):
    ds = a.Lambda(persist_after_millis=10)
    ds.create_schema("v", "v:Integer,*geom:Point")
    ds.write_dict("v", ["a", "b", "c"], {"v": [1, 2, 3],
                                         "geom": ([0.0, 1.0, 2.0],
                                                  [0.0, 1.0, 2.0])},
                  timestamp_ms=0, visibilities=["x", None, "x&y"])
    assert ds.persist("v", now_ms=1_000) == 3
    seen = {tuple(auths): ids_of(ds.query(a.Query("v", "INCLUDE",
                                                  auths=auths)))
            for auths in ([], ["x"], ["x", "y"])}
    assert seen[()] == ["b"] and seen[("x", "y")] == ["a", "b", "c"]
    return seen, ds.bin_query("v", "INCLUDE", sort=True)


def lam_query_batched_and_bin(a, tmp):
    ds = a.Lambda(persist_after_millis=1000)
    ds.create_schema("b", "kind:String,dtg:Date,*geom:Point")
    write_sample(a, ds, n=400, seed=3, type_name="b")
    ds.persist("b", now_ms=int(time.time() * 1000) + 10_000)
    write_sample(a, ds, n=200, seed=3, type_name="b")   # collide with 200
    qs = [a.Query("b", "BBOX(geom, -90, -45, 90, 45)"),
          a.Query("b", "kind = 'k1'", hints={a.PERSISTENT: True}),
          a.Query("b", "INCLUDE", hints={a.TRANSIENT: True}),
          a.Query("b", "kind = 'k2'", hints={a.PERSISTENT: True})]
    res = ds.query_batched(qs)
    assert [r.n for r in res][2] == 200
    return ([ids_of(r) for r in res], ds.count("b"),
            ds.bin_query("b", "BBOX(geom, 0, 0, 90, 45)", sort=True))


def wal_live_store_durable_reopen(a, tmp):
    d = os.path.join(tmp, "live")
    ds = a.Live(durable_dir=d, wal_fsync="never")
    sft = a.parse_spec("t", SPEC)
    ds.create_schema(sft)
    ds.write("t", make_batch(a, ["a", "b"], [-80, -70], [30, 40], "t"))
    ds.delete("t", ["a"])
    ds.close()
    re = a.Live(durable_dir=d, wal_fsync="never")
    assert re.count("t") == 1
    re.write("t", make_batch(a, ["c"], [-75], [35], "t"))
    got = ids_of(re.query("BBOX(geom, -110, 20, -50, 55)", "t"))
    assert got == ["b", "c"]
    re.checkpoint()
    re.close()
    return got


def wal_lambda_store_mirrors_recovered_schemas(a, tmp):
    d = os.path.join(tmp, "lam")
    ds = a.Lambda(durable_dir=d, wal_fsync="never")
    sft = a.parse_spec("t", SPEC)
    ds.create_schema(sft)
    ds.write("t", make_batch(a, ["a"], [-80], [30], "t"))
    ds.close()
    re = a.Lambda(durable_dir=d, wal_fsync="never")
    assert "t" in re.persistent.get_type_names()
    got = re.query("BBOX(geom, -110, 20, -50, 55)", "t").ids
    assert [str(i) for i in got] == ["a"]
    re.close()
    return [str(i) for i in got]


STORES = [live_stream_and_query, live_upsert_semantics,
          live_delete_clear_listeners, live_two_stores_one_bus, live_expiry,
          live_listener_error_reaches_writer_after_apply,
          live_bin_and_arrow_surface, lam_two_tier_union_and_persist,
          lam_transient_wins_collisions, lam_persistent_only_type_surface,
          lam_stale_persistent_version_hidden, lam_union_sort_and_limit,
          lam_visibility_travels_with_persist, lam_query_batched_and_bin,
          wal_live_store_durable_reopen,
          wal_lambda_store_mirrors_recovered_schemas]


@pytest.mark.parametrize("scenario", STORES, ids=lambda f: f.__name__)
def test_stores(scenario, tmp_path):
    both(lambda a: scenario(a, str(tmp_path / a.pkg)))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_durable_live_directory_recovers_across_packages(writer, reader,
                                                         tmp_path):
    w, r = api(writer), api(reader)
    d = str(tmp_path / "live")
    ds = w.Live(durable_dir=d, wal_fsync="never")
    ds.create_schema(w.parse_spec("t", SPEC))
    rng = np.random.default_rng(5)
    for k in range(3):
        ids = [f"v{i}" for i in rng.choice(40, 15, replace=False)]
        ds.write("t", make_batch(w, ids, rng.uniform(-100, -60, 15),
                                 rng.uniform(25, 50, 15), "t"))
        if k == 1:
            ds.checkpoint()
    ds.delete("t", ["v1", "v2", "v3"])
    want = ids_of(ds.query("INCLUDE", "t"))
    ds.close()
    re = r.Live(durable_dir=d, wal_fsync="never")
    assert ids_of(re.query("INCLUDE", "t")) == want
    assert re.count("t") == len(want) == ds.count("t")
    re.close()


def test_lambda_over_a_file_store(tmp_path):
    """The port's lambda store with the port's FileSystemDataStore as its
    persistent tier, against the JAX lambda store over the JAX file
    store, on the same writes: persist, the union with transient rows
    winning, the hints, a delete, BIN."""
    from geomesa_tpu.store import FileSystemDataStore as JaxFs
    from geomesa_tpu_torch.store import FileSystemDataStore
    got = {}
    for pkg, fs in (("jax", lambda root: JaxFs(root)),
                    ("torch", lambda root: FileSystemDataStore(
                        root, device="cpu"))):
        a = api(pkg)
        ds = a.Lambda(persistent=fs(str(tmp_path / pkg)),
                      persist_after_millis=1000)
        ds.create_schema("ais", "kind:String,dtg:Date,*geom:Point")
        write_sample(a, ds, n=600, seed=1, type_name="ais")
        moved = ds.persist("ais", now_ms=int(time.time() * 1000) + 5_000)
        write_sample(a, ds, n=100, seed=1, type_name="ais")  # collisions
        ds.delete("ais", ["e1_5", "e1_500"])
        q = "BBOX(geom, -120, -40, 60, 50) AND kind = 'k2'"
        got[pkg] = (moved, ids_of(ds.query(q, "ais")), ds.count("ais"),
                    ids_of(ds.query(a.Query("ais", q,
                                            hints={a.PERSISTENT: True}))),
                    ids_of(ds.query(a.Query("ais", q,
                                            hints={a.TRANSIENT: True}))),
                    ds.bin_query("ais", q, sort=True))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 600 and got["torch"][2] == 598
