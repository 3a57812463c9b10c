"""The port's host utilities beside the JAX package's: the metadata
catalog, schema locks, age-off (on the in-memory and the file store) and
the version check. Tolerance: exact (ids, strings and counts)."""

import json
import os
import threading
import time

import numpy as np
import pytest

import geomesa_tpu
import geomesa_tpu_torch
from geomesa_tpu.features.sft import parse_spec as jparse
from geomesa_tpu.store import FileSystemDataStore as JFs
from geomesa_tpu.store.memory import InMemoryDataStore as JMem
from geomesa_tpu.utils.ageoff import age_off as jage_off
from geomesa_tpu_torch.features.sft import parse_spec
from geomesa_tpu_torch.store import FileSystemDataStore, InMemoryDataStore
from geomesa_tpu_torch.utils import (FileLock, FileMetadata,
                                     InMemoryMetadata, LocalLock, with_lock)
from geomesa_tpu_torch.utils.ageoff import age_off, expired_ids
from geomesa_tpu_torch.utils.version import (VersionMismatch, check_version,
                                             check_version_string,
                                             stamp_version)

SPEC = "name:String,dtg:Date,*geom:Point"
MS_DAY = 86_400_000


class TestMetadata:
    @pytest.mark.parametrize("kind", ["memory", "file"])
    def test_crud_and_scan(self, kind, tmp_path):
        md = InMemoryMetadata() if kind == "memory" \
            else FileMetadata(str(tmp_path / "md"))
        md.insert("t1", "schema", "a:Integer")
        md.insert_many("t1", {"stats.count": "10", "stats.min": "1"})
        md.insert("t2", "schema", "b:String")
        assert md.read("t1", "schema") == "a:Integer"
        assert md.read("t1", "nope") is None
        assert md.get_type_names() == ["t1", "t2"]
        assert dict(md.scan("t1", "stats.")) == {"stats.count": "10",
                                                 "stats.min": "1"}
        md.remove("t1", "stats.min")
        assert md.read("t1", "stats.min") is None
        md.delete("t2")
        assert md.get_type_names() == ["t1"]
        with pytest.raises(KeyError):
            md.read_required("t1", "gone")

    def test_file_metadata_atomic_reload(self, tmp_path):
        root = str(tmp_path / "md")
        a = FileMetadata(root)
        a.insert("t", "k", "v1")
        b = FileMetadata(root)  # separate instance sees the write
        assert b.read("t", "k") == "v1"
        a.insert("t", "k", "v2")
        assert b.read("t", "k") == "v2"  # mtime-based reload

    def test_file_metadata_read_across_packages(self, tmp_path):
        """A catalog directory written by either package reads in the
        other, key for key."""
        from geomesa_tpu.utils import FileMetadata as JFileMetadata
        root = str(tmp_path / "md")
        JFileMetadata(root).insert_many("a b/c", {"schema": "x:Integer",
                                                  "stats.n": 3})
        FileMetadata(root).insert("t", "k", "v")
        j, t = JFileMetadata(root), FileMetadata(root)
        assert j.get_type_names() == t.get_type_names()
        for name in t.get_type_names():
            assert list(j.scan(name, "")) == list(t.scan(name, ""))


class TestLocking:
    def test_local_lock_contention(self):
        order = []
        lock = LocalLock("test-key-torch")

        def worker(i):
            with with_lock(LocalLock("test-key-torch")):
                order.append(i)
                time.sleep(0.01)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        with with_lock(lock):
            for t in ts:
                t.start()
            assert order == []  # all blocked while held
        for t in ts:
            t.join()
        assert sorted(order) == [0, 1, 2, 3]

    def test_file_lock(self, tmp_path):
        p = str(tmp_path / "x.lock")
        l1, l2 = FileLock(p), FileLock(p)
        assert l1.acquire(1)
        assert not l2.acquire(0.1)
        l1.release()
        assert l2.acquire(1)
        l2.release()

    def test_file_lock_across_packages(self, tmp_path):
        """Both packages lock the same file with flock(2): a lock held
        by one excludes the other."""
        from geomesa_tpu.utils import FileLock as JFileLock
        p = str(tmp_path / "z.lock")
        j, t = JFileLock(p), FileLock(p)
        assert j.acquire(1)
        assert not t.acquire(0.1)
        j.release()
        assert t.acquire(1)
        assert not j.acquire(0.1)
        t.release()

    def test_stale_file_lock_broken(self, tmp_path):
        p = str(tmp_path / "y.lock")
        with open(p, "w") as fh:
            fh.write("999999 0")
        os.utime(p, (time.time() - 1000, time.time() - 1000))
        lk = FileLock(p, stale_s=10)
        assert lk.acquire(1)
        lk.release()

    def test_with_lock_times_out(self, tmp_path):
        p = str(tmp_path / "w.lock")
        held = FileLock(p)
        assert held.acquire(1)
        with pytest.raises(TimeoutError):
            with with_lock(FileLock(p), timeout_s=0.05):
                pass
        held.release()


def _aged_rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ids = [f"f{i}" for i in range(n)]
    dtg = rng.integers(0, 40 * MS_DAY, n)
    x, y = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
    names = [f"n{i % 7}" for i in range(n)]
    return ids, {"name": names, "dtg": dtg, "geom": (x, y)}


class TestAgeOff:
    def test_age_off_deletes_old(self):
        ds = InMemoryDataStore(device="cpu")
        sft = parse_spec("t", SPEC)
        ds.create_schema(sft)
        ds.write_dict("t", [f"f{i}" for i in range(10)],
                      {"name": ["x"] * 10,
                       "dtg": np.arange(10) * 100_000,  # 0 .. 900k
                       "geom": (np.zeros(10), np.zeros(10))})
        n = age_off(ds, "t", expiry_ms=500_000, now_ms=1_000_000)
        assert n == 5  # dtg < 500_000
        assert ds.count("t") == 5

    @pytest.mark.parametrize("store", ["memory", "fs"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_same_ids_deleted_as_the_reference(self, store, seed,
                                               tmp_path):
        ids, data = _aged_rows(seed, 3000)
        if store == "memory":
            port, ref = InMemoryDataStore(device="cpu"), JMem()
        else:
            port = FileSystemDataStore(str(tmp_path / "t"), device="cpu")
            ref = JFs(str(tmp_path / "j"))
        port.create_schema("t", SPEC)
        ref.create_schema("t", SPEC)
        port.write_dict("t", ids, data)
        ref.write_dict("t", ids, data)
        now, expiry = 40 * MS_DAY, (13 + 11 * seed) * MS_DAY
        got_ids = sorted(expired_ids(port, "t", expiry, now_ms=now))
        n_ref = jage_off(ref, "t", expiry, now_ms=now)
        n_port = age_off(port, "t", expiry, now_ms=now)
        want = sorted(i for i, t in zip(ids, data["dtg"])
                      if t < now - expiry)
        assert got_ids == want
        assert n_port == n_ref == len(want) > 0
        assert port.count("t") == ref.count("t") == len(ids) - len(want)
        kept_p = sorted(map(str, port.query("INCLUDE", "t").ids.tolist()))
        kept_r = sorted(map(str, ref.query("INCLUDE", "t").ids.tolist()))
        assert kept_p == kept_r

    def test_needs_a_date(self):
        ds = InMemoryDataStore(device="cpu")
        ds.create_schema("g", "name:String,*geom:Point")
        with pytest.raises(ValueError):
            age_off(ds, "g", 1000, now_ms=0)


class TestVersion:
    def test_equal_to_the_reference(self):
        assert geomesa_tpu_torch.__version__ == geomesa_tpu.__version__

    def test_stamp_and_check(self):
        md = InMemoryMetadata()
        stamp_version(md, "t")
        assert check_version(md, "t") == geomesa_tpu_torch.__version__
        assert check_version(InMemoryMetadata(), "t") is None

    def test_major_skew_raises_minor_warns(self):
        with pytest.raises(VersionMismatch):
            check_version_string("99.0.0", "t")
        with pytest.warns(UserWarning):
            check_version_string("0.99.0", "t")
        with pytest.raises(VersionMismatch):
            check_version_string("0.99.0", "t", strict=True)

    def test_fs_store_version_stamped(self, tmp_path):
        ds = FileSystemDataStore(str(tmp_path / "fs"), device="cpu")
        ds.create_schema(parse_spec("t", SPEC))
        with open(tmp_path / "fs" / "t" / "metadata.json") as fh:
            meta = json.load(fh)
        assert meta["version"] == geomesa_tpu_torch.__version__
        # reopen triggers the check (no error at same version)
        FileSystemDataStore(str(tmp_path / "fs"), device="cpu")

    def test_roots_open_across_packages_without_warning(self, tmp_path,
                                                        recwarn):
        FileSystemDataStore(str(tmp_path / "a"),
                            device="cpu").create_schema("t", SPEC)
        JFs(str(tmp_path / "b")).create_schema(jparse("t", SPEC))
        assert JFs(str(tmp_path / "a")).get_type_names() == ["t"]
        assert FileSystemDataStore(str(tmp_path / "b"),
                                   device="cpu").get_type_names() == ["t"]
        assert not [w for w in recwarn.list
                    if "written by" in str(w.message)]

    def test_major_skew_refuses_the_root(self, tmp_path):
        FileSystemDataStore(str(tmp_path / "a"),
                            device="cpu").create_schema("t", SPEC)
        path = tmp_path / "a" / "t" / "metadata.json"
        meta = json.loads(path.read_text())
        meta["version"] = "9.0.0"
        path.write_text(json.dumps(meta))
        with pytest.raises(VersionMismatch):
            FileSystemDataStore(str(tmp_path / "a"), device="cpu")
