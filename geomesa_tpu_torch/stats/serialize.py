"""Binary stat-sketch serialization (StatSerializer analog).

The reference moves sketches between processes in binary form -- the
server-side StatsScan returns serialized partial sketches that merge
client-side, and the stats table persists them
(geomesa-utils/.../stats/StatSerializer.scala). Here every sketch
serializes to a compact self-describing payload, the JAX package's wire
format byte for byte (a payload of either package reads back in the
other):

    [magic u16][version u8][json header length u32][json header]
    [array payloads, 8-byte aligned]

The header is a restricted JSON tree of the sketch's state — scalars
inline, numpy arrays as {"__nd__": i} references into the payload
section, nested Stats as {"__stat__": class, "state": tree}. No pickle
anywhere: payloads are dtype/shape-tagged raw buffers, so the format is
stable across python versions and safe to read from untrusted peers.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

from . import sketches as _sk
from .sketches import Stat

__all__ = ["serialize_stat", "deserialize_stat"]

_MAGIC = 0x5354  # 'ST'
_VERSION = 1

# the closed set of sketch classes the wire format may instantiate
_CLASSES = {
    name: getattr(_sk, name) for name in (
        "CountStat", "MinMax", "EnumerationStat", "TopK", "Histogram",
        "Frequency", "DescriptiveStats", "GroupBy", "SeqStat",
        "Z3Histogram", "Z3Frequency")
    if hasattr(_sk, name)
}


def _encode(v, arrays: list) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            # object arrays hold strings (vocab etc.): store as a list
            return {"__strs__": [None if x is None else str(x)
                                 for x in v.tolist()]}
        arrays.append(np.ascontiguousarray(v))
        return {"__nd__": len(arrays) - 1}
    if isinstance(v, Stat):
        return {"__stat__": type(v).__name__,
                "state": _encode(dict(v.__dict__), arrays)}
    if isinstance(v, dict):
        return {"__dict__": [[_encode(k, arrays), _encode(x, arrays)]
                             for k, x in v.items()]}
    if isinstance(v, (list, tuple)):
        return {"__list__": [_encode(x, arrays) for x in v],
                "tuple": isinstance(v, tuple)}
    if isinstance(v, set):
        return {"__set__": [_encode(x, arrays) for x in sorted(
            v, key=repr)]}
    # TimePeriod and other simple enums stringify; deserialization
    # re-parses through the class constructor path below
    if hasattr(v, "name") and hasattr(type(v), "__members__"):
        return {"__enum__": type(v).__name__, "value": v.name}
    raise TypeError(f"unserializable sketch field: {type(v).__name__}")


def _decode(v, arrays: list) -> Any:
    if not isinstance(v, dict):
        return v
    if "__nd__" in v:
        return arrays[v["__nd__"]]
    if "__strs__" in v:
        return np.array(v["__strs__"], dtype=object)
    if "__stat__" in v:
        cls = _CLASSES.get(v["__stat__"])
        if cls is None:
            raise ValueError(f"unknown sketch class {v['__stat__']!r}")
        out = cls.__new__(cls)
        out.__dict__.update(_decode(v["state"], arrays))
        return out
    if "__dict__" in v:
        return {_decode(k, arrays): _decode(x, arrays)
                for k, x in v["__dict__"]}
    if "__list__" in v:
        items = [_decode(x, arrays) for x in v["__list__"]]
        return tuple(items) if v.get("tuple") else items
    if "__set__" in v:
        return {_decode(x, arrays) for x in v["__set__"]}
    if "__enum__" in v:
        from ..curves.timebin import TimePeriod
        if v["__enum__"] == "TimePeriod":
            return TimePeriod.parse(v["value"])
        raise ValueError(f"unknown enum {v['__enum__']!r}")
    return v


def serialize_stat(stat: Stat) -> bytes:
    """Sketch -> stable binary payload (no pickle)."""
    arrays: list[np.ndarray] = []
    tree = _encode(stat, arrays)
    meta = {"tree": tree,
            "arrays": [{"dtype": a.dtype.str, "shape": list(a.shape)}
                       for a in arrays]}
    header = json.dumps(meta, separators=(",", ":")).encode()
    parts = [struct.pack("<HBxI", _MAGIC, _VERSION, len(header)), header]
    off = sum(len(p) for p in parts)
    for a in arrays:
        pad = (-off) % 8
        parts.append(b"\x00" * pad)
        off += pad
        buf = a.tobytes()
        parts.append(buf)
        off += len(buf)
    return b"".join(parts)


def deserialize_stat(data: bytes) -> Stat:
    """Binary payload -> sketch. EVERY malformed/crafted input raises
    ValueError — the single error the bus/lambda consumers catch (the
    untrusted-peer contract the module docstring promises)."""
    try:
        if len(data) < 8:
            raise ValueError("truncated sketch payload")
        magic, version, hlen = struct.unpack_from("<HBxI", data, 0)
        if magic != _MAGIC:
            raise ValueError("not a serialized sketch")
        if version != _VERSION:
            raise ValueError(f"unsupported sketch version {version}")
        off = 8 + hlen
        meta = json.loads(data[8:off].decode())
        arrays: list[np.ndarray] = []
        for spec in meta["arrays"]:
            off += (-off) % 8
            dt = np.dtype(spec["dtype"])
            n = int(np.prod(spec["shape"])) if spec["shape"] else 1
            nbytes = dt.itemsize * n
            arr = np.frombuffer(data[off:off + nbytes], dtype=dt) \
                .reshape(spec["shape"]).copy()
            arrays.append(arr)
            off += nbytes
        out = _decode(meta["tree"], arrays)
        if not isinstance(out, Stat):
            raise ValueError("payload did not decode to a sketch")
        return out
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed sketch payload: {e}") from e
