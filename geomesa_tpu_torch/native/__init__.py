"""The port's native host library: the z-key fast paths and the feature
codec in C++.

Own copies of the JAX package's host sources (``src/``: ``zencode.cpp``,
``zbuild.cpp``, ``zsort.cpp``, ``zrange.cpp``, ``feature_codec.cpp``),
compiled at first use
with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` (no ``-ffast-math``)
into ``_build/`` beside the package, keyed on a hash of the sources and
flags, and loaded through ctypes. They serve:

- ``curves/sfc.py``: the lenient z2 and z3 encoders;
- ``curves/timebin.py``: the DAY/WEEK binning of large columns;
- ``curves/zranges.py``: the range decomposition;
- ``index/zkeys.py``: the fused binned z3 encode, the sort orders
  (``sort_bin_z``, ``sort_z``) and the sorted-order coordinate copies
  (``gather_xyz``);
- ``features/codec.py``: the SFB batch encode and the fixed- and
  variable-width column extracts.

A failed compile raises ``NativeBuildError`` with the compiler's output.
There is no numpy fallback: each entry point's numpy version is its
plain twin (``*_plain``, beside it), which the tests hold it to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

__all__ = ["NativeBuildError", "build", "library", "ptr", "F64P", "I32P",
           "I64P", "U8P"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_SOURCES = ("zencode.cpp", "zbuild.cpp", "zsort.cpp", "zrange.cpp",
            "feature_codec.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_CXX = "g++"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_cache: dict = {}

F64P = ctypes.POINTER(ctypes.c_double)
I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.POINTER(ctypes.c_uint8)
U8PP = ctypes.POINTER(U8P)      # one column pointer per attribute
I64PP = ctypes.POINTER(I64P)
_L, _I, _F = ctypes.c_int64, ctypes.c_int32, ctypes.c_double

# symbol -> (restype, argtypes)
_SIGNATURES = {
    "geomesa_z2_encode": (None, [F64P, F64P, _L, I64P]),
    "geomesa_z3_encode": (None, [F64P, F64P, F64P, _L, _F, I64P]),
    "geomesa_binned": (_L, [I64P, _L, _I, I32P, I64P]),
    "geomesa_encode_binned_z3": (_L, [F64P, F64P, I64P, _L, _I, _F, I32P,
                                      I64P]),
    "geomesa_encode_binned_z3_edges": (_L, [F64P, F64P, I64P, _L, I64P, _L,
                                            _L, _F, I32P, I64P]),
    "geomesa_sort_bin_z": (_L, [I32P, I64P, _L, _L, I32P, I64P, I64P]),
    "geomesa_sort_z": (_L, [I64P, _L, I32P, I64P]),
    "geomesa_gather_xyz": (_L, [F64P, F64P, I64P, I32P, _L, F64P, F64P,
                                I64P]),
    "geomesa_host_threads": (_L, [_L]),
    "geomesa_zranges": (_L, [I64P, I64P, _L, _L, _L, _L, I64P, _L]),
    "sfb_encoded_size": (_L, [_I, _I, U8P, I32P, I64PP, U8PP]),
    "sfb_encode_batch": (_L, [_I, _I, U8P, I32P, U8PP, U8PP, I64PP, U8PP,
                              U8P, _L, I64P]),
    "sfb_decode_fixed": (_L, [U8P, I64P, _I, _I, _I, _I, U8P, U8P]),
    "sfb_decode_varlen_sizes": (_L, [U8P, I64P, _I, _I, _I, I64P, U8P]),
    "sfb_decode_varlen": (_L, [U8P, I64P, _I, _I, _I, I64P, U8P]),
}


class NativeBuildError(RuntimeError):
    """The native library did not compile or load."""


def _paths() -> list:
    return [os.path.join(_SRC, s) for s in _SOURCES]


def _target() -> str:
    h = hashlib.sha256(" ".join((_CXX,) + _FLAGS).encode())
    for p in _paths():
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libgeomesa_host_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the sources unless a build of them exists; returns (the
    library's path, the seconds the compile took, 0.0 when it existed).
    Raises NativeBuildError with the compiler's output."""
    so = _target()
    if os.path.exists(so):
        return so, 0.0
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [_CXX, *_FLAGS, "-o", tmp, *_paths()]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
    # another process may have built the same sources meanwhile: the
    # rename is atomic, and either copy is the same library
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded library with every entry point's signature set,
    compiled at first use. Raises NativeBuildError."""
    with _lock:
        lib = _cache.get("lib")
        if lib is None:
            path, _ = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _cache["lib"] = lib
        return lib


def ptr(a, kind):
    """ctypes pointer of a contiguous numpy array (``kind``: F64P, I32P,
    I64P or U8P), or a null pointer for None."""
    if a is None:
        return ctypes.cast(None, kind)
    return a.ctypes.data_as(kind)
