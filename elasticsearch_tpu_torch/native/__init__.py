"""The host codec: CRC32, zigzag varints and delta varints.

Port of elasticsearch_tpu/native/__init__.py. ctypes bindings over the
port's copy of the codec (``csrc/codec.cpp``) for the varints, built with
``g++`` at first use into the kernel build directory
(``ops/build.py::_BUILD_DIR``) and found through the blob tier of
``parallel/aot.py`` like the CUDA libraries (a restarted node loads it
from its data path instead of running ``g++``); CRC32 is zlib's. The
numpy versions below are the plain twins: they write the same bytes, and
the tests hold the two against each other. This is host code, not a
device kernel, so without a compiler the twins serve
(``native_available()`` says which one runs).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "codec.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_tried = False
_lock = threading.Lock()


def _prepare(lib: ctypes.CDLL) -> None:
    u64, i64p, u8p = (ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64),
                      ctypes.POINTER(ctypes.c_uint8))
    for fn in ("et_vbyte_encode", "et_delta_encode"):
        getattr(lib, fn).restype = u64
        getattr(lib, fn).argtypes = [i64p, u64, u8p]
    for fn in ("et_vbyte_decode", "et_delta_decode"):
        getattr(lib, fn).restype = u64
        getattr(lib, fn).argtypes = [u8p, u64, i64p, u64]


def spec():
    """The codec's library spec for the blob tier."""
    from elasticsearch_tpu_torch.ops import build
    from elasticsearch_tpu_torch.parallel import aot

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    return aot.LibrarySpec(
        name="codec", tool="g++", digest=digest, flags=_FLAGS,
        compiler=version, build_dir=build._BUILD_DIR, placement="host",
        prepare=_prepare,
        start=lambda out: subprocess.Popen(
            ["g++", *_FLAGS, "-o", out, _SRC], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            from elasticsearch_tpu_torch.parallel import aot

            _lib = aot.resolve(spec())
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    """Whether the compiled codec serves (else the numpy/zlib twins)."""
    return _build_and_load() is not None


def crc32(data: bytes, seed: int = 0) -> int:
    """zlib's CRC32, the same value as the codec's ``et_crc32``; zlib is
    already native and reads the bytes in place, where a ctypes call
    would copy them first."""
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def _as_i64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int64))


def _encode(arr, fn_native: str, fn_py) -> bytes:
    a = _as_i64(arr)
    lib = _build_and_load()
    if lib is None:
        return fn_py(a)
    out = np.empty(10 * max(1, a.size), dtype=np.uint8)
    n = getattr(lib, fn_native)(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), a.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


def _decode(data: bytes, count: int, fn_native: str, fn_py) -> np.ndarray:
    lib = _build_and_load()
    if lib is None:
        return fn_py(data, count)
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    n = getattr(lib, fn_native)(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
    return out[:n]


# -- the plain twins -----------------------------------------------------------

def _py_zigzag(a: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint64) << np.uint64(1)) \
        ^ (a >> np.int64(63)).astype(np.uint64)


def _py_vbyte_encode(a: np.ndarray) -> bytes:
    out = bytearray()
    for u in _py_zigzag(a).tolist():
        while u >= 0x80:
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        out.append(u)
    return bytes(out)


def _py_vbyte_decode(data: bytes, count: int) -> np.ndarray:
    """Stops at ``count`` values or at a truncated varint, as the C
    decoder does."""
    out = np.empty(count, dtype=np.int64)
    i = k = 0
    n = len(data)
    while k < count and i < n:
        u = 0
        shift = 0
        done = False
        while i < n:
            b = data[i]
            i += 1
            u |= (b & 0x7F) << shift
            if not (b & 0x80):
                done = True
                break
            shift += 7
        if not done:
            break
        out[k] = (u >> 1) ^ -(u & 1)
        k += 1
    return out[:k]


def _py_delta_encode(a: np.ndarray) -> bytes:
    return _py_vbyte_encode(np.diff(a, prepend=np.int64(0)))


def _py_delta_decode(data: bytes, count: int) -> np.ndarray:
    return np.cumsum(_py_vbyte_decode(data, count))


# -- public API ------------------------------------------------------------------

def vbyte_encode(arr) -> bytes:
    """Zigzag-varint encode an int64 array (Lucene's writeVLong family)."""
    return _encode(arr, "et_vbyte_encode", _py_vbyte_encode)


def vbyte_decode(data: bytes, count: int) -> np.ndarray:
    return _decode(data, count, "et_vbyte_decode", _py_vbyte_decode)


def delta_encode(arr) -> bytes:
    """Delta + zigzag-varint for sorted sequences (postings doc-id gaps)."""
    return _encode(arr, "et_delta_encode", _py_delta_encode)


def delta_decode(data: bytes, count: int) -> np.ndarray:
    return _decode(data, count, "et_delta_decode", _py_delta_decode)
