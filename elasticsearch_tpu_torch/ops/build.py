"""Build the port's CUDA kernels from the sources in the checkout.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``build/torch_kernels/`` at the repository
root, keyed by a hash of the source, and loaded with ``ctypes``. Nothing
is built when a module is imported: the first launch builds, and
``build_all()`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

#: kernel library name -> source file, relative to the package
SOURCES = {"bm25_dense_topk": "csrc/bm25_dense_topk.cu",
           "knn_topk": "csrc/knn_topk.cu",
           "adc_scores": "csrc/adc_scores.cu",
           "maxsim_adc": "csrc/maxsim_adc.cu"}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: kernel libraries built or loaded by this process (the profiler files
#: a device call during which it moved under ``device_compile``)
LOADS = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(_PKG, SOURCES[name])
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    # the source and every shared header it may include
    csrc = os.path.dirname(src)
    for path in [src] + sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(_BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Popen of the nvcc build for `name`, or None when it is built."""
    src, so = _target(name)
    if os.path.exists(so):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp.so"
    proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, started) -> str:
    """Wait for a build started by _start; returns the compiler's output."""
    if started is None:
        return ""
    proc, tmp, so = started
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's output
    (``-Xptxas -v``: registers, shared memory, spills) per library."""
    names: List[str] = list(SOURCES)
    started = [_start(n) for n in names]
    return {n: _finish(n, s) for n, s in zip(names, started)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    global LOADS
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(_target(name)[1])
            LOADS += 1
        return _libs[name]
