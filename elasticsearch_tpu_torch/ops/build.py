"""Build the port's CUDA kernels from the sources in the checkout.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``build/torch_kernels/`` at the repository
root (``_BUILD_DIR``, a module attribute a caller may point elsewhere),
and loaded with ``ctypes``. A library is found through the blob tier of
``parallel/aot.py`` (the process memo, the build directory, the tier in
the registered data directories, then ``nvcc``), keyed by the source
and its headers, the flags, ``nvcc``'s version, the card and the host.
Nothing is built when a module is imported: the first launch resolves
its library, and ``build_all()`` resolves every one, starting one
``nvcc`` per library it must build, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from elasticsearch_tpu_torch.parallel import aot

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

#: kernel library name -> source file, relative to the package
SOURCES = {"bm25_dense_topk": "csrc/bm25_dense_topk.cu",
           "knn_topk": "csrc/knn_topk.cu",
           "adc_scores": "csrc/adc_scores.cu",
           "maxsim_adc": "csrc/maxsim_adc.cu"}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_VERSION: Dict[str, str] = {}
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


def _nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build), read once."""
    if "nvcc" not in _VERSION:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout
        _VERSION["nvcc"] = out.strip().splitlines()[-1]
    return _VERSION["nvcc"]


def _digest(name: str) -> str:
    """sha256 of the source and every shared header it may include."""
    src = os.path.join(_PKG, SOURCES[name])
    h = hashlib.sha256()
    csrc = os.path.dirname(src)
    for path in [src] + sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                               if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def spec(name: str) -> aot.LibrarySpec:
    src = os.path.join(_PKG, SOURCES[name])
    return aot.LibrarySpec(
        name=name, tool="nvcc", digest=_digest(name), flags=_FLAGS,
        compiler=_nvcc_version(), build_dir=_BUILD_DIR,
        start=lambda out: subprocess.Popen(
            [_nvcc(), *_FLAGS, "-o", out, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))


def _resolve(names) -> Dict[str, tuple]:
    global LOADS
    with _lock:
        opened = [n for n in names if aot.loaded(n) is None]
        out = aot.resolve_many([spec(n) for n in names])
        LOADS += len(opened)
    return out


def build_all() -> Dict[str, str]:
    """Resolve every kernel library, building what neither the build
    directory nor the blob tier holds in parallel; returns nvcc's output
    (``-Xptxas -v``: registers, shared memory, spills) per library,
    empty for one that was not built."""
    return {n: text for n, (_lib, text) in _resolve(list(SOURCES)).items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, resolved on first use."""
    lib = aot.loaded(name)
    if lib is not None:
        return lib
    return _resolve([name])[name][0]
