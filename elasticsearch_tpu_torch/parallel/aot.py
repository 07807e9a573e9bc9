"""Kernel-library blob tier: the port's compiled artifacts beside the
IVF/PQ blobs.

Port of elasticsearch_tpu/parallel/aot.py. The reference persists
serialized XLA executables; the port's compiled artifacts are its kernel
libraries, the ``nvcc`` shared object of each ``csrc/*.cu``
(``ops/build.py``) and the ``g++`` host codec (``native/``). A restarted
node, a relocation target or a new cluster member would otherwise run
the compiler in front of its first request. :func:`resolve_many` finds
each library through this lookup:

1. **memo**: this process already opened it;
2. **build directory**: the ``.so`` is under ``build/torch_kernels/``
   (``build_dir_hit``); a data directory's tier that lacks it gets a
   copy;
3. **blob tier**: ``index/ivf_cache.py``'s ``load_blob`` in every
   registered data directory, files ``<key>.kso`` (an extension of its
   own: a reference ``.aotx`` blob is never read). The bytes are written
   into the build directory and opened (``aot_hit``). A blob that fails
   its digest (``corrupt_miss``), carries another key or fingerprint
   (``mismatch_miss``) or that ``dlopen`` refuses (``deserialize_error``)
   is deleted, counted, and the library is built from source;
4. **fresh build**: the compiler runs (``fresh``), and the library is
   stored in the tier (``store``) when a data directory is registered
   (else ``store_skipped``).

Key anatomy: ``sha1(library name, digest of the source with its headers,
compiler flags, the compiler's version line, backend_fingerprint() —
device name, compute capability and device count —, the host
fingerprint, the placement)``. The placement is the kind of device the
library's kernels launch on (``cuda``; ``host`` for the codec), never a
card's ordinal: a library the process opened once launches on every
card through the runtime API (each wrapper enters its tensor's device),
so a node over several cards builds and stores each library once, and
a blob stored by a process whose current card was another is found.
The reference's key carries no device count, so a program cached for
one device layout is served to another (ROADMAP C26); here a blob keyed
``n=1`` is never found under ``n=4``, and a hand-moved one fails its
fingerprint check.

Framing: ``sha1-hex\\n`` over a body of one JSON header line (version,
library, key and every fingerprint) and the library's bytes; no pickle.
Blob trust: the tier reads only this node's registered data
directories, as for every other blob there.

Accounting: ``monitor/compile_cache.py`` (events and phase seconds), the
per-thread first-touch count (``tracing/retrace.py``: every resolution
past the memo is one), the cache source of the dispatch key resolving it
(``monitor/programs.py``), and each library's own record (:func:`stats`).
On a CUDA tensor nothing falls back to a plain twin: a library that
cannot be loaded or built raises at its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

VERSION = 1
_EXT = "kso"

_LOCK = threading.Lock()
#: library name -> opened library (the process memo)
_MEMO: Dict[str, ctypes.CDLL] = {}
#: library name -> {"key", "path", "source", "seconds"} of its resolution
_RECORDS: Dict[str, dict] = {}
#: library name -> the spec it was opened by (store_loaded persists it)
_SPECS: Dict[str, "LibrarySpec"] = {}


@dataclass
class LibrarySpec:
    """How to find or build one library. ``start(path)`` starts the
    compiler writing ``path`` and returns its ``Popen``; ``prepare``
    declares the opened library's C signatures."""

    name: str
    tool: str
    digest: str
    flags: Sequence[str]
    compiler: str
    build_dir: str
    start: Callable[[str], object]
    prepare: Optional[Callable[[ctypes.CDLL], None]] = None
    placement: str = field(default_factory=lambda: placement())

    @property
    def key(self) -> str:
        return blob_key(self.name, self.digest, self.flags, self.compiler,
                        self.placement)

    @property
    def path(self) -> str:
        return os.path.join(self.build_dir,
                            f"{self.name}_{self.key[-16:]}.so")


def placement() -> str:
    """The kind of device a CUDA library's kernels launch on: ``cuda``
    for every card (the backend fingerprint carries the card's name,
    capability and count)."""
    import torch

    if torch.cuda.is_available():
        return "cuda"
    return "cpu"


def _fingerprints(placement_: str) -> dict:
    from elasticsearch_tpu_torch.monitor.programs import backend_fingerprint
    from elasticsearch_tpu_torch.utils.platform import host_fingerprint

    return {"backend": backend_fingerprint(), "host": host_fingerprint(),
            "placement": placement_}


def blob_key(name: str, digest: str, flags: Sequence[str], compiler: str,
             placement_: str) -> str:
    fp = _fingerprints(placement_)
    ident = repr((_EXT, VERSION, name, digest, tuple(flags), compiler,
                  fp["backend"], fp["host"], fp["placement"]))
    return f"kso_{name}_" + hashlib.sha1(ident.encode("utf-8")).hexdigest()


# -- frame ---------------------------------------------------------------------

def frame(header: dict, data: bytes) -> bytes:
    body = json.dumps(header, sort_keys=True).encode("utf-8") + b"\n" + data
    return hashlib.sha1(body).hexdigest().encode("ascii") + b"\n" + body


def unframe(blob: bytes) -> Optional[Tuple[dict, bytes]]:
    """(header, library bytes) of a framed blob, or None when damaged."""
    try:
        digest, _, body = blob.partition(b"\n")
        if hashlib.sha1(body).hexdigest().encode("ascii") != digest:
            return None
        head, _, data = body.partition(b"\n")
        header = json.loads(head)
        return (header, data) if isinstance(header, dict) else None
    except Exception:
        return None


def _header(spec: LibrarySpec) -> dict:
    return {"version": VERSION, "library": spec.name, "key": spec.key,
            "compiler": spec.compiler, **_fingerprints(spec.placement)}


# -- resolution ----------------------------------------------------------------

def loaded(name: str) -> Optional[ctypes.CDLL]:
    """The library opened by this process under ``name``, or None."""
    return _MEMO.get(name)


def resolve(spec: LibrarySpec) -> ctypes.CDLL:
    return resolve_many([spec])[spec.name][0]


def resolve_many(specs: List[LibrarySpec]
                 ) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Open every library of ``specs``: (library, compiler output) by
    name, the output empty unless it was built. Fresh builds run in
    parallel, one compiler each."""
    from elasticsearch_tpu_torch.monitor import compile_cache

    compile_cache.note_enabled(True)
    out: Dict[str, Tuple[ctypes.CDLL, str]] = {}
    with _LOCK:
        fresh = []
        for spec in specs:
            lib = _MEMO.get(spec.name)
            if lib is not None:
                out[spec.name] = (lib, "")
                continue
            t0 = time.perf_counter()
            if os.path.exists(spec.path):
                lib = _open(spec, "build_dir_hit", t0)
                _store(spec, missing_only=True)
            else:
                lib = _from_tier(spec, t0)
            if lib is not None:
                out[spec.name] = (lib, "")
                continue
            os.makedirs(spec.build_dir, exist_ok=True)
            # a per-process temporary name: concurrent first builds must
            # not write into one file; os.replace publishes atomically
            tmp = f"{spec.path}.{os.getpid()}.tmp.so"
            fresh.append((spec, tmp, spec.start(tmp), time.perf_counter()))
        for spec, tmp, proc, t0 in fresh:
            text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{spec.tool} failed to build {spec.name}:\n{text}")
            os.replace(tmp, spec.path)
            compile_cache.seconds("compile", time.perf_counter() - t0)
            lib = _open(spec, "fresh", t0)
            _store(spec, missing_only=False)
            out[spec.name] = (lib, text or "")
    return out


def _open(spec: LibrarySpec, source: str, t0: float) -> ctypes.CDLL:
    from elasticsearch_tpu_torch.monitor import compile_cache

    lib = ctypes.CDLL(spec.path)
    if spec.prepare is not None:
        spec.prepare(lib)
    _MEMO[spec.name] = lib
    _SPECS[spec.name] = spec
    _RECORDS[spec.name] = {"key": spec.key, "path": spec.path,
                           "source": source,
                           "seconds": round(time.perf_counter() - t0, 6)}
    compile_cache.event(source)
    _note(source)
    return lib


def _note(source: str) -> None:
    from elasticsearch_tpu_torch.monitor import programs
    from elasticsearch_tpu_torch.tracing import retrace

    retrace.note()
    programs.REGISTRY.record_cache_source(source)


def _miss(spec: LibrarySpec, event: str) -> None:
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.monitor import compile_cache

    ivf_cache.delete_blob(spec.key, _EXT)
    compile_cache.event(event)


def _from_tier(spec: LibrarySpec, t0: float) -> Optional[ctypes.CDLL]:
    """The library from the blob tier, written into the build directory
    and opened; every failure a counted, deleted miss."""
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.monitor import compile_cache

    blob = ivf_cache.load_blob(spec.key, _EXT)
    if blob is None:
        return None
    got = unframe(blob)
    if got is None or got[0].get("version") != VERSION:
        _miss(spec, "corrupt_miss")
        return None
    header, data = got
    if header != _header(spec):
        _miss(spec, "mismatch_miss")
        return None
    os.makedirs(spec.build_dir, exist_ok=True)
    tmp = f"{spec.path}.{os.getpid()}.tmp.so"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, spec.path)
    try:
        lib = _open(spec, "aot_hit", t0)
    except OSError:
        os.unlink(spec.path)
        _miss(spec, "deserialize_error")
        return None
    compile_cache.seconds("deserialize", time.perf_counter() - t0)
    return lib


def _store(spec: LibrarySpec, missing_only: bool) -> None:
    """Persist the built library in every registered data directory
    (``missing_only``: only where it is not yet)."""
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.monitor import compile_cache

    if not ivf_cache.registered_dirs():
        if not missing_only:
            compile_cache.event("store_skipped")
        return
    if missing_only and ivf_cache.blob_everywhere(spec.key, _EXT):
        return
    t0 = time.perf_counter()
    try:
        with open(spec.path, "rb") as fh:
            blob = frame(_header(spec), fh.read())
        ivf_cache.store_blob(spec.key, blob, _EXT, overwrite=False,
                             memory=False)
    except OSError:
        compile_cache.event("store_error")
        return
    compile_cache.seconds("serialize", time.perf_counter() - t0)
    compile_cache.event("store")


def store_loaded() -> None:
    """Persist every library this process opened into the registered
    data directories that lack it (``Node.close``: the libraries a node
    loaded before its data path was registered reach the tier too)."""
    with _LOCK:
        for name in list(_MEMO):
            spec = _SPECS.get(name)
            if spec is not None:
                _store(spec, missing_only=True)


def stats() -> Dict[str, dict]:
    """Each opened library's key, build-directory path, source and
    seconds (load, or build and load)."""
    with _LOCK:
        return {k: dict(v) for k, v in sorted(_RECORDS.items())}


def reset() -> None:
    """Forget every opened library (tests standing in for a new
    process; the libraries stay mapped)."""
    with _LOCK:
        _MEMO.clear()
        _RECORDS.clear()
