"""Content-addressed blob cache for IVF quantizers and PQ tiers.

Port of elasticsearch_tpu/index/ivf_cache.py. An IVF list entry is a
doc ordinal local to its segment, so a blob is valid only for a slab
whose vectors sit at the same ordinals. Blobs are therefore keyed by the
slab's content, ``sha1(shape, metric, max_docs, vector bytes, exists
bytes)`` (``content_key``, the reference's key for the same slab): a key
hit guarantees the ordinals line up, and any drift (other refresh
boundaries, deletes pruned by a replay) misses and rebuilds.

- ``Node(data_path=...)`` registers ``<data>/_ivf`` before the gateway
  replays the shards, so a replayed segment finds the blobs the last
  process wrote; ``Node.close`` unregisters it. Registrations are
  refcounted (two Nodes over one data path share one).
- ``VectorColumn.get_ivf``/``get_pq`` look here before building and store
  after a build (counters ``ivf_cache_hit``/``pq_cache_hit`` and
  ``ivf_build``/``pq_build`` in ``monitor.kernels``).
- Snapshots embed each segment's blobs and a restore seeds them, so the
  target's freeze skips the k-means when the restored slab matches.

The memory layer is process-wide and content-addressed, so several Nodes
in one process can share it safely. Loads read any registered directory;
a store writes to the one directory its caller names, the ``_ivf`` of the
Node that owns the segment (``Residency.blob_dir``), so one Node's blobs
never land in another's data path. A blob that fails its checksums is
deleted and counts as a miss, so the build path runs and writes it anew.

The generic tier (``frame_blob`` ... ``list_blob_keys``) stores other
named blobs in the registered directories, framed by their sha1: the
program censuses (``resources/census.py``), the incidents
(``monitor/flight.py``) and the kernel libraries (``parallel/aot.py``,
kept out of the memory layer).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.monitor import kernels

_LOCK = threading.Lock()
_DIRS: Dict[str, int] = {}  # directory -> refcount, in registration order
_MEM: Dict[str, bytes] = {}
_MEM_CAP = 64  # blobs, first in first out: the disk layer is the durable one


def register(directory: str) -> None:
    """Add ``directory`` to the disk layer (created on the first store)."""
    with _LOCK:
        _DIRS[directory] = _DIRS.get(directory, 0) + 1


def unregister(directory: str) -> None:
    """Drop one registration of ``directory``."""
    with _LOCK:
        c = _DIRS.get(directory, 0) - 1
        if c > 0:
            _DIRS[directory] = c
        else:
            _DIRS.pop(directory, None)


def reset() -> None:
    """Forget every directory and the memory layer (tests; a restart
    inside one process)."""
    with _LOCK:
        _DIRS.clear()
        _MEM.clear()


def content_key(vecs_host: np.ndarray, exists_host: np.ndarray,
                metric: str, max_docs: int) -> str:
    v = np.ascontiguousarray(vecs_host, dtype=np.float32)
    e = np.ascontiguousarray(exists_host, dtype=bool)
    h = hashlib.sha1()
    h.update(repr((v.shape, metric, int(max_docs))).encode())
    h.update(v.tobytes())
    h.update(e.tobytes())
    return h.hexdigest()


def _disk_paths(key: str, ext: str) -> List[str]:
    with _LOCK:
        dirs = list(_DIRS)
    return [os.path.join(d, f"{key}.{ext}") for d in dirs]


def _load_parsed(key: str, ext: str, parse: Callable[[bytes], Any],
                 counter: str):
    """The parsed blob of (key, ext) from memory or disk, or None; a blob
    that does not parse is dropped (deleted from disk) as a miss."""
    from elasticsearch_tpu_torch.index.store import CorruptStoreException

    mkey = f"{ext}:{key}"
    with _LOCK:
        blob = _MEM.get(mkey)
    if blob is not None:
        try:
            out = parse(blob)
        except CorruptStoreException:
            with _LOCK:
                _MEM.pop(mkey, None)
        else:
            kernels.record(counter)
            return out
    for path in _disk_paths(key, ext):
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            continue
        try:
            out = parse(blob)
        except CorruptStoreException:
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        kernels.record(counter)
        return out
    return None


def load(key: str, place: Optional[Callable] = None):
    """The IvfIndex stored under ``key``, its tensors placed by ``place``
    (``store.read_ivf``), or None."""
    from elasticsearch_tpu_torch.index.store import read_ivf

    return _load_parsed(key, "ivf", lambda b: read_ivf(b, place),
                        "ivf_cache_hit")


def store(key: str, ivf: Any, directory: Optional[str] = None) -> bytes:
    """Persist ``ivf`` under ``key`` in memory and in ``directory``;
    returns the blob (snapshot payloads embed it)."""
    from elasticsearch_tpu_torch.index.store import write_ivf

    blob = write_ivf(ivf)
    seed(key, blob, directory)
    return blob


def load_pq(key: str):
    """The host PqHostParts stored under ``key`` (the slab's key, the
    ``pq`` extension), or None."""
    from elasticsearch_tpu_torch.index.store import read_pq

    return _load_parsed(key, "pq", read_pq, "pq_cache_hit")


def store_pq(key: str, parts: Any, directory: Optional[str] = None) -> bytes:
    from elasticsearch_tpu_torch.index.store import write_pq

    blob = write_pq(parts)
    seed_pq(key, blob, directory)
    return blob


def _own_path(directory: Optional[str], key: str, ext: str) -> List[str]:
    return [os.path.join(directory, f"{key}.{ext}")] if directory else []


def seed(key: str, blob: bytes, directory: Optional[str] = None) -> None:
    """Insert an encoded IVF blob (a restore's seeding) in memory and in
    ``directory``."""
    _seed(f"ivf:{key}", blob, _own_path(directory, key, "ivf"))


def seed_pq(key: str, blob: bytes, directory: Optional[str] = None) -> None:
    """Insert an encoded PQ blob (a restore's seeding)."""
    _seed(f"pq:{key}", blob, _own_path(directory, key, "pq"))


# -- the generic tier ------------------------------------------------------------

def frame_blob(payload: dict) -> bytes:
    """``sha1-hex\\n{json}``: damage becomes a detected miss at
    ``unframe_blob``."""
    body = json.dumps(payload, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha1(body).hexdigest().encode("ascii") + b"\n" + body


def unframe_blob(blob: bytes) -> Optional[dict]:
    """The payload of a ``frame_blob`` blob, or None when it is damaged."""
    try:
        digest, _, body = blob.partition(b"\n")
        if hashlib.sha1(body).hexdigest().encode("ascii") != digest:
            return None
        payload = json.loads(body)
        return payload if isinstance(payload, dict) else None
    except Exception:
        return None


def load_blob(key: str, ext: str) -> Optional[bytes]:
    """Raw bytes of (key, ext) from memory or any registered directory;
    callers validate them and ``delete_blob`` a damaged one."""
    with _LOCK:
        blob = _MEM.get(f"{ext}:{key}")
    if blob is not None:
        return blob
    for path in _disk_paths(key, ext):
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            continue
    return None


def store_blob(key: str, blob: bytes, ext: str, overwrite: bool = True,
               memory: bool = True) -> None:
    """Persist raw bytes under (key, ext) in every registered directory.
    Name-addressed blobs change, so by default a file that is there is
    replaced; content-addressed ones (a kernel library's) pass
    ``overwrite=False``, and large ones ``memory=False`` to stay out of
    the memory layer."""
    _seed(f"{ext}:{key}" if memory else None, blob, _disk_paths(key, ext),
          overwrite=overwrite)


def registered_dirs() -> List[str]:
    """The registered directories, in registration order."""
    with _LOCK:
        return list(_DIRS)


def blob_everywhere(key: str, ext: str) -> bool:
    """Whether every registered directory holds (key, ext) on disk."""
    paths = _disk_paths(key, ext)
    return bool(paths) and all(os.path.exists(p) for p in paths)


def delete_blob(key: str, ext: str) -> None:
    """Drop (key, ext) everywhere: the damaged-blob miss path."""
    with _LOCK:
        _MEM.pop(f"{ext}:{key}", None)
    for path in _disk_paths(key, ext):
        try:
            os.unlink(path)
        except OSError:
            pass


def list_blob_keys(ext: str) -> List[str]:
    """Every key stored under ``ext``, in memory or on disk, sorted."""
    prefix = f"{ext}:"
    with _LOCK:
        keys = {k[len(prefix):] for k in _MEM if k.startswith(prefix)}
        dirs = list(_DIRS)
    suffix = f".{ext}"
    for d in dirs:
        try:
            names = os.listdir(d)
        except OSError:
            continue
        keys.update(n[:-len(suffix)] for n in names if n.endswith(suffix))
    return sorted(keys)


def _seed(mkey: Optional[str], blob: bytes, paths: List[str],
          overwrite: bool = False) -> None:
    if mkey is not None:
        with _LOCK:
            if mkey not in _MEM and len(_MEM) >= _MEM_CAP:
                _MEM.pop(next(iter(_MEM)))
            _MEM[mkey] = blob
    for path in paths:
        if not overwrite and os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # a temporary name per writer: two threads storing one name must
        # not publish each other's half-written bytes
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
