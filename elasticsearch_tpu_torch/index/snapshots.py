"""Snapshot and restore through a filesystem repository, and the shard
commit that a flush writes in the same doc-block format.

Port of elasticsearch_tpu/index/snapshots.py. A segment's device arrays
are derived state, rebuilt from the sources and the mappings by a
freeze, so the durable unit is the segment's doc block
(``_segment_payload``): the live root docs' ids, sources and metas
(_type, _parent, routing, the resolved timestamp and ttl expiry), with
the blobs of any IVF quantizer and PQ tier the segment built. Each block
is a content-addressed blob (sha256 of its canonical JSON, gzipped), so
a second snapshot writes only the blocks that changed. A restore
replays the blocks through the write path with external versions and
seeds the IVF/PQ blobs into the blob cache (``index/ivf_cache.py``), so
the target's freeze loads the quantizer instead of running k-means.
The layout and the bytes are the JAX package's: a repository either
package writes restores in the other.

Repository layout:
    blobs/<sha256>.json.gz      one segment's doc block
    snapshots/<name>.json       a snapshot's manifest (indices, blob refs)
    index.json                  the catalog (snapshot names)

A shard's commit (``Engine.flush``) uses the same blobs:
    <data>/<index>/<shard>/_commit/blobs/<sha256>.json.gz
    <data>/<index>/<shard>/_commit/commit.json
A commit block holds every root doc of its segment, deleted ones too, so
the replayed segment has the same docs, statistics and vector slab as
the one written (scores and blob-cache keys survive a restart), and it
is written once a segment: a later delete changes only ``commit.json``.
``commit.json`` names the blocks with each block's deleted ids, and
carries each live doc's (version, seq no, term), the delete tombstones,
the max seq no and the primary term; it is replaced atomically, so a
reader sees the old commit or the new one. The blocks, ``commit.json``
and the directories naming them are fsynced before the translog drops
the ops they hold.
"""
from __future__ import annotations

import base64
import fnmatch
import gzip
import hashlib
import json
import os
import re
import time
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np

from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.index.translog import fsync_dir
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException


class SnapshotMissingException(ElasticsearchTpuException):
    status = 404
    error_type = "snapshot_missing_exception"


class SnapshotException(ElasticsearchTpuException):
    status = 400
    error_type = "snapshot_exception"


def _write_atomic(path: str, data: bytes, durable: bool = False) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def _holds(path: str, raw: bytes) -> bool:
    """Whether the gzip file at ``path`` decodes to ``raw``."""
    try:
        with gzip.open(path, "rb") as f:
            return f.read() == raw
    except (OSError, EOFError, zlib.error):
        return False


def put_blob(blob_dir: str, payload: dict, durable: bool = False) -> str:
    """Write ``payload`` as ``<sha256>.json.gz`` unless it is there;
    returns the sha. ``durable`` (the shard commit) fsyncs the file, and
    first reads back one that is there: a block an OS crash tore before
    it reached the disk is rewritten, a whole one synced."""
    raw = json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    sha = hashlib.sha256(raw).hexdigest()
    path = os.path.join(blob_dir, f"{sha}.json.gz")
    if durable and os.path.exists(path) and _holds(path, raw):
        with open(path, "rb") as f:
            os.fsync(f.fileno())
    elif durable or not os.path.exists(path):
        # the fastest level: any gzip reader takes it, and the name is
        # the digest of the JSON, not of the compressed bytes
        _write_atomic(path, gzip.compress(raw, compresslevel=1), durable)
    return sha


def get_blob(blob_dir: str, sha: str, where: str) -> dict:
    path = os.path.join(blob_dir, f"{sha}.json.gz")
    if not os.path.exists(path):
        raise SnapshotException(f"missing blob [{sha}] in {where}")
    with gzip.open(path, "rb") as f:
        return json.loads(f.read())


def _seed_vector_blobs(payload: dict, directory: Optional[str]) -> None:
    """Seed a block's IVF/PQ blobs into memory and the owning Node's
    ``_ivf`` (``directory``)."""
    for entry in payload.get("ivf", []):
        ivf_cache.seed(entry["key"], base64.b64decode(entry["blob"]),
                       directory)
    for entry in payload.get("pq", []):
        ivf_cache.seed_pq(entry["key"], base64.b64decode(entry["blob"]),
                          directory)


class FsRepository:
    """A content-addressed blob store on the local filesystem."""

    def __init__(self, name: str, location: str, create: bool = True):
        """Blobs are gzipped whatever the repository's ``compress``
        setting, as in the reference; ``create=False`` registers without
        touching the filesystem, for a read-only ``url`` repository,
        whose location must not be made."""
        self.name = name
        self.location = location
        self.blob_dir = os.path.join(location, "blobs")
        if create:
            os.makedirs(self.blob_dir, exist_ok=True)
            os.makedirs(os.path.join(location, "snapshots"), exist_ok=True)

    def put_blob(self, payload: dict) -> str:
        return put_blob(self.blob_dir, payload)

    def get_blob(self, sha: str) -> dict:
        return get_blob(self.blob_dir, sha, f"repository [{self.name}]")

    # -- manifests -----------------------------------------------------------

    def _catalog_path(self) -> str:
        return os.path.join(self.location, "index.json")

    def _manifest_path(self, name: str) -> str:
        return os.path.join(self.location, "snapshots", f"{name}.json")

    def catalog(self) -> List[str]:
        p = self._catalog_path()
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return json.load(f).get("snapshots", [])

    def _write_catalog(self, names: List[str]) -> None:
        _write_atomic(self._catalog_path(),
                      json.dumps({"snapshots": sorted(names)}).encode())

    def put_manifest(self, name: str, manifest: dict) -> None:
        _write_atomic(self._manifest_path(name),
                      json.dumps(manifest).encode())
        cat = self.catalog()
        if name not in cat:
            self._write_catalog(cat + [name])

    def get_manifest(self, name: str) -> dict:
        path = self._manifest_path(name)
        if not os.path.exists(path):
            raise SnapshotMissingException(f"[{self.name}:{name}] is missing")
        with open(path) as f:
            return json.load(f)

    def delete_snapshot(self, name: str) -> None:
        path = self._manifest_path(name)
        if not os.path.exists(path):
            raise SnapshotMissingException(f"[{self.name}:{name}] is missing")
        os.remove(path)
        self._write_catalog([n for n in self.catalog() if n != name])
        self._gc_blobs()

    def _gc_blobs(self) -> None:
        """Drop the blobs no remaining snapshot names."""
        live = set()
        for name in self.catalog():
            for idx in self.get_manifest(name)["indices"].values():
                for shard in idx["shards"]:
                    live.update(shard["blobs"])
        for fn in os.listdir(self.blob_dir):
            if fn.split(".", 1)[0] not in live:
                os.remove(os.path.join(self.blob_dir, fn))


# ---------------------------------------------------------------------------
# a segment's doc block
# ---------------------------------------------------------------------------

def _segment_payload(seg, live_only: bool = True) -> dict:
    """The canonical doc block of one frozen segment: its roots (a root's
    nested docs come back from its source), live ones only unless
    ``live_only`` is False, with the blobs of the IVF quantizers and PQ
    tiers it built, keyed by the slab's content."""
    from elasticsearch_tpu_torch.ops.pq import PqHostParts

    roots = seg.roots_host
    docs = []
    for local, doc_id in enumerate(seg.ids[: seg.num_docs]):
        if (live_only and not seg.live_host[local]) \
                or (roots is not None and not roots[local]):
            continue
        docs.append({"id": doc_id, "source": seg.sources[local],
                     "meta": seg.metas[local] if local < len(seg.metas)
                     else {}})
    payload: dict = {"docs": docs}
    ivf_blobs, pq_blobs = [], []
    for fname, vc in seg.vectors.items():
        parts = vc._pq_parts
        if parts is None and vc._pq:
            pq = vc._pq
            parts = PqHostParts(codebooks=pq.codebooks, codes=pq.codes_host,
                                M=pq.M, K=pq.K, dsub=pq.dsub, dims=pq.dims,
                                metric=pq.metric)
        if not vc._ivf and parts is None:
            continue
        key = vc.cache_key(seg.max_docs)
        if vc._ivf:
            ivf_blobs.append({"field": fname, "key": key, "blob": base64.
                              b64encode(ivf_cache.store(
                                  key, vc._ivf, seg.residency.blob_dir))
                              .decode("ascii")})
        if parts is not None:
            pq_blobs.append({"field": fname, "key": key, "blob": base64.
                             b64encode(ivf_cache.store_pq(
                                 key, parts, seg.residency.blob_dir))
                             .decode("ascii")})
    if ivf_blobs:
        payload["ivf"] = ivf_blobs
    if pq_blobs:
        payload["pq"] = pq_blobs
    return payload


def _put_segment(blob_dir: str, seg, live_only: bool,
                 durable: bool = False) -> str:
    """The sha of ``seg``'s block in ``blob_dir``, written if it is not
    there. A segment changes only by its deletes and by the ANN tiers it
    builds later, so the sha is kept on the segment under that state (a
    block is serialised once, which is what keeps an increment cheap)."""
    state = (seg.deleted_count if live_only else None, live_only,
             tuple((bool(vc._ivf), bool(vc._pq) or vc._pq_parts is not None)
                   for vc in seg.vectors.values()))
    memo = seg.__dict__.setdefault("_blob_shas", {})
    sha = memo.get((blob_dir, state))
    if sha is None or not os.path.exists(os.path.join(blob_dir,
                                                      f"{sha}.json.gz")):
        sha = put_blob(blob_dir, _segment_payload(seg, live_only), durable)
        memo[(blob_dir, state)] = sha
    return sha


# ---------------------------------------------------------------------------
# the shard commit (Engine.flush)
# ---------------------------------------------------------------------------

def read_commit(commit_dir: str) -> Optional[dict]:
    path = os.path.join(commit_dir, "commit.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_commit(commit_dir: str, segments, docs: Dict[str, tuple],
                 deleted: Dict[str, tuple], max_seq_no: int,
                 term: int) -> dict:
    """Write each segment's block (once a segment), then ``commit.json``:
    the commit point. ``docs`` maps each live id, and ``deleted`` each
    tombstone, to (version, seq no, term). Every block, ``commit.json``
    and the directories that name them are on disk when it returns, so
    the translog may then drop the ops they hold."""
    blob_dir = os.path.join(commit_dir, "blobs")
    if not os.path.isdir(blob_dir):
        os.makedirs(blob_dir)
        fsync_dir(os.path.dirname(commit_dir))
    blobs, dead = [], []
    for seg in segments:
        blobs.append(_put_segment(blob_dir, seg, live_only=False,
                                  durable=True))
        roots = seg.roots_host
        dead.append([seg.ids[i] for i in np.nonzero(
            ~seg.live_host[: seg.num_docs])[0]
            if roots is None or roots[i]])
    commit = {"blobs": blobs, "dead": dead,
              "docs": {d: list(v) for d, v in docs.items()},
              "deleted": {d: list(v) for d, v in deleted.items()},
              "max_seq_no": int(max_seq_no), "term": int(term)}
    raw = json.dumps(commit, separators=(",", ":")).encode()
    path = os.path.join(commit_dir, "commit.json")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(blob_dir)
    os.replace(tmp, path)
    fsync_dir(commit_dir)
    return commit


def commit_payloads(commit_dir: str, commit: dict,
                    blob_dir: Optional[str]) -> Iterator[dict]:
    """The committed blocks in order, their IVF/PQ blobs seeded first
    (into ``blob_dir``, the Node's ``_ivf``)."""
    blocks = os.path.join(commit_dir, "blobs")
    for sha in commit["blobs"]:
        payload = get_blob(blocks, sha, f"commit [{commit_dir}]")
        _seed_vector_blobs(payload, blob_dir)
        yield payload


def gc_commit(commit_dir: str, commit: dict) -> None:
    """Drop the blocks ``commit`` no longer names."""
    keep = set(commit["blobs"])
    blob_dir = os.path.join(commit_dir, "blobs")
    for fn in os.listdir(blob_dir):
        if fn.endswith(".json.gz") and fn.split(".", 1)[0] not in keep:
            os.remove(os.path.join(blob_dir, fn))


# ---------------------------------------------------------------------------
# snapshot and restore over a Node
# ---------------------------------------------------------------------------

def snapshot_shard(repo: FsRepository, shard) -> dict:
    """One shard's frozen segments into the repository; returns its
    manifest entry ({blobs, versions}). The segment list and versions are
    read under the engine lock, the blobs written outside it."""
    engine = shard.engine
    with engine._lock:
        segs = list(shard.segments)
        versions = {doc_id: loc.version
                    for doc_id, loc in engine._locations.items()
                    if not loc.deleted}
    return {"blobs": [_put_segment(repo.blob_dir, s, live_only=True)
                      for s in segs],
            "versions": versions}


def replay_shard(svc, repo: FsRepository, imeta: dict,
                 shard_index: int) -> None:
    """Replay one manifest shard's blocks into an index through the write
    path; external versions keep the replay idempotent. The resolved
    timestamp and ttl expiry ride along (the reference re-resolves them
    at restore, so a doc's expiry moves)."""
    shard_meta = imeta["shards"][shard_index]
    versions = shard_meta.get("versions", {})
    for sha in shard_meta["blobs"]:
        payload = repo.get_blob(sha)
        _seed_vector_blobs(payload, svc.residency.blob_dir)
        for doc in payload["docs"]:
            meta = doc.get("meta", {})
            svc.index_doc(doc["id"], doc["source"],
                          routing=meta.get("routing") or meta.get("_parent"),
                          doc_type=meta.get("_type"),
                          parent=meta.get("_parent"),
                          timestamp=meta.get("timestamp"),
                          ttl_expiry=meta.get("ttl_expiry"),
                          version=versions.get(doc["id"]),
                          version_type="external")


def _local_shards_meta(repo: FsRepository, svc) -> dict:
    """Refresh, then snapshot every shard; a shard whose blobs fail to
    write is recorded failed (the snapshot goes PARTIAL)."""
    svc.refresh()
    out: List[dict] = []
    failed = 0
    for shard in svc.shards:
        try:
            out.append(snapshot_shard(repo, shard))
        except Exception:
            failed += 1
            out.append({"blobs": [], "versions": {}, "failed": True})
    return {"shards": out, "failed": failed}


def create_snapshot(node, repo: FsRepository, snap_name: str,
                    indices: Optional[List[str]] = None,
                    include_global_state: bool = True,
                    shards_fn=None) -> dict:
    """Write a snapshot of ``indices`` (None: every index; an explicit
    empty list matches nothing) and its manifest. ``shards_fn(iname,
    svc)`` gives an index's shard entries (``{"shards", "failed",
    "settings"}``, settings optional); the default writes every local
    shard, the cluster's fans each shard out to its primary owner
    (cluster/search_action.py)."""
    if snap_name in repo.catalog():
        raise SnapshotException(
            f"snapshot [{repo.name}:{snap_name}] already exists")
    names = sorted(node.indices) if indices is None else indices
    if not names:
        raise SnapshotException("no indices matched the snapshot request")
    manifest: dict = {"snapshot": snap_name, "state": "SUCCESS",
                      "start_time_ms": int(time.time() * 1000),
                      "indices": {}}
    total = failed = 0
    for iname in names:
        svc = node.indices.get(iname)
        if svc is None:
            raise SnapshotException(f"index [{iname}] not found")
        entry = (shards_fn(iname, svc) if shards_fn
                 else _local_shards_meta(repo, svc))
        total += len(entry["shards"])
        failed += entry["failed"]
        manifest["indices"][iname] = {
            "settings": entry.get("settings") or svc.settings,
            "mappings": svc.mappings.to_json(),
            "aliases": svc.aliases, "shards": entry["shards"]}
    if include_global_state:
        manifest["global_state"] = {
            "templates": dict(node.cluster_state.templates),
            "search_templates": dict(node.search_templates)}
    if failed:
        manifest["state"] = "PARTIAL"
    manifest["end_time_ms"] = int(time.time() * 1000)
    repo.put_manifest(snap_name, manifest)
    return {"snapshot": {
        "snapshot": snap_name, "state": manifest["state"],
        "indices": list(manifest["indices"]),
        "shards": {"total": total, "failed": failed,
                   "successful": total - failed}}}


def select_restore_targets(node, manifest: dict,
                           indices: Optional[List[str]],
                           rename_pattern: Optional[str],
                           rename_replacement: Optional[str],
                           partial: bool, exists=None) -> List[tuple]:
    """Resolve and validate every (source, target, index meta) before any
    index is touched: a name collision, two indices renamed onto one
    target, failed shards without ``partial`` or an analysis config that
    does not build fail the whole restore up front. ``exists(target)``
    adds names the node holds elsewhere (the cluster's distributed
    indices)."""
    from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry

    selected: List[tuple] = []
    seen: set = set()
    for iname, imeta in manifest["indices"].items():
        if indices and not any(fnmatch.fnmatch(iname, p) for p in indices):
            continue
        target = iname
        if rename_pattern and rename_replacement is not None:
            target = re.sub(rename_pattern, rename_replacement, iname)
        if target in node.indices or (exists is not None
                                      and exists(target)):
            raise SnapshotException(
                f"cannot restore index [{target}]: an open index with that "
                f"name already exists (close or delete it first)")
        if target in seen:
            raise SnapshotException(
                f"cannot restore: rename pattern maps two snapshot indices "
                f"onto the same target [{target}]")
        seen.add(target)
        if any(sh.get("failed") for sh in imeta["shards"]) and not partial:
            raise SnapshotException(
                f"cannot restore index [{iname}]: the snapshot contains "
                f"failed shards (pass partial=true to restore the "
                f"available shards; missing ones come back empty)")
        if imeta.get("settings"):
            try:
                AnalysisRegistry(imeta["settings"]).validate()
            except Exception as e:
                raise SnapshotException(
                    f"cannot restore index [{iname}]: analysis config does "
                    f"not build: {e}")
        selected.append((iname, target, imeta))
    return selected


def restore_snapshot(node, repo: FsRepository, snap_name: str,
                     indices: Optional[List[str]] = None,
                     rename_pattern: Optional[str] = None,
                     rename_replacement: Optional[str] = None,
                     partial: bool = False) -> dict:
    manifest = repo.get_manifest(snap_name)
    selected = select_restore_targets(node, manifest, indices,
                                      rename_pattern, rename_replacement,
                                      partial)
    restored = []
    total = failed = 0
    for _iname, target, imeta in selected:
        node.create_index(target, {"settings": imeta["settings"],
                                   "mappings": imeta["mappings"]})
        svc = node.indices[target]
        svc.aliases.update(imeta.get("aliases", {}))
        for i, sh in enumerate(imeta["shards"]):
            total += 1
            if sh.get("failed"):
                failed += 1  # restores empty under partial
                continue
            replay_shard(svc, repo, imeta, i)
        svc.refresh()
        node._persist_index_meta(target)
        restored.append(target)
    apply_global_state(node, manifest, indices)
    return {"snapshot": {"snapshot": snap_name, "indices": restored,
                         "shards": {"total": total, "failed": failed,
                                    "successful": total - failed}}}


def apply_global_state(node, manifest: dict,
                       indices: Optional[List[str]]) -> None:
    """A full restore (no index list) brings back the index and search
    templates."""
    if "global_state" in manifest and not indices:
        gs = manifest["global_state"]
        node.cluster_state.templates.update(gs.get("templates", {}))
        node.search_templates.update(gs.get("search_templates", {}))


def snapshot_info(repo: FsRepository, snap_name: str) -> dict:
    m = repo.get_manifest(snap_name)
    return {"snapshot": snap_name, "state": m.get("state", "SUCCESS"),
            "indices": list(m.get("indices", {})),
            "start_time_in_millis": m.get("start_time_ms", 0),
            "end_time_in_millis": m.get("end_time_ms", 0)}
