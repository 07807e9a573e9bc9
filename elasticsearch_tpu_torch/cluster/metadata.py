"""Index metadata operations: dynamic settings, open and close, blocks.

Port of elasticsearch_tpu/cluster/metadata.py (ES's
MetaDataUpdateSettingsService and MetaDataIndexStateService). A closed
index stays registered, with its segments, and refuses reads and writes
(``check_open``); the ``blocks.*`` settings refuse one kind of
operation. ``update_index_settings`` takes the dynamic settings only;
``number_of_replicas`` grows or shrinks every shard's replica set
(``_scale_replicas``). Each change is persisted through the node's
gateway.
"""
from __future__ import annotations

from typing import Dict

from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  IllegalArgumentException)

#: settings an open index takes (ES's IndexDynamicSettings)
DYNAMIC_SETTINGS = {
    "number_of_replicas",
    "refresh_interval",
    "blocks.read_only",
    "blocks.read",
    "blocks.write",
}
#: dynamic families (the slow log thresholds)
DYNAMIC_SETTING_PREFIXES = ("search.slowlog.", "indexing.slowlog.")


class IndexClosedException(ElasticsearchTpuException):
    status = 403
    error_type = "index_closed_exception"


class IndexBlockedException(ElasticsearchTpuException):
    status = 403
    error_type = "cluster_block_exception"


def flatten_settings(settings: dict, prefix: str = "") -> Dict[str, object]:
    """Nested and dotted settings bodies as one map of dotted keys."""
    out: Dict[str, object] = {}
    for k, v in settings.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_settings(v, f"{key}."))
        else:
            out[key] = v
    return out


def update_index_settings(svc, body: dict, node=None) -> dict:
    """PUT /{index}/_settings: dynamic settings only."""
    flat = flatten_settings(body.get("settings", body))
    flat = {k[len("index."):] if k.startswith("index.") else k: v
            for k, v in flat.items()}
    for key in flat:
        if key not in DYNAMIC_SETTINGS \
                and not key.startswith(DYNAMIC_SETTING_PREFIXES):
            raise IllegalArgumentException(
                f"setting [index.{key}] is not dynamically updateable")
    if "number_of_replicas" in flat:
        _scale_replicas(svc, int(flat["number_of_replicas"]))
    idx = svc.settings.setdefault("index", {})
    idx.update(flat)
    if node is not None:
        node._persist_index_meta(svc.name)
    return {"acknowledged": True}


def _scale_replicas(svc, target: int) -> None:
    """Grow or shrink every shard's replica set to ``target`` copies. A
    surplus replica is closed (its device segments released); a new one
    peer-recovers from the primary under the lock writes fan out under,
    is recorded as a ``replica`` recovery and, caught up, joins the
    in-sync set, so it can be promoted (the reference leaves it out of
    the set and records nothing: ROADMAP C15)."""
    if target < 0:
        raise IllegalArgumentException("number_of_replicas must be >= 0")
    for group in svc.groups:
        with group._lock:
            while len(group.replicas) > target:
                gone = group.replicas.pop()
                group.checkpoints.remove(gone.engine.commit_id)
                gone.close()
            while len(group.replicas) < target:
                entry = svc.recoveries.start(group.shard_id, "replica")
                fresh = svc._new_copy(group.shard_id)
                try:
                    group.add_replica(fresh, entry)
                except Exception:
                    svc.recoveries.finish(entry, ok=False)
                    fresh.close()
                    raise
                svc.recoveries.finish(entry)
    svc.num_replicas = target
    svc._drop_retired()


def _set_state(node, name: str, closed: bool) -> dict:
    svc = node.get_index(name)
    svc.closed = closed
    meta = node.cluster_state.indices.get(svc.name)
    if meta is not None:
        meta.state = "close" if closed else "open"
    node.cluster_state.next_version()
    node._persist_index_meta(svc.name)
    return {"acknowledged": True}


def close_index(node, name: str) -> dict:
    """POST /{index}/_close: the index stays registered, ops are refused."""
    return _set_state(node, name, True)


def open_index(node, name: str) -> dict:
    return _set_state(node, name, False)


def _block(svc, key: str) -> bool:
    idx = svc.settings.get("index", svc.settings)
    v = idx.get(f"blocks.{key}", idx.get("blocks", {}).get(key)
                if isinstance(idx.get("blocks"), dict) else None)
    return v in (True, "true", "1", 1)


def check_open(svc, op: str = "write") -> None:
    """The guard of the write and search paths: a closed index refuses
    both, ``blocks.write``/``blocks.read_only`` refuse writes and
    ``blocks.read`` reads."""
    if svc.closed:
        raise IndexClosedException(f"closed index [{svc.name}]")
    if op == "write" and (_block(svc, "write") or _block(svc, "read_only")):
        raise IndexBlockedException(
            f"index [{svc.name}] blocked: blocks.write/read_only")
    if op == "read" and _block(svc, "read"):
        raise IndexBlockedException(f"index [{svc.name}] blocked: blocks.read")
