"""Per-index program census: persistence and replay.

Port of elasticsearch_tpu/resources/census.py. The program registry
(``monitor/programs.py``) learns, per index, which (program, shapes,
field) dispatch keys its traffic runs, how hot each is, and which
canonical search bodies drove them. This module persists that through
the blob tier (``index/ivf_cache.py``, ``<key>.census`` files beside the
IVF/PQ blobs and the kernel libraries), so a restarted node knows, before
its first request, what its index needs, and ``serving/warmup.py``
replays the bodies through the real search path, hottest first.

Format v2: ``sha1-hex\\n{json}`` (``ivf_cache.frame_blob``) with ``keys``
rows carrying per-key ``hits`` and a bounded ``bodies`` list; v1 blobs
load with ``hits: 1`` and no bodies. A damaged blob is deleted and is a
miss. The payload carries the port's ``backend_fingerprint`` (device
name, compute capability and device count), so a census taken under
another device count is refused (the reference's lacks the count:
ROADMAP C26).

:func:`store_census` merges with the persisted census (key and body
union, per-row ``max`` of hits, so repeated flushes never double-count)
and runs from the watchdog's tick, a shard's recovery and
``Node.close``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

_EXT = "census"
VERSION = 2

#: persisted-blob caps, the registry's own (``_CENSUS_CAP``/``_BODY_CAP``):
#: the hottest rows survive the cut, which is the set warmup reads
KEY_CAP = 1024
BODY_CAP = 64


def census_key(index_name: str) -> str:
    """Blob key of an index's census (name-addressed: the census is the
    content, validated by its digest)."""
    return "census_" + hashlib.sha1(index_name.encode("utf-8")).hexdigest()


def _key_id(row: dict) -> Tuple[str, str, str]:
    return (str(row.get("program", "")), str(row.get("shapes", "")),
            str(row.get("field", "")))


#: indices whose persisted census this process has decayed once (the
#: decay is per restart, not per flush)
_DECAYED: set = set()


def _merge_rows(persisted: List[dict], live: List[dict],
                ident, decay: bool = False) -> List[dict]:
    """Union by identity, ``hits`` = max(persisted, live): monotone under
    repeated flushes, and a key the process has not served yet is kept.

    ``decay`` (the first merge of each process): persisted rows not
    reinforced by live traffic halve their hits, so a workload that
    shifted falls out of the capped set in a few restarts."""
    merged: Dict[object, dict] = {}
    for row in persisted:
        r = dict(row)
        r["hits"] = int(r.get("hits", 1))
        merged[ident(r)] = r
    live_ids = set()
    for row in live:
        r = dict(row)
        r["hits"] = int(r.get("hits", 1))
        live_ids.add(ident(r))
        prev = merged.get(ident(r))
        if prev is None or r["hits"] > prev.get("hits", 1):
            merged[ident(r)] = r
    if decay:
        for key, r in merged.items():
            if key not in live_ids:
                r["hits"] = max(1, r["hits"] // 2)
    return sorted(merged.values(),
                  key=lambda r: (-r.get("hits", 1), str(sorted(r.items()))))


def _payload(index_name: str, keys: List[dict],
             bodies: List[dict]) -> Optional[dict]:
    from elasticsearch_tpu_torch.monitor import programs

    keys, bodies = keys[:KEY_CAP], bodies[:BODY_CAP]
    if not keys and not bodies:
        return None
    return {"version": VERSION, "index": index_name,
            "backend": programs.backend_fingerprint(),
            "keys": keys, "bodies": bodies}


def store_census(index_name: str,
                 keys: Optional[List[dict]] = None,
                 bodies: Optional[List[dict]] = None,
                 merge: bool = True) -> Optional[bytes]:
    """Persist ``index_name``'s key set and bodies (default: the live
    registry's), merged with the persisted census unless ``merge`` is
    False. Returns the blob, or None when there is nothing to persist
    (an idle restart never overwrites a census with emptiness)."""
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.monitor import programs

    if keys is None:
        keys = programs.REGISTRY.census(index_name)
    if bodies is None:
        bodies = programs.REGISTRY.bodies(index_name)
    if merge:
        prev = load_census(index_name)
        if prev is not None:
            decay = index_name not in _DECAYED
            _DECAYED.add(index_name)
            keys = _merge_rows(prev.get("keys", []), keys, _key_id,
                               decay=decay)
            bodies = _merge_rows(prev.get("bodies", []), bodies,
                                 lambda r: r.get("body"), decay=decay)
    payload = _payload(index_name, keys, bodies)
    if payload is None:
        return None
    blob = ivf_cache.frame_blob(payload)
    ivf_cache.store_blob(census_key(index_name), blob, _EXT)
    return blob


def export_census(index_name: str) -> Optional[dict]:
    """The census to ship beside a shard-recovery stream: the persisted
    census merged with the live one and capped, with no store, no decay
    and no frame (the transport owns integrity)."""
    from elasticsearch_tpu_torch.monitor import programs

    keys = programs.REGISTRY.census(index_name)
    bodies = programs.REGISTRY.bodies(index_name)
    prev = load_census(index_name)
    if prev is not None:
        keys = _merge_rows(prev.get("keys", []), keys, _key_id)
        bodies = _merge_rows(prev.get("bodies", []), bodies,
                             lambda r: r.get("body"))
    return _payload(index_name, keys, bodies)


def adopt_census(index_name: str, payload) -> bool:
    """Adopt a census shipped beside a recovery stream: validate its
    shape, refuse another backend fingerprint, and merge it into the
    persisted census so the target can pre-warm before its first
    request. Returns True when adopted."""
    from elasticsearch_tpu_torch.monitor import programs

    if not isinstance(payload, dict) \
            or payload.get("index") != index_name \
            or payload.get("version") not in (1, VERSION):
        return False
    keys = payload.get("keys")
    bodies = payload.get("bodies", [])
    if not isinstance(keys, list) or not isinstance(bodies, list):
        return False
    if payload.get("backend") != programs.backend_fingerprint():
        return False

    def _rows(rows, need=None):
        # a malformed row from a skewed source is skipped, never raised
        out = []
        for r in rows:
            if not isinstance(r, dict) or (need and not r.get(need)):
                continue
            try:
                out.append(dict(r, hits=int(r.get("hits", 1))))
            except (TypeError, ValueError):
                continue
        return out

    keys = _rows(keys)
    bodies = _rows(bodies, need="body")
    if not keys and not bodies:
        return False
    store_census(index_name, keys=keys, bodies=bodies, merge=True)
    return True


def load_census(index_name: str) -> Optional[dict]:
    """The persisted census of ``index_name`` or None; a damaged blob is
    deleted and is a miss. v1 payloads normalize to v2."""
    from elasticsearch_tpu_torch.index import ivf_cache

    key = census_key(index_name)
    blob = ivf_cache.load_blob(key, _EXT)
    if blob is None:
        return None
    payload = ivf_cache.unframe_blob(blob)
    if (payload is None
            or payload.get("version") not in (1, VERSION)
            or payload.get("index") != index_name
            or not isinstance(payload.get("keys"), list)
            or not isinstance(payload.get("bodies", []), list)):
        ivf_cache.delete_blob(key, _EXT)
        return None
    if payload.get("version") == 1:
        payload = dict(payload, version=VERSION, bodies=[],
                       keys=[dict(k, hits=int(k.get("hits", 1)))
                             for k in payload["keys"]])
    else:
        payload.setdefault("bodies", [])
    return payload


def replay(index_name: str) -> dict:
    """The persisted census against the live registry: which keys have
    dispatched in this process (``warm``) and which would pay their first
    touch (``missing``), and the bodies to replay, hottest first."""
    from elasticsearch_tpu_torch.monitor import programs

    payload = load_census(index_name)
    if payload is None:
        return {"found": False, "index": index_name}
    live = {(r["program"], r["shapes"])
            for r in programs.REGISTRY.snapshot()}
    missing = [k for k in payload["keys"]
               if (k.get("program"), k.get("shapes")) not in live]
    fp = programs.backend_fingerprint()
    return {
        "found": True,
        "index": index_name,
        "backend": payload.get("backend"),
        "backend_matches": payload.get("backend") == fp,
        "total": len(payload["keys"]),
        "warm": len(payload["keys"]) - len(missing),
        "missing": missing,
        "bodies": payload.get("bodies", []),
    }
