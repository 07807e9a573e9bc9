"""Shard recovery: the per-index record of recoveries, and local
(gateway) recovery.

Port of the parts of elasticsearch_tpu/index/recovery.py that a node
with no replicas runs. ``RecoveryRegistry`` keeps each index's recovery
entries (ES's RecoveriesCollection and RecoveryState): plain dicts the
running recovery updates in place,

    shard, type ("gateway"), mode (None for a gateway replay),
    stage ("init"|"translog"|"done"|"failed"), source, target,
    ops_replayed, docs_copied, docs_skipped, start_millis,
    total_time_in_millis

``recover_local`` is the gateway's replay of one shard: its committed
blocks, then its translog (``IndexShard.recover``). Peer recovery
(``recover_peer`` and the full copy) comes with replicas (ROADMAP A10c).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional


class RecoveryRegistry:
    def __init__(self, max_entries: int = 64):
        self._lock = threading.Lock()
        self._entries: "deque[dict]" = deque(maxlen=max_entries)

    def start(self, shard: int, rtype: str, source: str = "local",
              target: str = "local") -> dict:
        entry = {"shard": shard, "type": rtype, "mode": None,
                 "stage": "init", "source": source, "target": target,
                 "ops_replayed": 0, "docs_copied": 0, "docs_skipped": 0,
                 "start_millis": int(time.time() * 1000),
                 "total_time_in_millis": 0, "_t0": time.perf_counter()}
        with self._lock:
            self._entries.append(entry)
        return entry

    @staticmethod
    def finish(entry: dict, ok: bool = True) -> None:
        entry["total_time_in_millis"] = int(
            (time.perf_counter() - entry.pop("_t0", time.perf_counter()))
            * 1000)
        entry["stage"] = "done" if ok else "failed"

    def entries(self, shard: Optional[int] = None) -> list:
        with self._lock:
            out = [dict(e) for e in self._entries]
        if shard is not None:
            out = [e for e in out if e["shard"] == shard]
        return out


def recover_local(shard, registry: RecoveryRegistry) -> int:
    """Gateway recovery of one shard, recorded in ``registry`` as a
    ``gateway`` entry: ``ops_replayed`` counts the committed docs and the
    translog ops replayed; a failed replay leaves a ``failed`` entry and
    raises. Returns ops replayed."""
    entry = registry.start(shard.shard_id, "gateway")
    try:
        entry["stage"] = "translog"
        entry["ops_replayed"] = shard.recover()
    except Exception:
        registry.finish(entry, ok=False)
        raise
    registry.finish(entry)
    return entry["ops_replayed"]
