"""Search-phase counters and recovery accounting.

Port of the parts of elasticsearch_tpu/monitor/stats.py that the index
stats surface reads: ``SearchStats`` (each shard's query, fetch, suggest
and scroll counts and times, with the per-group counters a body's
``stats`` key asks for: ES 2.0's SearchStats groups),
``TranslogRecoveryStats`` (every corrupt translog tail a replay stopped
at, fed by ``index/translog.py``) and ``aggregate_recovery`` (a node's
recovery gauges over its indices' ``RecoveryRegistry`` entries).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict


class SearchStats:
    """One shard's search counters (ES's SearchStats.Stats)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.query_total = 0
        self.query_time_ms = 0.0
        self.fetch_total = 0
        self.fetch_time_ms = 0.0
        self.suggest_total = 0
        self.scroll_total = 0
        # the counters of each group a body's ``stats: [...]`` names
        self.groups: Dict[str, Dict[str, int]] = {}

    def _group(self, g: str) -> Dict[str, int]:
        return self.groups.setdefault(g, {
            "query_total": 0, "query_time_in_millis": 0,
            "fetch_total": 0, "fetch_time_in_millis": 0})

    def on_query(self, ms: float, n: int = 1, groups=None):
        """``n`` > 1: one batched run served n requests, counted as n
        sequential ones would be."""
        with self._lock:
            self.query_total += n
            self.query_time_ms += ms
            for g in groups or ():
                gs = self._group(str(g))
                gs["query_total"] += n
                gs["query_time_in_millis"] += int(ms)

    def on_fetch(self, ms: float, n: int = 1, groups=None):
        with self._lock:
            self.fetch_total += n
            self.fetch_time_ms += ms
            for g in groups or ():
                gs = self._group(str(g))
                gs["fetch_total"] += n
                gs["fetch_time_in_millis"] += int(ms)

    def on_suggest(self):
        with self._lock:
            self.suggest_total += 1

    def on_scroll(self):
        with self._lock:
            self.scroll_total += 1

    def to_json(self) -> dict:
        with self._lock:
            out = {
                "query_total": self.query_total,
                "query_time_in_millis": int(self.query_time_ms),
                "fetch_total": self.fetch_total,
                "fetch_time_in_millis": int(self.fetch_time_ms),
                "suggest_total": self.suggest_total,
                "scroll_total": self.scroll_total,
            }
            if self.groups:
                out["groups"] = {g: dict(gs) for g, gs in self.groups.items()}
        return out


class TranslogRecoveryStats:
    """Every corrupt tail a translog replay stopped at: the frames and
    bytes dropped are counted, so a loss shows instead of being inferred
    from doc counts. The detail ring is bounded; the counters are exact."""

    def __init__(self, max_events: int = 64):
        self._lock = threading.Lock()
        self.frames_skipped = 0
        self.bytes_dropped = 0
        self.events = deque(maxlen=max_events)

    def record(self, path: str, bytes_dropped: int, reason: str) -> None:
        with self._lock:
            self.frames_skipped += 1
            self.bytes_dropped += int(bytes_dropped)
            self.events.append({
                "path": path, "bytes_dropped": int(bytes_dropped),
                "reason": reason, "timestamp": int(time.time() * 1000)})

    def reset(self) -> None:
        with self._lock:
            self.frames_skipped = 0
            self.bytes_dropped = 0
            self.events.clear()

    def to_json(self) -> dict:
        with self._lock:
            return {"corrupt_tail_frames_skipped": self.frames_skipped,
                    "corrupt_tail_bytes_dropped": self.bytes_dropped,
                    "events": list(self.events)}


#: the process-wide sink the translog's replay reports to
TRANSLOG_RECOVERY = TranslogRecoveryStats()


def record_corrupt_tail(path: str, bytes_dropped: int, reason: str) -> None:
    TRANSLOG_RECOVERY.record(path, bytes_dropped, reason)


def aggregate_recovery(index_services) -> dict:
    """A node's recovery gauges over its own indices' registries:
    ``incremental`` counts ops-mode peer recoveries, ``full_copies`` the
    full streams (a gateway entry carries no mode). Every recovery runs
    inside one process, so ``current_as_source`` stays 0."""
    out = {"current_as_source": 0, "current_as_target": 0,
           "total": 0, "incremental": 0, "full_copies": 0,
           "ops_replayed": 0, "docs_copied": 0}
    for svc in index_services:
        for e in svc.recoveries.entries():
            out["total"] += 1
            if e["stage"] not in ("done", "failed"):
                out["current_as_target"] += 1
            if e.get("mode") == "ops":
                out["incremental"] += 1
            elif e.get("mode") == "full":
                out["full_copies"] += 1
            out["ops_replayed"] += e.get("ops_replayed", 0)
            out["docs_copied"] += e.get("docs_copied", 0)
    return out
