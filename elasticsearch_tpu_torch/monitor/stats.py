"""Search-phase counters and recovery accounting.

Port of the parts of elasticsearch_tpu/monitor/stats.py that the index
stats surface reads: ``SearchStats`` (each shard's query, fetch, suggest
and scroll counts and times, with the per-group counters a body's
``stats`` key asks for: ES 2.0's SearchStats groups),
``TranslogRecoveryStats`` (every corrupt translog tail a replay stopped
at, fed by ``index/translog.py``) and ``aggregate_recovery`` (a node's
recovery gauges over its indices' ``RecoveryRegistry`` entries), and
the node-level sections of ``nodes_stats`` (reference: org/elasticsearch/
monitor/ process/ProcessService.java, os/OsService.java):
``process_stats``, ``os_stats``, ``aggregate_slowlog`` and
``device_stats``, the card's counterpart of the reference's accelerator
section.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict

import torch


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


def aggregate_slowlog(index_services) -> dict:
    """A node's slow-operation counts over its own indices' slow logs
    (``tracing/slowlog.py``); the entries stay in each index's ring."""
    search_total = indexing_total = 0
    for svc in index_services:
        sl = getattr(svc, "slowlog", None)
        if sl is None:
            continue
        search_total += sl.query.total
        indexing_total += sl.index.total
    return {"search_slow_total": search_total,
            "indexing_slow_total": indexing_total}


def process_stats() -> dict:
    """The process section (reference: ProcessService)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "timestamp": int(time.time() * 1000),
        "open_file_descriptors": _count_fds(),
        "cpu": {"total_in_millis": int((ru.ru_utime + ru.ru_stime) * 1000)},
        "mem": {
            # the current resident set; the peak under its own name
            "resident_in_bytes": _current_rss() or ru.ru_maxrss * 1024,
            "peak_resident_in_bytes": ru.ru_maxrss * 1024,
        },
    }


def _current_rss() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _count_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def os_stats() -> dict:
    """The host section (reference: OsService)."""
    out: Dict[str, Any] = {"timestamp": int(time.time() * 1000)}
    try:
        load1, load5, load15 = os.getloadavg()
        out["cpu"] = {"load_average": {"1m": load1, "5m": load5,
                                       "15m": load15}}
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                parts = line.split()
                if parts[0] in ("MemTotal:", "MemFree:", "MemAvailable:"):
                    mem[parts[0][:-1]] = int(parts[1]) * 1024
        out["mem"] = {
            "total_in_bytes": mem.get("MemTotal", 0),
            "free_in_bytes": mem.get("MemFree", 0),
            "available_in_bytes": mem.get("MemAvailable", 0),
        }
    except OSError:
        pass
    return out


def device_stats(device) -> dict:
    """The accelerator section for the node's ``device``: on a card its
    name, ``hbm`` from ``torch.cuda.mem_get_info`` (in use = total less
    free, over all processes) and the caching allocator's
    ``memory_allocated``/``memory_reserved`` (a freed block stays
    reserved); on a CPU node ``platform: cpu``, without probing for a
    card it did not ask for."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "hbm": {"bytes_in_use": int(total - free),
                "bytes_limit": int(total)},
        "memory_allocated": int(torch.cuda.memory_allocated(device)),
        "memory_reserved": int(torch.cuda.memory_reserved(device)),
    }
