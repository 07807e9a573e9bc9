"""Index search and indexing slow logs.

Port of elasticsearch_tpu/tracing/slowlog.py (reference: org/
elasticsearch/index/search/stats/ShardSearchSlowLog.java and
index/indexing/slowlog/IndexingSlowLog.java): per-index thresholds
(``index.search.slowlog.threshold.query.warn`` ... ``.trace``,
``index.indexing.slowlog.threshold.index.*``) route slow operations to
a logger at the matching level.

Thresholds are read from the live index settings on every record, so a
settings update takes effect at once, as the reference's dynamic
settings do. Entries go to the stdlib loggers ``index.search.slowlog``
and ``index.indexing.slowlog`` and to a bounded ring each index keeps;
``nodes_stats`` shows a node's slow-op counts summed over its own
indices (``monitor/stats.py::aggregate_slowlog``).
"""
from __future__ import annotations

import json
import logging
import threading
from collections import deque
from typing import Any, Callable, Optional

_LEVELS = ("warn", "info", "debug", "trace")
_PY_LEVEL = {"warn": logging.WARNING, "info": logging.INFO,
             "debug": logging.DEBUG, "trace": logging.DEBUG}


def parse_time_millis(v: Any) -> Optional[float]:
    """Threshold value → millis ("500ms", "1s", "2m", numeric millis);
    None / -1 / "-1" / garbage disable the level. Delegates to the ONE
    ES duration grammar (search/service.py::_parse_timeout — lazy
    import keeps this module light) so the two parsers can never drift;
    only the slowlog-specific sub-milli units and the never-raise
    disable semantics live here."""
    if v in (None, -1, "-1", ""):
        return None
    s = str(v).strip().lower()
    for suf, mul in (("nanos", 1e-6), ("micros", 1e-3)):
        if s.endswith(suf):
            head = s[: -len(suf)]
            if head.replace(".", "", 1).isdigit():
                return float(head) * mul
    from elasticsearch_tpu_torch.search.service import _parse_timeout

    try:
        sec = _parse_timeout(s)
    except Exception:
        return None  # an unparseable threshold disables, never 500s
    return None if sec is None else sec * 1000.0


def _setting(settings: dict, dotted: str) -> Any:
    """Read a dotted settings key tolerating both flat dotted keys and
    nested dicts, with or without the leading ``index.`` level (the same
    tolerance update_index_settings / _query_cache_enabled show)."""
    for root in (settings.get("index", settings), settings):
        if not isinstance(root, dict):
            continue
        if dotted in root:
            return root[dotted]
        if f"index.{dotted}" in root:
            return root[f"index.{dotted}"]
        cur: Any = root
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                cur = None
                break
            cur = cur[part]
        if cur is not None:
            return cur
    return None


class SlowLog:
    """One slow-log stream (search.query / search.fetch / indexing.index):
    threshold lookup per record, leveled stdlib logging, bounded ring."""

    def __init__(self, index_name: str, kind: str, op: str,
                 settings_fn: Callable[[], dict], max_entries: int = 128):
        self.index_name = index_name
        self.kind = kind  # "search" | "indexing"
        self.op = op      # "query" | "fetch" | "index"
        self._settings_fn = settings_fn
        self._lock = threading.Lock()
        self.entries: deque = deque(maxlen=max_entries)
        self.total = 0
        self._logger = logging.getLogger(f"index.{kind}.slowlog")

    def level_for(self, took_ms: float) -> Optional[str]:
        settings = self._settings_fn() or {}
        for level in _LEVELS:  # warn first: the most severe match wins
            thr = parse_time_millis(_setting(
                settings, f"{self.kind}.slowlog.threshold.{self.op}.{level}"))
            if thr is not None and took_ms >= thr:
                return level
        return None

    def maybe_record(self, took_ms: float,
                     source_fn: Optional[Callable[[], Optional[str]]] = None,
                     **detail: Any) -> Optional[dict]:
        """``source_fn`` is LAZY: the request-body serialization it
        usually wraps must only run for entries that actually record —
        with no thresholds configured (the default), every search would
        otherwise pay a json.dumps of its whole body for nothing."""
        level = self.level_for(took_ms)
        if level is None:
            return None
        if source_fn is not None:
            detail["source"] = source_fn()
        entry = {"index": self.index_name, "level": level, "op": self.op,
                 "took_millis": int(took_ms)}
        entry.update({k: v for k, v in detail.items() if v is not None})
        with self._lock:
            self.entries.append(entry)
            self.total += 1
        try:
            self._logger.log(
                _PY_LEVEL[level],
                "[%s] took[%dms], %s",
                self.index_name, int(took_ms),
                ", ".join(f"{k}[{v}]" for k, v in entry.items()
                          if k not in ("index", "level")))
        except Exception:  # logging config must never fail the request
            pass
        return entry

    def to_json(self) -> dict:
        with self._lock:
            return {"total": self.total, "entries": list(self.entries)}


class IndexSlowLog:
    """The per-index bundle: search query slow log + indexing slow log
    (reference: one ShardSearchSlowLog + IndexingSlowLog per index)."""

    def __init__(self, index_name: str, settings_fn: Callable[[], dict]):
        self.query = SlowLog(index_name, "search", "query", settings_fn)
        self.index = SlowLog(index_name, "indexing", "index", settings_fn)

    def on_search(self, took_ms: float, body: Optional[dict],
                  response: Optional[dict] = None) -> Optional[dict]:
        hits = None
        shards = None
        if isinstance(response, dict):
            hits = (response.get("hits") or {}).get("total")
            shards = (response.get("_shards") or {}).get("total")

        def _source() -> Optional[str]:
            if not body:
                return None
            try:
                return json.dumps(body, sort_keys=True, default=str)[:512]
            except (TypeError, ValueError):
                return None

        return self.query.maybe_record(took_ms, source_fn=_source,
                                       total_hits=hits,
                                       total_shards=shards)

    def on_index(self, took_ms: float, doc_id: Optional[str]) -> Optional[dict]:
        return self.index.maybe_record(took_ms, id=doc_id)

    def stats(self) -> dict:
        return {"search": self.query.to_json(),
                "indexing": self.index.to_json()}
