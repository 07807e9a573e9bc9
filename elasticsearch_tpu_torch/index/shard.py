"""IndexShard: one shard = engine (write path) + searcher (read path).

Port of elasticsearch_tpu/index/shard.py: the lifecycle state, gateway
recovery (the committed blocks, then the translog) and the shard's
stats. A primary and each of its replicas are IndexShards of their own
(``cluster/replication.py``); a replica has no data path until a
promotion hands it the shard's store (``adopt_store``).
"""
from __future__ import annotations

import os
from typing import Optional

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search.service import ShardSearcher


class IndexShard:
    def __init__(self, index_name: str, shard_id: int, mappings: Mappings,
                 analysis: AnalysisRegistry, residency: Residency,
                 data_path: Optional[str] = None):
        self.index_name = index_name
        self.shard_id = shard_id
        self.state = "CREATED"
        self.engine = Engine(mappings, analysis, residency,
                             translog_path=self._translog_path(data_path),
                             index_name=index_name)
        # the searcher shares the engine's segment list object
        self.searcher = ShardSearcher(self.engine.segments, mappings,
                                      analysis, shard_ord=shard_id,
                                      index_name=index_name,
                                      version_of=self.engine.version_of)
        self.state = "STARTED"

    def _translog_path(self, data_path: Optional[str]) -> Optional[str]:
        # the reference's on-disk layout: <data>/<index>/<shard>/translog
        if not data_path:
            return None
        return os.path.join(data_path, self.index_name, str(self.shard_id),
                            "translog")

    def adopt_store(self, data_path: str) -> None:
        """A promoted replica takes over the shard's store under
        ``data_path`` (``Engine.adopt_store``)."""
        self.engine.adopt_store(self._translog_path(data_path))

    def recover(self) -> int:
        """Replay the durable commit, then the translog past it, then
        refresh. Returns the docs and ops replayed."""
        self.state = "RECOVERING"
        replayed = self.engine.recover_from_commit()
        replayed += self.engine.recover_from_translog()
        self.engine.refresh()
        self.state = "STARTED"
        return replayed

    @property
    def segments(self):
        return self.engine.segments

    def refresh(self):
        self.engine.refresh()

    def fielddata_stats(self) -> dict:
        """The reference's ``fielddata`` section: the bytes resident now
        by field (``TpuSegment.fielddata_field_bytes``), with the
        evictions and rehydrations of the copy's fielddata handles."""
        fields: dict = {}
        evictions = rehydrations = 0
        for seg in list(self.engine.segments):
            for fname, b in seg.fielddata_field_bytes().items():
                fields[fname] = fields.get(fname, 0) + b
            ev, rh = seg.fielddata_evictions()
            evictions += ev
            rehydrations += rh
        return {"memory_size_in_bytes": sum(fields.values()),
                "evictions": evictions, "rehydrations": rehydrations,
                "fields": {f: {"memory_size_in_bytes": b}
                           for f, b in fields.items()}}

    def stats(self) -> dict:
        """ES's shard-level index stats."""
        e = self.engine.stats
        segs = self.engine.segments
        return {
            "docs": {"count": self.engine.num_docs},
            "indexing": {"index_total": e.index_total,
                         "delete_total": e.delete_total,
                         "index_time_in_millis": int(e.index_time_ms)},
            "get": {"total": e.get_total},
            "search": self.searcher.stats.to_json(),
            "refresh": {"total": e.refresh_total},
            "flush": {"total": e.flush_total},
            "merges": {"total": e.merge_total,
                       "total_docs": e.merge_docs,
                       "total_time_in_millis": int(e.merge_time_ms)},
            "segments": {"count": len(segs),
                         "memory_in_bytes": sum(s.memory_bytes()
                                                for s in segs)},
            "fielddata": self.fielddata_stats(),
            "translog": self.engine.translog.stats(),
            # ES's SeqNoStats: what a checkpoint-based recovery negotiates
            # on (the index adds its group's global checkpoint)
            "seq_no": self.engine.seq_no_stats(),
            # Lucene's CommitStats: the copy's identity and generation
            "commit": {"id": self.engine.commit_id,
                       "generation": e.refresh_total + e.flush_total + 1},
        }

    def close(self):
        self.engine.close()
        self.state = "CLOSED"
