"""IndexShard: one shard = engine (write path) + searcher (read path).

Port of elasticsearch_tpu/index/shard.py: the lifecycle state, gateway
recovery (the committed blocks, then the translog) and the shard's
stats. Replicas are not ported yet (ROADMAP A10c).
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
        translog_path = None
        if data_path:
            # the reference's on-disk layout: <data>/<index>/<shard>/translog
            translog_path = os.path.join(data_path, index_name,
                                         str(shard_id), "translog")
        self.engine = Engine(mappings, analysis, residency,
                             translog_path=translog_path,
                             index_name=index_name)
        # the searcher shares the engine's segment list object
        self.searcher = ShardSearcher(self.engine.segments, mappings,
                                      analysis, shard_ord=shard_id,
                                      index_name=index_name,
                                      version_of=self.engine.version_of)
        self.state = "STARTED"

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
            # no eviction in the port yet: what is charged stays resident
            "fielddata": {"memory_size_in_bytes": sum(s.fielddata_bytes()
                                                      for s in segs),
                          "evictions": 0},
            "translog": self.engine.translog.stats(),
            "seq_no": {"max_seq_no": self.engine.max_seq_no,
                       "local_checkpoint": self.engine.local_checkpoint},
        }

    def close(self):
        self.engine.close()
        self.state = "CLOSED"
