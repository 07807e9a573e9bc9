"""IndexShard: one shard = engine (write path) + searcher (read path).

Port of elasticsearch_tpu/index/shard.py, slim: no stats or replicas.
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

    def recover(self) -> int:
        replayed = self.engine.recover_from_translog()
        self.engine.refresh()
        return replayed

    @property
    def segments(self):
        return self.engine.segments

    def refresh(self):
        self.engine.refresh()

    def close(self):
        self.engine.close()
