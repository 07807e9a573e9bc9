"""IndexService: one index = mappings + analysis + N shards + routing.

Port of elasticsearch_tpu/index/index_service.py, slim: document ops route
by ``shard_id_for`` (murmur3 of routing or id, modulo the shard count).
``search`` tries the mesh path first (``parallel/mesh_service.py``: one
sequence of launches per segment round over every shard) and takes the
host query-then-fetch loop when the mesh declines, as the reference
does. ``index.search.mesh: false`` in the index settings, or the
``ESTPU_DISABLE_MESH`` environment variable, pins an index to the host
loop. The query cache, slowlog, replicas and percolator are not ported
yet.
"""
from __future__ import annotations

import os
import uuid
from typing import List, Optional

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.parallel.executor import MeshSearchExecutor
from elasticsearch_tpu_torch.parallel.mesh import shard_mesh
from elasticsearch_tpu_torch.parallel.mesh_service import try_mesh_search
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search.service import search_shards
from elasticsearch_tpu_torch.utils.errors import (IllegalArgumentException,
                                                  MapperParsingException)


class IndexService:
    def __init__(self, name: str, residency: Residency,
                 settings: Optional[dict] = None,
                 mappings_json: Optional[dict] = None,
                 data_path: Optional[str] = None):
        self.name = name
        self.residency = residency
        self.settings = settings or {}
        idx_settings = self.settings.get("index", self.settings)
        self.num_shards = int(idx_settings.get("number_of_shards", 1))
        self.analysis = AnalysisRegistry(self.settings)
        self.mappings = Mappings(mappings_json or {})
        self._validate_analyzers()
        self.shards: List[IndexShard] = [
            IndexShard(name, i, self.mappings, self.analysis, residency,
                       data_path)
            for i in range(self.num_shards)]
        self._mesh_executor: Optional[MeshSearchExecutor] = None
        if data_path:
            for shard in self.shards:
                shard.recover()

    def _validate_analyzers(self):
        """Reject mappings naming analyzers the registry can't build."""
        try:
            self.analysis.validate()
        except (ValueError, KeyError, TypeError) as e:
            raise IllegalArgumentException(
                f"failed to build analysis components: {e}") from e
        for name, fm in self.mappings.fields.items():
            if not fm.is_text:
                continue
            for an in (fm.analyzer, fm.search_analyzer):
                if an is None:
                    continue
                try:
                    self.analysis.get(an)
                except ValueError as e:
                    raise MapperParsingException(
                        f"analyzer [{an}] not found for field [{name}]") from e

    def route(self, doc_id: str, routing: Optional[str] = None) -> IndexShard:
        return self.shards[shard_id_for(doc_id, self.num_shards, routing)]

    def index_doc(self, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, **kw) -> dict:
        if doc_id is None:
            doc_id = uuid.uuid4().hex[:20]
        shard = self.route(doc_id, routing)
        rid, version, created = shard.engine.index(doc_id, source,
                                                   routing=routing, **kw)
        loc = shard.engine._locations[rid]
        return {
            "_index": self.name,
            "_type": kw.get("doc_type") or "_doc",
            "_id": rid,
            "_version": version,
            "_seq_no": loc.seq_no,
            "_primary_term": loc.term,
            "result": "created" if created else "updated",
            "created": created,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
        }

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True) -> dict:
        got = self.route(doc_id, routing).engine.get(doc_id, realtime=realtime)
        if got is None:
            return {"_index": self.name, "_type": "_doc", "_id": doc_id,
                    "found": False}
        got["_index"] = self.name
        return got

    def delete_doc(self, doc_id: str, routing: Optional[str] = None,
                   **kw) -> dict:
        engine = self.route(doc_id, routing).engine
        loc = engine._locations.get(str(doc_id))
        dtype = loc.doc_type if loc is not None and loc.doc_type else "_doc"
        version = engine.delete(doc_id, **kw)
        loc = engine._locations[str(doc_id)]
        return {
            "_index": self.name, "_type": dtype, "_id": doc_id,
            "_version": version, "_seq_no": loc.seq_no,
            "_primary_term": loc.term, "result": "deleted", "found": True,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
        }

    def refresh(self):
        for s in self.shards:
            s.refresh()

    def mesh_executor(self) -> MeshSearchExecutor:
        """The index's MeshSearchExecutor: one slot per shard on the
        node's device, over the live shards (never a segment snapshot,
        which would pin merged-away segments); its caches live as long
        as the index."""
        if self._mesh_executor is None:
            self._mesh_executor = MeshSearchExecutor(
                shard_mesh(self.num_shards, self.residency.device),
                self.shards, self.residency)
        return self._mesh_executor

    def _mesh_enabled(self) -> bool:
        if os.environ.get("ESTPU_DISABLE_MESH"):
            return False
        idx = self.settings.get("index", self.settings)
        return str(idx.get("search", {}).get("mesh", True)).lower() \
            != "false"

    def search(self, body: dict) -> dict:
        body = body or {}
        searchers = [s.searcher for s in self.shards]
        resp = None
        if self._mesh_enabled():
            # the default path; the host loop serves what the mesh declines
            resp = try_mesh_search(self, searchers, body)
        if resp is None:
            resp = search_shards(searchers, body, index_name=self.name)
        return resp

    @property
    def num_docs(self) -> int:
        return sum(s.engine.num_docs for s in self.shards)

    def close(self):
        if self._mesh_executor is not None:
            self._mesh_executor.close()
        for s in self.shards:
            s.close()
