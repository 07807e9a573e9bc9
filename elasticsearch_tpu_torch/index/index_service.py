"""IndexService: one index = mappings + analysis + N shards + routing.

Port of elasticsearch_tpu/index/index_service.py, slim: document ops route
by ``shard_id_for`` (murmur3 of routing or id, modulo the shard count).
``search`` tries the mesh path first (``parallel/mesh_service.py``: one
sequence of launches per segment round over every shard) and takes the
host query-then-fetch loop when the mesh declines, as the reference
does. ``index.search.mesh: false`` in the index settings, or the
``ESTPU_DISABLE_MESH`` environment variable, pins an index to the host
loop.

``search_type: dfs_query_then_fetch`` first collects the index-wide
term statistics (``global_stats``) and scores every segment with them on
either route. The request cache (``_query_cache`` on the body, or the
index setting ``index.cache.query.enable``) keeps up to 256 ``size: 0``
responses keyed by the body and every shard's (index, delete, refresh,
merge) counters, so a write, a refresh or a merge moves the key.
``force_merge`` folds each shard's segments into one. A body's
more_like_this liked ids resolve over every shard before the search
(``mlt_source``, ``rewrite_mlt_in_body``). The slowlog, replicas and
percolator are not ported yet.
"""
from __future__ import annotations

import copy
import json
import os
import re
import threading
import uuid
from collections import OrderedDict
from typing import List, Optional, Tuple

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.parallel.executor import MeshSearchExecutor
from elasticsearch_tpu_torch.parallel.mesh import shard_mesh
from elasticsearch_tpu_torch.parallel.mesh_service import try_mesh_search
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search.context import GlobalStats, global_stats
from elasticsearch_tpu_torch.search.queries import rewrite_mlt_in_body
from elasticsearch_tpu_torch.search.service import search_shards
from elasticsearch_tpu_torch.utils.errors import (IllegalArgumentException,
                                                  IndexNotFoundException,
                                                  MapperParsingException)


#: now-relative date math in a serialised body ("now", "now-1d", "now/d");
#: plain words such as "nowhere" still cache
_NOW = re.compile(r'"now(?:["+/\-]|\\)', re.IGNORECASE)


class IndexService:
    #: request cache entries kept per index (LRU)
    QUERY_CACHE_CAP = 256

    def __init__(self, name: str, residency: Residency,
                 settings: Optional[dict] = None,
                 mappings_json: Optional[dict] = None,
                 data_path: Optional[str] = None, node=None):
        self.name = name
        self.residency = residency
        self._node = node  # resolves lookups that name another index
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
        self._query_cache: "OrderedDict[Tuple, dict]" = OrderedDict()
        self._qc_lock = threading.Lock()
        self.query_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
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
        self._drop_retired()

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Fold each shard's segments, in order, into one (ES 2.0's
        ``_optimize`` with ``max_num_segments``; a shard at or below it
        is left as it is)."""
        for s in self.shards:
            s.engine.merge(max_segments=max_num_segments)
        self._drop_retired()

    def _drop_retired(self) -> None:
        """A merge retired segments: the mesh executor lets go of their
        stacked copies and prepared rounds, and of those charges."""
        if self._mesh_executor is not None:
            self._mesh_executor.drop_retired()

    def global_stats(self) -> GlobalStats:
        """The dfs phase: the index-wide doc counts and doc freqs that
        give every shard's segments one idf."""
        return global_stats(seg for s in self.shards for seg in s.segments)

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

    # -- the request cache ---------------------------------------------------

    def _query_cache_enabled(self) -> bool:
        idx = self.settings.get("index", self.settings)
        v = idx.get("cache.query.enable", idx.get("index.cache.query.enable"))
        if v is None and isinstance(idx.get("cache"), dict):
            v = idx["cache"].get("query", {}).get("enable")
        return str(v).lower() in ("1", "true")

    def _query_cache_key(self, body: dict):
        """The request cache's key of a cacheable body, else None: only
        ``size: 0``, and never a scroll, a profile, dfs, a scan or
        now-relative date math; ``_query_cache`` on the body overrides
        the index setting."""
        override = body.get("_query_cache")
        if override is False:
            return None
        if override is None and not self._query_cache_enabled():
            return None
        if int(body.get("size", 10)) != 0 or body.get("scroll") \
                or body.get("profile"):
            return None
        if body.get("search_type") in ("dfs_query_then_fetch", "scan"):
            return None
        try:
            blob = json.dumps({k: v for k, v in body.items()
                               if k != "_query_cache"}, sort_keys=True)
        except TypeError:
            return None  # a body that does not serialise is not cached
        if _NOW.search(blob):
            return None
        # merge_total too: a force merge moves no other counter, and a
        # float sum over one merged segment differs in its last bits from
        # the sum over the segments it folded (the reference's key lacks
        # it and serves the pre-merge answer; ROADMAP C)
        gen = tuple((s.engine.stats.index_total, s.engine.stats.delete_total,
                     s.engine.stats.refresh_total,
                     s.engine.stats.merge_total) for s in self.shards)
        return gen, blob

    def clear_query_cache(self) -> None:
        with self._qc_lock:
            self._query_cache.clear()

    # -- search -----------------------------------------------------------------

    def search(self, body: dict) -> dict:
        """One index's search; ``search_type: dfs_query_then_fetch`` runs
        the dfs phase first."""
        body = body or {}
        dfs = body.get("search_type") == "dfs_query_then_fetch"
        qc_key = None if dfs else self._query_cache_key(body)
        if qc_key is not None:
            with self._qc_lock:
                hit = self._query_cache.get(qc_key)
                if hit is not None:
                    self._query_cache.move_to_end(qc_key)
                    self.query_cache_stats["hits"] += 1
                else:
                    self.query_cache_stats["misses"] += 1
            if hit is not None:
                return copy.deepcopy(hit)
        if "_query_cache" in body:
            body = {k: v for k, v in body.items() if k != "_query_cache"}
        if body.get("query"):
            # more_like_this liked ids (and terms lookups) resolve once
            # against the whole index before the per-shard fan-out
            q2 = rewrite_mlt_in_body(body["query"], self.mlt_source)
            if q2 is not body["query"]:
                body = dict(body, query=q2)
        gs = self.global_stats() if dfs else None
        searchers = [s.searcher for s in self.shards]
        resp = None
        if self._mesh_enabled():
            # the default path; the host loop serves what the mesh declines
            resp = try_mesh_search(self, searchers, body, gs)
        if resp is None:
            resp = search_shards(searchers, body, index_name=self.name,
                                 global_stats=gs)
        if qc_key is not None:
            entry = copy.deepcopy(resp)
            with self._qc_lock:
                self._query_cache[qc_key] = entry
                if len(self._query_cache) > self.QUERY_CACHE_CAP:
                    self._query_cache.popitem(last=False)
                    self.query_cache_stats["evictions"] += 1
        return resp

    def mlt_source(self, doc_id: str, routing=None, index=None):
        """The source of a doc a query names (more_like_this liked ids,
        terms lookups), found in any shard (a routed doc need not live at
        its id's shard, so the routing hint is not needed). A reference
        to another index resolves through the node; None when the doc or
        the index is missing."""
        if index is not None and index != self.name:
            node = self._node
            if node is None:
                return None
            try:
                names = node.resolve_indices(index)
            except IndexNotFoundException:
                return None
            for nm in names:
                svc = node.indices.get(nm)
                if svc is not None and svc is not self:
                    src = svc.mlt_source(doc_id, routing=routing)
                    if src is not None:
                        return src
            return None
        for sh in self.shards:
            got = sh.engine.get(str(doc_id))
            if got is not None:
                return got.get("_source")
        return None

    @property
    def num_docs(self) -> int:
        return sum(s.engine.num_docs for s in self.shards)

    def close(self):
        if self._mesh_executor is not None:
            self._mesh_executor.close()
        for s in self.shards:
            s.close()
