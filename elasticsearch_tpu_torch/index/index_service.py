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
(``mlt_source``, ``rewrite_mlt_in_body``). A body's ``suggest`` runs
after either route (``suggest``, ``search/suggest.py``).

Docs of type ``.percolator`` register their query in the index's
``percolator`` registry (validated before the write, registered after;
rebuilt after a translog replay; dropped on delete); ``percolate`` runs
them against a doc. ``update_doc`` merges a partial doc or runs a
script (a percolator doc takes partial updates only, re-registered);
``mget``, ``count`` and ``find_doc_locations`` (every live copy of an id,
for by-query) serve the rest of the write tail.

An index on a data path recovers on open: each shard replays its
durable commit and then its translog (``index/recovery.py``), recorded
in ``recoveries`` as a ``gateway`` entry. ``flush`` commits every shard
(``Engine.flush``). A closed index (``closed``, set by
``cluster/metadata.py``) refuses reads and writes, as do the
``blocks.*`` settings. ``aliases`` maps each alias to its spec
(``filter``, ``index_routing``, ``search_routing``), applied by the
node. ``stats()`` is ES's index stats: every shard's docs, indexing,
search (with the groups a body's ``stats`` key names), refresh, flush,
merges, segments, fielddata and translog, summed over the primaries,
with each shard's seq-no section (its group's global checkpoint too) and
the index's recovery gauges; a shard's search counters and fielddata sum
over its copies. ``slowlog`` (``tracing/slowlog.py``) records writes and
searches past the ``index.*.slowlog.threshold.*`` settings, read live.

Replicas (``number_of_replicas``, 0 by default as in the reference): each
shard is a ``ReplicationGroup`` (``groups``, ``cluster/replication.py``)
of a primary and its in-process replicas, each a whole ``IndexShard``
with its own device segments. Index, delete, update and bulk go through
the group (``_shards`` counts the copies); ``search`` reads one copy of
each group, picked once per request by ``preference`` (``_primary``,
``_replica``, or the next copy in turn), on either route. Count,
suggest, percolate, more_like_this, the dfs statistics and by-query's
lookups stay on the primaries (``shards``), as in the reference.
``fail_shard`` promotes a replica; on a data path the promoted copy
takes over the shard's translog and commit from the failed primary,
whose engine is failed first, and commits before its first write (the
reference's promoted copy keeps nothing on disk: ROADMAP C18). On a
restart the replicas re-sync from the recovered primaries
(``recover_peer``). Refresh, flush and force merge reach every copy (the
reference flushes and merges only the primaries: ROADMAP C17). The
reference's internal ``_local_replicas`` setting is popped, never
echoed: a cluster member (cluster/search_action.py) sets it to 0, since
its replicas are copies held by other members, while
``number_of_replicas`` still reports the declared count.
"""
from __future__ import annotations

import copy
import json
import os
import re
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.metadata import check_open
from elasticsearch_tpu_torch.cluster.replication import ReplicationGroup
from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.index.engine import _deep_merge
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.recovery import (RecoveryRegistry,
                                                    recover_local,
                                                    recover_peer)
from elasticsearch_tpu_torch.index.shard import IndexShard
from elasticsearch_tpu_torch.monitor.stats import aggregate_recovery
from elasticsearch_tpu_torch.parallel.executor import MeshSearchExecutor
from elasticsearch_tpu_torch.parallel.mesh import shard_mesh
from elasticsearch_tpu_torch.parallel.mesh_service import try_mesh_search
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search.context import GlobalStats, global_stats
from elasticsearch_tpu_torch.search.percolator import (PERCOLATOR_TYPE,
                                                       PercolatorRegistry,
                                                       highlight_matches,
                                                       match_queries,
                                                       percolate_segment)
from elasticsearch_tpu_torch.search.queries import rewrite_mlt_in_body
from elasticsearch_tpu_torch.search.scripting import script_source
from elasticsearch_tpu_torch.search.service import search_shards
from elasticsearch_tpu_torch.search.suggest import execute_suggest
from elasticsearch_tpu_torch.tracing.slowlog import IndexSlowLog
from elasticsearch_tpu_torch.utils.errors import (DocumentMissingException,
                                                  IllegalArgumentException,
                                                  IndexNotFoundException,
                                                  MapperParsingException,
                                                  RoutingMissingException)


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
        self.num_replicas = int(idx_settings.get("number_of_replicas", 0))
        # the cluster's marker: replicas are copies held by other members,
        # so this process holds ``_local_replicas`` in-process copies;
        # popped so it never leaks into the settings echo
        local = idx_settings.pop("_local_replicas", None)
        self.local_replicas = (int(local) if local is not None
                               else self.num_replicas)
        self.analysis = AnalysisRegistry(self.settings)
        # search and indexing slow logs, thresholds read from the live
        # settings on every record
        self.slowlog = IndexSlowLog(name, lambda: self.settings)
        self.mappings = Mappings(mappings_json or {})
        self._validate_analyzers()
        self.aliases: Dict[str, dict] = {}
        # search warmers by name, stored by the REST layer's warmer CRUD
        # and run at every refresh (``_run_warmers``)
        self.warmers: Dict[str, dict] = {}
        self.closed = False
        self.data_path = data_path
        self.recoveries = RecoveryRegistry()
        # shard i and its copies live on the registry of mesh device
        # i % min(shards, devices) (one registry: all of them there)
        self.shards: List[IndexShard] = [
            IndexShard(name, i, self.mappings, self.analysis,
                       residency.for_shard(i, self.num_shards), data_path)
            for i in range(self.num_shards)]
        # each shard's copies; a replica keeps no translog (it re-syncs
        # from its primary by peer recovery)
        self.groups: List[ReplicationGroup] = [
            ReplicationGroup(i, primary, [
                self._new_copy(i) for _ in range(self.local_replicas)])
            for i, primary in enumerate(self.shards)]
        self._mesh_executor: Optional[MeshSearchExecutor] = None
        self._query_cache: "OrderedDict[Tuple, dict]" = OrderedDict()
        self._qc_lock = threading.Lock()
        self.query_cache_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self._percolator: Optional[PercolatorRegistry] = None
        if data_path:
            try:
                self.recover()
            except Exception:
                self.close()  # the shards' translogs and device charges
                raise

    def _new_copy(self, shard_id: int) -> IndexShard:
        """A replica of shard ``shard_id``: in memory, empty, on its
        primary's device (a promotion moves nothing)."""
        return IndexShard(self.name, shard_id, self.mappings, self.analysis,
                          self.residency.for_shard(shard_id, self.num_shards),
                          None)

    def recover(self) -> None:
        """Gateway recovery: every primary replays its commit and its
        translog (a ``gateway`` entry each), each replica re-syncs from
        its primary (a ``replica`` entry each), then the percolator
        registry is rebuilt from the replayed docs."""
        for shard in self.shards:
            recover_local(shard, self.recoveries)
        for group in self.groups:
            for replica in group.replicas:
                entry = self.recoveries.start(group.shard_id, "replica")
                try:
                    recover_peer(group.primary.engine, replica.engine, entry)
                except Exception:
                    self.recoveries.finish(entry, ok=False)
                    raise
                self.recoveries.finish(entry)
            group._note_checkpoints()
        self._register_recovered_percolators()

    def fail_shard(self, shard_id: int) -> IndexShard:
        """Fail shard ``shard_id``'s primary: its first in-sync replica is
        promoted under a bumped term (ES's shard-failed reroute). On a
        data path the old primary's engine fails (its translog closes, so
        a stale group's write lands nowhere) and the promoted copy takes
        over the shard's store and commits, under the lock writes take,
        before it acknowledges a write. Returns the new primary."""
        group = self.groups[shard_id]
        with group._lock:
            old = group.primary
            new_primary = group.fail_primary()
            if self.data_path:
                old.engine.fail(
                    f"shard failed: copy [{new_primary.engine.commit_id}] "
                    f"promoted under term [{group.primary_term}]")
                new_primary.adopt_store(self.data_path)
        self.shards[shard_id] = new_primary
        # the old primary is read no more: its cached mesh data goes
        self._drop_retired()
        return new_primary

    def replay_op(self, shard_ord: int, d: dict) -> None:
        """Apply one op of a cluster recovery stream (a doc or a
        tombstone with its recorded version, seq no and term) to shard
        ``shard_ord`` at engine level, with the percolator registry kept
        in step, all under the engine lock, so a racing fan-out write can
        neither leave a stale registration nor lose one. Version
        conflicts propagate: the caller counts them as newer-state
        skips."""
        engine = self.shards[shard_ord].engine
        with engine._lock:
            loc = engine._locations.get(d["id"])
            was_perc = (loc is not None and not loc.deleted
                        and loc.doc_type == PERCOLATOR_TYPE)
            if d.get("deleted"):
                # _history: a recovery stream replays recorded identity;
                # ops below the copy's term are catch-up, not a zombie
                engine.delete(d["id"], version=d["version"],
                              version_type="external_gte",
                              seq_no=d.get("seq_no"),
                              primary_term=d.get("term"), _history=True)
            else:
                engine.index(d["id"], d["source"], version=d["version"],
                             version_type="external_gte",
                             doc_type=d.get("type"),
                             parent=d.get("parent"),
                             routing=d.get("routing"),
                             ttl_expiry=d.get("ttl_expiry"),
                             timestamp=d.get("timestamp"),
                             seq_no=d.get("seq_no"),
                             primary_term=d.get("term"),
                             _replay=True, _history=True)
            now = engine._locations.get(d["id"])
            is_perc = (now is not None and not now.deleted
                       and now.doc_type == PERCOLATOR_TYPE)
            if is_perc:
                try:
                    self.percolator.register(d["id"], d["source"])
                except Exception:
                    pass  # a query that no longer parses stays out
            elif was_perc:
                self.percolator.unregister(d["id"])

    def _register_recovered_percolators(self) -> None:
        """Rebuild the percolator registry from the replayed docs; a doc
        whose query no longer parses does not take part (it must not keep
        the index from opening)."""
        for shard in self.shards:
            for doc_id, loc in shard.engine._locations.items():
                if loc.deleted or loc.doc_type != PERCOLATOR_TYPE:
                    continue
                got = shard.engine.get(doc_id)
                if got and got.get("_source"):
                    try:
                        self.percolator.register(doc_id, got["_source"])
                    except Exception:
                        pass

    def _validate_analyzers(self, mappings: Optional[Mappings] = None):
        """Reject mappings (the index's, or a trial merge of a mappings
        PUT) naming analyzers the registry can't build."""
        mappings = mappings if mappings is not None else self.mappings
        try:
            self.analysis.validate()
        except (ValueError, KeyError, TypeError) as e:
            raise IllegalArgumentException(
                f"failed to build analysis components: {e}") from e
        for name, fm in mappings.fields.items():
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

    def group_for(self, doc_id: str,
                  routing: Optional[str] = None) -> ReplicationGroup:
        return self.groups[shard_id_for(doc_id, self.num_shards, routing)]

    def _shards_header(self, group: ReplicationGroup, failed: int) -> dict:
        """A write's ``_shards``: the copies the settings ask for, those
        that acknowledged it, those that failed it."""
        return {"total": 1 + self.num_replicas,
                "successful": 1 + len(group.replicas), "failed": failed}

    def index_doc(self, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, **kw) -> dict:
        check_open(self)
        if doc_id is None:
            doc_id = uuid.uuid4().hex[:20]
        self._check_routing_required(doc_id, kw.get("doc_type"),
                                     routing or kw.get("parent"))
        group = self.group_for(doc_id, routing)
        is_perc = kw.get("doc_type") == PERCOLATOR_TYPE
        if is_perc:
            # before the write: an unparsable query never reaches the
            # translog, where it would fail the replay
            self.percolator.validate(source)
        t0 = time.perf_counter()
        rid, version, created, failed, seq_no, term = group.index(
            doc_id, source, routing=routing, **kw)
        if is_perc:
            self.percolator.register(rid, source)
        dt = time.perf_counter() - t0
        self.slowlog.on_index(dt * 1000, rid)
        self._record_write_metric("index", dt)
        return {
            "_index": self.name,
            "_type": kw.get("doc_type") or "_doc",
            "_id": rid,
            "_version": version,
            "_seq_no": seq_no,
            "_primary_term": term,
            "result": "created" if created else "updated",
            "created": created,
            "_shards": self._shards_header(group, failed),
        }

    def _check_routing_required(self, doc_id, doc_type, routing) -> None:
        """``_routing: {required: true}``, and a type with a ``_parent``
        mapping, make routing (or the parent) mandatory on a write. As in
        the reference's Python API, the parent does not route the doc:
        callers give ``routing=parent``."""
        if routing is not None:
            return
        if self.mappings.routing_required or (
                doc_type and doc_type in self.mappings.parent_types):
            raise RoutingMissingException(self.name, doc_type or "_doc",
                                          str(doc_id))

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True, with_meta: bool = False) -> dict:
        """``with_meta``: the doc's location meta rides the answer
        (``_meta``: routing, parent, timestamp, ttl expiry) for a
        cluster coordinator, which cannot read a remote shard's table."""
        check_open(self, op="read")
        shard = self.route(doc_id, routing)
        got = shard.engine.get(doc_id, realtime=realtime)
        if got is None:
            return {"_index": self.name, "_type": "_doc", "_id": doc_id,
                    "found": False}
        got["_index"] = self.name
        if with_meta:
            loc = shard.engine._locations.get(str(doc_id))
            if loc is not None:
                got["_meta"] = {"routing": loc.routing,
                                "parent": loc.parent,
                                "timestamp": loc.timestamp,
                                "ttl_expiry": loc.ttl_expiry}
        return got

    def delete_doc(self, doc_id: str, routing: Optional[str] = None,
                   **kw) -> dict:
        check_open(self)
        group = self.group_for(doc_id, routing)
        loc = group.primary.engine._locations.get(str(doc_id))
        dtype = loc.doc_type if loc is not None and loc.doc_type else "_doc"
        t0 = time.perf_counter()
        version, _failed, seq_no, term = group.delete(doc_id, **kw)
        self._record_write_metric("delete", time.perf_counter() - t0)
        if self._percolator is not None:
            self._percolator.unregister(str(doc_id))
        # the reference reports no failed copy on a delete
        return {
            "_index": self.name, "_type": dtype, "_id": doc_id,
            "_version": version, "_seq_no": seq_no,
            "_primary_term": term, "result": "deleted", "found": True,
            "_shards": self._shards_header(group, 0),
        }

    def update_doc(self, doc_id: str, body: dict,
                   routing: Optional[str] = None,
                   doc_type: Optional[str] = None, **kw) -> dict:
        """ES 2.0's update API: ``doc`` (a partial doc), ``script`` (its
        ``params`` inside, or groovy's sibling ``params`` and ``lang``),
        ``upsert``, ``doc_as_upsert``, ``scripted_upsert``. A percolator
        doc takes partial updates only: the merged query is validated
        before the write and re-registered after."""
        check_open(self)
        engine = self.route(doc_id, routing).engine
        loc = engine._locations.get(str(doc_id))
        is_perc = loc is not None and not loc.deleted \
            and loc.doc_type == PERCOLATOR_TYPE
        if is_perc:
            if body.get("script") is not None:
                raise IllegalArgumentException(
                    "percolator documents cannot be script-updated")
            cur = engine.get(str(doc_id))
            merged = copy.deepcopy(cur["_source"]) if cur else {}
            _deep_merge(merged, body.get("doc") or {})
            self.percolator.validate(merged)
        script = body.get("script")
        script_src = params = None
        if script is not None:
            lang = ((script.get("lang") if isinstance(script, dict)
                     else None) or body.get("lang") or "groovy")
            if lang not in ("groovy", "painless", "painless-lite",
                            "expression"):
                raise IllegalArgumentException(
                    f"script_lang not supported [{lang}]")
            script_src = script_source(script)
            # a string script takes the body's sibling params (2.0's form)
            params = script.get("params") if isinstance(script, dict) \
                else body.get("params")
        version, created = engine.update(
            doc_id, partial=body.get("doc"), script=script_src,
            script_params=params, upsert=body.get("upsert"),
            doc_as_upsert=bool(body.get("doc_as_upsert", False)),
            scripted_upsert=bool(body.get("scripted_upsert", False)),
            doc_type=doc_type, routing=routing, **kw)
        # the merged source exists only on the primary: fan out its state
        group = self.group_for(doc_id, routing)
        group.replicate_current(str(doc_id))
        if is_perc:
            got = engine.get(str(doc_id))
            if got and got.get("_source"):
                self.percolator.register(str(doc_id), got["_source"])
        loc2 = engine._locations.get(str(doc_id))
        return {
            "_index": self.name,
            "_type": (loc2.doc_type if loc2 is not None and loc2.doc_type
                      else "_doc"),
            "_id": doc_id, "_version": version,
            "result": "created" if created else "updated",
            "_shards": self._shards_header(group, 0),
        }

    def mget(self, ids: List[str]) -> dict:
        return {"docs": [self.get_doc(i) for i in ids]}

    def find_doc_location(self, doc_id: str):
        """A live copy's DocLocation, found without its routing (by-query
        gets ids back from a search, not the routing they were written
        with); None when no shard holds it."""
        locs = self.find_doc_locations(doc_id)
        return locs[0] if locs else None

    def find_doc_locations(self, doc_id: str) -> list:
        """Every live copy of an id, shard by shard: custom routing can
        place one id on several shards, and by-query touches each copy
        with its own stored routing."""
        out = []
        for shard in self.shards:
            loc = shard.engine._locations.get(str(doc_id))
            if loc is not None and not loc.deleted:
                out.append(loc)
        return out

    def count(self, body: dict) -> dict:
        total = sum(s.searcher.count(body or {}) for s in self.shards)
        return {"count": total, "_shards": {"total": self.num_shards,
                                            "successful": self.num_shards,
                                            "failed": 0}}

    # -- suggest and percolate -------------------------------------------------

    def suggest(self, body: dict, shard_ids=None) -> dict:
        """The suggest body over the index's shards, or over ``shard_ids``
        of them (ES's suggest action and the search-embedded phase)."""
        shards = self.shards if shard_ids is None \
            else [self.shards[i] for i in shard_ids]
        for sh in shards:
            sh.searcher.stats.on_suggest()
        return execute_suggest(shards, body or {}, self.analysis,
                               mappings=self.mappings)

    @property
    def percolator(self) -> PercolatorRegistry:
        if self._percolator is None:
            self._percolator = PercolatorRegistry()
            self._percolator.doc_lookup = self.mlt_source
        return self._percolator

    def percolate(self, body: dict) -> dict:
        """Percolate ``doc`` against the registered queries (ES's
        percolate API): ``query``/``filter`` restrict which registered
        queries take part (a search over the ``.percolator`` docs),
        ``size`` cuts the listed matches (``total`` counts them all),
        ``highlight`` marks the doc once a listed match, ``aggs`` run over
        the matched ``.percolator`` docs."""
        body = body or {}
        doc = body.get("doc")
        if doc is None:
            raise DocumentMissingException(self.name,
                                           "_percolate requires [doc]")
        registry = self.percolator
        with percolate_segment([doc], self.mappings, self.analysis,
                               self.residency) as ctx:
            full = match_queries(registry, ctx, 1)[0] \
                if ctx is not None and len(registry) else []
            restrict = body.get("query") or body.get("filter")
            if restrict is not None:
                r = self.search({"query": {"bool": {
                    "must": [restrict],
                    "filter": [{"term": {"_type": PERCOLATOR_TYPE}}]}},
                    "size": 10_000, "_source": False})
                allowed = {h["_id"] for h in r["hits"]["hits"]}
                full = [qid for qid in full if qid in allowed]
            size = body.get("size")
            listed = full if size is None else full[: int(size)]
            out = {
                "took": 0,
                "_shards": {"total": self.num_shards,
                            "successful": self.num_shards, "failed": 0},
                "total": len(full),
                "matches": [{"_index": self.name, "_id": qid}
                            for qid in listed],
            }
            hl_spec = body.get("highlight")
            if hl_spec and listed:
                keep = set(listed)
                by_id = {qid: pair for qid, pair in registry.items()
                         if qid in keep}
                hl = highlight_matches(doc, by_id, hl_spec, ctx)
                for m in out["matches"]:
                    if m["_id"] in hl:
                        m["highlight"] = hl[m["_id"]]
        aggs_spec = body.get("aggs") or body.get("aggregations")
        if aggs_spec is not None:
            r = self.search({"query": {"bool": {"filter": [
                {"term": {"_type": PERCOLATOR_TYPE}},
                {"ids": {"values": full}}]}},
                "size": 0, "aggs": aggs_spec})
            out["aggregations"] = r.get("aggregations", {})
        return out

    def _copies(self) -> List[IndexShard]:
        return [c for g in self.groups for c in g.copies]

    def refresh(self):
        for g in self.groups:
            g.refresh()
        self._drop_retired()
        self._run_warmers()

    def _run_warmers(self) -> None:
        """Run each stored warmer against the fresh segments (ES 2.0's
        IndicesWarmer): its first dispatches, library loads and uploads
        are paid here, not by the next request. Through
        ``_search_inner``, so a warmer's search never lands in the
        latency series; a broken warmer never fails the refresh."""
        for body in list(self.warmers.values()):
            try:
                self._search_inner(body or {"query": {"match_all": {}}},
                                   None, None)
            except Exception:
                pass

    def flush(self) -> None:
        """Commit every copy (``Engine.flush``; a replica, with no data
        path, only refreshes and clears its empty in-memory log)."""
        for c in self._copies():
            c.engine.flush()
        self._drop_retired()

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Fold each copy's segments, in order, into one (ES 2.0's
        ``_optimize`` with ``max_num_segments``; a copy at or below it is
        left as it is)."""
        for c in self._copies():
            c.engine.merge(max_segments=max_num_segments)
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
        """The index's MeshSearchExecutor: one slot per shard over the
        node's devices (slot i on the device shard i lives on),
        following the groups (their live primaries, and every copy's
        segments as live for its caches), never a segment snapshot,
        which would pin merged-away segments; its caches live as long as
        the index."""
        if self._mesh_executor is None:
            self._mesh_executor = MeshSearchExecutor(
                shard_mesh(self.num_shards, self.residency.devices),
                self.groups, self.residency)
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

    def routed_groups(self, routing: Optional[str] = None
                      ) -> List[ReplicationGroup]:
        """Every group, or those a comma list of routing values routes
        to."""
        if routing is None:
            return list(self.groups)
        ids = {shard_id_for("", self.num_shards, r.strip())
               for r in str(routing).split(",")}
        return [self.groups[i] for i in sorted(ids)]

    def readers(self, routing: Optional[str] = None,
                preference: Optional[str] = None) -> List[IndexShard]:
        """The copy of each routed group a search reads (``reader``,
        called once per group and request, so round-robin turns once a
        request)."""
        return [g.reader(preference) for g in self.routed_groups(routing)]

    def _record_write_metric(self, op: str, seconds: float) -> None:
        """Write latency and op counters into the owning node's metrics
        registry (``monitor/metrics.py``); an IndexService built without
        a node records nothing."""
        node = self._node
        if node is None:
            return
        try:
            m = node.metrics
            m.histogram(
                "estpu_indexing_duration_seconds",
                "Write operation latency (engine + replication fanout)",
                ("op",)).labels(op).observe(seconds)
            m.counter(
                "estpu_indexing_operations_total",
                "Write operations by type", ("op",)).labels(op).inc()
        except Exception:  # a metrics failure must never fail the write
            pass

    def search(self, body: dict, routing: Optional[str] = None,
               preference: Optional[str] = None) -> dict:
        """One index's search; ``search_type: dfs_query_then_fetch`` runs
        the dfs phase first. ``routing`` (an alias's search routing)
        searches only the shards it routes to, on the host loop.
        ``preference`` picks the copy of each shard read (``readers``).

        The search runs in the program registry's index scope (the
        per-index census, ``monitor/programs.py``), and its latency
        lands in the node's ``estpu_search_duration_seconds`` labelled
        by ``warmup``: ``true`` when this thread paid a first touch
        inside it (a kernel library built or loaded, or a dispatch key's
        first run in the process: ``tracing/retrace.py``), ``false``
        otherwise, ``prewarm`` for a pre-warm replay
        (``serving/warmup.py``), which records no census body."""
        from elasticsearch_tpu_torch.monitor import programs
        from elasticsearch_tpu_torch.serving import warmup as warmup_mod
        from elasticsearch_tpu_torch.tracing import retrace

        t0 = time.perf_counter()
        snap = retrace.snapshot()
        prewarm = warmup_mod.in_prewarm()
        # a replay runs outside the census scope: it must not bump the
        # hit counts it was ordered by
        with programs.index_scope(None if prewarm else self.name):
            resp = self._search_inner(body, routing, preference)
        if prewarm:
            warmup = "prewarm"
        else:
            warmup = "true" if retrace.traces_since(snap) else "false"
            self._record_census_body(body)
        node = self._node
        if node is not None:
            try:
                node.metrics.histogram(
                    "estpu_search_duration_seconds",
                    "Search latency by index and warmup state (true = "
                    "paid first-touch work, false = steady, prewarm = "
                    "pre-warm replay)",
                    ("index", "warmup"),
                ).labels(self.name, warmup).observe(
                    time.perf_counter() - t0)
            except Exception:  # one dropped sample, never a failure
                pass
        return resp

    #: census-body sampling: every request for the first _CENSUS_FULL,
    #: then 1 in _CENSUS_SAMPLE with weighted hits
    _CENSUS_FULL = 256
    _CENSUS_SAMPLE = 8

    def _record_census_body(self, body: dict) -> None:
        """Feed the replayable half of the census: the canonical JSON of
        an eligible body. Profile bodies (they pin the host loop) and
        scroll bodies (they hold contexts) are left out."""
        if not isinstance(body, dict) or body.get("profile") \
                or body.get("scroll"):
            return
        self._census_seen = getattr(self, "_census_seen", 0) + 1
        weight = 1
        if self._census_seen > self._CENSUS_FULL:
            if self._census_seen % self._CENSUS_SAMPLE:
                return
            weight = self._CENSUS_SAMPLE
        try:
            canon = json.dumps(
                {k: v for k, v in body.items()
                 if k not in ("_query_cache", "profile")},
                sort_keys=True)
        except (TypeError, ValueError):
            return  # unserializable body: not replayable
        from elasticsearch_tpu_torch.monitor import programs

        programs.REGISTRY.record_body(self.name, canon, n=weight)

    def _search_inner(self, body: dict, routing: Optional[str],
                      preference: Optional[str]) -> dict:
        check_open(self, op="read")
        t0 = time.perf_counter()
        body = body or {}
        dfs = body.get("search_type") == "dfs_query_then_fetch"
        qc_key = None if dfs or routing is not None \
            else self._query_cache_key(body)
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
        searchers = [s.searcher for s in self.readers(routing, preference)]
        resp = None
        if routing is None and self._mesh_enabled():
            # the default path; the host loop serves what the mesh declines
            resp = try_mesh_search(self, searchers, body, gs)
        if resp is None:
            resp = search_shards(searchers, body, index_name=self.name,
                                 global_stats=gs)
        if body.get("suggest"):
            resp["suggest"] = self.suggest(body["suggest"])
        self.slowlog.on_search((time.perf_counter() - t0) * 1000, body, resp)
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

    def stats(self) -> dict:
        """ES's index stats: each shard's, their sums over the primaries,
        and the recovery gauges. A search reads one copy, so each shard's
        search counters and fielddata sum over its copies; its seq-no
        section gains the group's global checkpoint."""
        shards = [s.stats() for s in self.shards]
        for g, st in zip(self.groups, shards):
            for c in g.replicas:
                _merge_counters(st["search"], c.searcher.stats.to_json())
                _merge_counters(st["fielddata"], c.fielddata_stats())
            st["seq_no"]["global_checkpoint"] = g.global_checkpoint
        primaries = {"docs": {"count": 0}, "segments": {}, "indexing": {},
                     "search": {}, "refresh": {}, "flush": {}, "merges": {},
                     "fielddata": {}, "translog": {}}
        for st in shards:
            for sec in primaries:
                _merge_counters(primaries[sec], st[sec])
        return {"primaries": primaries,
                "shards": {str(i): st for i, st in enumerate(shards)},
                "recovery": aggregate_recovery([self])}

    def close(self):
        if self._mesh_executor is not None:
            self._mesh_executor.close()
        for g in self.groups:
            for c in g.copies + g.failed_replicas:
                c.close()


def _merge_counters(dst: dict, src: dict) -> None:
    """Sum numeric counters recursively (other values: the first wins)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _merge_counters(dst.setdefault(k, {}), v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            dst[k] = dst.get(k, 0) + v
        else:
            dst.setdefault(k, v)
