"""Cross-process data plane: routed writes and query-then-fetch search.

Port of elasticsearch_tpu/cluster/search_action.py. Reference:
- action/search/type/TransportSearchQueryThenFetchAction.java:1-140 — the
  coordinator scatters a query phase to every shard, merges the ranked
  candidates, then fetches ONLY the selected page by search-context id.
- search/action/SearchServiceTransportAction.java:1-120 — the per-node
  wire actions those phases ride.
- action/index/TransportIndexAction.java + routing/OperationRouting —
  writes hash-routed to the shard's owner node.

Within a member process, an index's local shards run the mesh or the
host loop as a single node does (B1 runs in the owning member's query
phase); between processes these JSON transport actions carry the query,
fetch and write requests. A member's query reply is small (top-k ids,
scores, sort values and packed agg partials, never per-doc columns), so
a cross-process search costs one round trip a phase, not a document. The
query phase turns its results into host values once, at its end:
``utils/wire.py`` refuses a tensor.

Shard ownership lives in the master-published index metadata
(``MultiHostCluster.dist_indices``): shard i of an S-shard index is owned
by ``sorted(node_ids)[i % world]`` at creation time. Every process
creates the full S-shard index locally (mappings and shard numbering
must agree with ``cluster/routing.py::shard_id_for`` everywhere); only
the owned shards ever hold documents.

The compile/warm layer rides the same plane: the owner's query phase,
its fetch and the coordinator run in the index's program scope
(``monitor/programs.py``), so each member's census holds the traffic it
served; a recovery's shard-sync reply carries the source's census and
the kernel-library blobs the target lacks (``parallel/aot.py``), and a
graduated copy adopts them, flushes its census and queues its pre-warm
replay (``serving/warmup.py``) before its first request. The census
work is debounced per index (``_census_window``): one recovery syncs
every shard.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.cluster.transport import RemoteException, TransportError
from elasticsearch_tpu_torch.monitor import programs
from elasticsearch_tpu_torch.index.seqno import (GlobalCheckpointTracker,
                                           NO_OPS_PERFORMED)
from elasticsearch_tpu_torch.tracing import TaskCancelledException
from elasticsearch_tpu_torch.utils import wire
from elasticsearch_tpu_torch.utils.errors import (
    ElasticsearchTpuException, FailedToCommitClusterStateException,
    IndexNotFoundException, StalePrimaryException)
from elasticsearch_tpu_torch.utils.faults import FAULTS
from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.parallel import aot
from elasticsearch_tpu_torch.resources import census
from elasticsearch_tpu_torch.serving import warmup as warmup_mod

ACTION_QUERY = "indices:data/read/search[phase/query]"
ACTION_FETCH = "indices:data/read/search[phase/fetch]"
ACTION_FREE = "indices:data/read/search[free_context]"
ACTION_INDEX = "indices:data/write/index"
ACTION_DELETE = "indices:data/write/delete"
ACTION_UPDATE = "indices:data/write/update"
ACTION_GET = "indices:data/read/get"
ACTION_REFRESH = "indices:admin/refresh"
ACTION_CREATE = "indices:admin/create"
ACTION_DELETE_INDEX = "indices:admin/delete"
ACTION_SET_CLOSED = "indices:admin/set_closed"
ACTION_RECOVER = "indices:recovery/start"
ACTION_SHARD_SYNC = "indices:recovery/shard_sync"
ACTION_SHARD_FAILED = "cluster:shard_failed"
ACTION_SHARD_DOCS = "indices:monitor/shard_docs"
ACTION_SNAPSHOT = "cluster:admin/snapshot/create"
ACTION_SNAPSHOT_SHARD = "indices:admin/snapshot/shard"
ACTION_RESTORE = "cluster:admin/snapshot/restore"
ACTION_RESTORE_SHARDS = "indices:admin/snapshot/restore_shards"
ACTION_ALIASES = "indices:admin/aliases"
ACTION_APPLY_GLOBAL = "cluster:admin/apply_global_state"
ACTION_BY_QUERY = "indices:data/write/by_query"
ACTION_REST_PROXY = "internal:rest/proxy"
ACTION_CANCEL_TASKS = "cluster:admin/tasks/cancel"
ACTION_ALLOC_USAGE = "cluster:monitor/allocation/usage"
ACTION_SHARD_CKPT = "indices:monitor/shard_checkpoint"
ACTION_CLUSTER_SETTINGS = "cluster:admin/settings/apply"

_CONTEXT_TTL = 120.0
# coordinator-side cap on one search's scatter+fetch wall time when the
# request body carries no explicit `timeout`
_SEARCH_DEADLINE = 30.0


def shard_failure_entry(index: str, sid: int, exc: Optional[Exception] = None,
                        node: Optional[str] = None,
                        error_type: Optional[str] = None,
                        reason: Optional[str] = None,
                        status: Optional[int] = None) -> dict:
    """One `_shards.failures[]` element, ES-shaped (reference:
    ShardSearchFailure.toXContent): names the shard, the node, the HTTP
    status, and a typed `reason` so clients can distinguish a dead peer
    (connect_transport_error) from a per-shard execution error."""
    if exc is not None:
        error_type = error_type or getattr(exc, "error_type",
                                           type(exc).__name__)
        reason = reason or str(exc)
        status = status or getattr(exc, "status", 500)
    return {"shard": sid, "index": index, "node": node,
            "status": status or 500,
            "reason": {"type": error_type or "exception",
                       "reason": reason or ""}}


def _translog_to_replay(op: dict) -> dict:
    """Translog frame → the replay_op dict shape the recovery stream uses
    (IndexService.replay_op), preserving the (seq_no, term) identity."""
    if op.get("op") == "delete":
        return {"id": op["id"], "deleted": True,
                "version": op.get("version"),
                "seq_no": op.get("seq_no"), "term": op.get("term")}
    return {"id": op["id"], "source": op.get("source"),
            "version": op.get("version"), "type": op.get("doc_type"),
            "parent": op.get("parent"), "routing": op.get("routing"),
            "timestamp": op.get("timestamp"),
            "ttl_expiry": op.get("ttl_expiry"),
            "seq_no": op.get("seq_no"), "term": op.get("term")}


def by_query_task_action(op: str) -> str:
    """ES task action name for a by-query op (reference:
    DeleteByQueryAction.NAME / UpdateByQueryAction.NAME)."""
    return (f"indices:data/write/{op}/byquery" if op in ("delete", "update")
            else f"indices:data/write/{op}")


class DistributedDataService:
    """Per-process endpoint + coordinator for cross-host data operations."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.node = cluster.node
        # search contexts: cid -> {"pairs": [(searcher, ShardDoc)], "born": t}
        self._contexts: Dict[str, dict] = {}
        self._lock = threading.Lock()
        # per-(index, shard) primary write serialization: apply + replica
        # fanout must be one atomic step, or two client threads' fanouts
        # can reach a replica out of version order
        self._write_locks: Dict[Tuple[str, int], threading.Lock] = {}
        # per-(index, shard) global-checkpoint trackers, maintained by the
        # PRIMARY owner from the local checkpoints replicas report on each
        # fanout ack (reference: ReplicationTracker on the primary)
        self._gckpts: Dict[Tuple[str, int], GlobalCheckpointTracker] = {}
        t = cluster.transport
        t.register(ACTION_QUERY, self._on_query)
        t.register(ACTION_FETCH, self._on_fetch)
        t.register(ACTION_FREE, self._on_free)
        t.register(ACTION_INDEX, self._on_index)
        t.register(ACTION_DELETE, self._on_delete)
        t.register(ACTION_UPDATE, self._on_update)
        t.register(ACTION_GET, self._on_get)
        t.register(ACTION_REFRESH, self._on_refresh)
        t.register(ACTION_CREATE, self._on_create)
        t.register(ACTION_DELETE_INDEX, self._on_delete_index)
        t.register(ACTION_SET_CLOSED, self._on_set_closed)
        t.register(ACTION_RECOVER, self._on_recover)
        t.register(ACTION_SHARD_SYNC, self._on_shard_sync)
        t.register(ACTION_SHARD_FAILED, self._on_shard_failed)
        t.register(ACTION_SHARD_DOCS, self._on_shard_docs)
        t.register(ACTION_SNAPSHOT, self._on_snapshot)
        t.register(ACTION_SNAPSHOT_SHARD, self._on_snapshot_shard)
        t.register(ACTION_RESTORE, self._on_restore)
        t.register(ACTION_RESTORE_SHARDS, self._on_restore_shards)
        t.register(ACTION_ALIASES,
                   lambda p: self.node.update_aliases(p["actions"]))
        t.register(ACTION_APPLY_GLOBAL, self._on_apply_global)
        t.register(ACTION_BY_QUERY, self._on_by_query)
        t.register(ACTION_REST_PROXY, self._on_rest_proxy)
        t.register(ACTION_CANCEL_TASKS, self._on_cancel_tasks)
        t.register(ACTION_ALLOC_USAGE, lambda p: self.local_alloc_usage())
        t.register(ACTION_SHARD_CKPT, self._on_shard_ckpt)
        t.register(ACTION_CLUSTER_SETTINGS, self._on_cluster_settings)
        self._proxy_controller = None

    # -- ownership -----------------------------------------------------------

    def resolve_index(self, index: str) -> str:
        """Resolve an alias to its single distributed index: aliases ride
        the published dist metadata (restore attaches them), and every
        process applies them to its local copy on adopt, so resolution
        works on coordinators that own no shard of the target."""
        if index in self.cluster.dist_indices:
            return index
        names = self.node.resolve_indices(index)
        if len(names) == 1 and names[0] in self.cluster.dist_indices:
            return names[0]
        return index

    def _meta(self, index: str) -> dict:
        meta = self.cluster.dist_indices.get(index)
        if meta is None:
            raise IndexNotFoundException(index)
        return meta

    def owner_of(self, index: str, shard_id: int) -> str:
        """Primary owner. assignment maps shard -> [primary, *replicas]."""
        owners = self._meta(index)["assignment"][str(shard_id)]
        if not owners:
            raise TransportError(
                f"[{index}][{shard_id}] has no active copies")
        return owners[0]

    def _local_id(self) -> str:
        return self.cluster.local.node_id

    # -- replication safety ---------------------------------------------------

    @staticmethod
    def _shard_term(meta: dict, sid: int) -> int:
        """The shard's current primary term from the published metadata
        (legacy metas without the key are term 1 — the pre-seqno world)."""
        return int(meta.setdefault("primary_terms", {})
                   .setdefault(str(sid), 1))

    @staticmethod
    def _shard_in_sync(meta: dict, sid: int) -> list:
        """The shard's explicit in-sync copy set. Legacy metas default it
        to the current assignment (every committed copy was fanout-fed)."""
        return meta.setdefault("in_sync", {}).setdefault(
            str(sid), list(meta["assignment"].get(str(sid), [])))

    def _fence_replica_op(self, index: str, sid: int,
                          op_term: Optional[int]) -> None:
        """Replica-side term fence against this node's OWN view of the
        shard's primary term (the master-published metadata): an op from
        a term older than the published one comes from a demoted primary
        that doesn't know it yet. This fences even before the new primary
        has sent a single op (the engine-level fence, which adopts terms
        from op traffic, is the backstop)."""
        if op_term is None:
            return
        meta = self.cluster.dist_indices.get(index)
        if meta is None:
            return
        cur = self._shard_term(meta, sid)
        if op_term < cur:
            raise StalePrimaryException(index, sid, op_term, cur)

    def _checkpoint_tracker(self, index: str, sid: int,
                            meta: dict) -> GlobalCheckpointTracker:
        key = (index, sid)
        with self._lock:
            t = self._gckpts.get(key)
            if t is None:
                t = self._gckpts[key] = GlobalCheckpointTracker()
        t.set_in_sync(self._shard_in_sync(meta, sid))
        return t

    def global_checkpoint(self, index: str, sid: int) -> int:
        with self._lock:
            t = self._gckpts.get((index, sid))
        return t.global_checkpoint if t is not None else NO_OPS_PERFORMED

    def _addr(self, node_id: str) -> Tuple[str, int]:
        n = self.node.cluster_state.nodes.get(node_id)
        if n is None or ":" not in n.transport_address:
            raise TransportError(f"node [{node_id}] has no transport address")
        host, port = n.transport_address.rsplit(":", 1)
        return host, int(port)

    def _send(self, node_id: str, action: str, payload: dict,
              timeout: float = 30.0) -> Any:
        return self.cluster.transport.send_remote(
            self._addr(node_id), action, payload, timeout=timeout)

    def _send_idempotent(self, node_id: str, action: str, payload: dict,
                         timeout: float = 30.0,
                         deadline: Optional[float] = None) -> Any:
        """Retrying send for IDEMPOTENT actions (query/fetch/get):
        transport-level failures back off and retry inside the caller's
        deadline, and the per-peer breaker fast-fails a node that just
        refused repeatedly instead of burning the deadline on it again
        (cluster/transport.py::send_with_retry)."""
        return self.cluster.transport.send_with_retry(
            self._addr(node_id), action, payload, timeout=timeout,
            deadline=deadline)

    # -- admin ---------------------------------------------------------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        """Create an index with shards assigned round-robin across the
        current members (reference: MetaDataCreateIndexService + the
        allocation pass). Master performs it; others route to the master."""
        self.cluster.ensure_not_blocked("metadata_write")
        if not self.cluster.is_master:
            return self.cluster.transport.send_remote(
                self.cluster.master_addr, ACTION_CREATE,
                {"name": name, "body": body})
        return self._on_create({"name": name, "body": body})

    def _on_create(self, payload: dict) -> dict:
        # forwarded metadata ops re-check on ARRIVAL: a stale view may
        # route to a stepped-down or never-master node — it must fail
        # typed, never execute and publish a state the quorum's master
        # will contradict
        self.cluster.ensure_not_blocked("metadata_write")
        self.cluster._require_master(ACTION_CREATE)
        name, body = payload["name"], payload.get("body") or {}
        with self.cluster._indices_lock:
            if name in self.cluster.dist_indices:
                # re-creating would recompute the assignment over the
                # CURRENT membership and orphan every doc routed under the
                # old one
                from elasticsearch_tpu_torch.utils.errors import \
                    IndexAlreadyExistsException

                raise IndexAlreadyExistsException(name)
            nodes = sorted(self.node.cluster_state.nodes)
            settings = dict(body.get("settings") or {})
            num_shards = int(settings.get("number_of_shards", 1))
            # number_of_replicas means CROSS-HOST copies here: the
            # declared count STAYS in the settings (echo, _shards math)
            # while the internal _local_replicas=0 marker stops each
            # process from also materializing in-process replica groups
            replicas = int(settings.get("number_of_replicas", 0))
            settings["_local_replicas"] = 0
            local_body = dict(body)
            local_body["settings"] = settings
            assignment = {}
            for i in range(num_shards):
                owners = [nodes[i % len(nodes)]]
                for r in range(1, replicas + 1):
                    cand = nodes[(i + r) % len(nodes)]
                    if cand not in owners:
                        owners.append(cand)
                assignment[str(i)] = owners
            if payload.get("pending"):
                # restore path: every copy starts INITIALIZING (not
                # searchable, not a write target) and graduates into the
                # assignment only when its replay succeeds — the
                # reference's SNAPSHOT recovery source keeps restoring
                # shards in INITIALIZING the same way
                meta = {"body": local_body, "num_shards": num_shards,
                        "replicas": replicas,
                        "assignment": {str(i): [] for i in range(num_shards)},
                        "initializing": {k: list(v)
                                         for k, v in assignment.items()},
                        "primary_terms": {str(i): 1
                                          for i in range(num_shards)},
                        "in_sync": {str(i): [] for i in range(num_shards)}}
            else:
                meta = {"body": local_body, "num_shards": num_shards,
                        "replicas": replicas, "assignment": assignment,
                        # copies being recovered: visible for write fanout
                        # (they must see live writes during the copy), NOT
                        # promotable or searchable until recovery succeeds
                        # — the reference's INITIALIZING shard state
                        "initializing": {},
                        # replication safety: per-shard primary terms and
                        # the explicit in-sync copy set promotion selects
                        # from (index/seqno.py; reference: primaryTerm in
                        # IndexMetaData + in-sync allocation ids)
                        "primary_terms": {str(i): 1
                                          for i in range(num_shards)},
                        "in_sync": {k: list(v)
                                    for k, v in assignment.items()}}
            self.cluster.dist_indices[name] = meta
            created_local = not self.node.index_exists(name)
            if created_local:
                self.node.create_index(name, local_body)
        try:
            self.cluster.publish_indices()
        except Exception:
            # the metadata change never committed (no publish quorum —
            # the master just stepped down): ROLL BACK the local half so
            # this node holds no index the majority will never know
            # about, then fail the client op typed
            with self.cluster._indices_lock:
                self.cluster.dist_indices.pop(name, None)
                if created_local and self.node.index_exists(name):
                    try:
                        self.node._delete_local_index(name)
                    except Exception:  # rollback
                        pass           # is best-effort; the typed 503
                        # below is the authoritative outcome
                # the pre-publish persist already wrote the index to
                # dist_indices.json — re-persist the rolled-back map or
                # a master restart resurrects an index the client was
                # told (503) never committed
                self.cluster._persist_dist_meta()
            raise
        return {"acknowledged": True, "index": name,
                "assignment": assignment, "local_body": local_body}

    def set_closed(self, name: str, closed: bool) -> dict:
        """Mark a distributed index open/closed in the published metadata
        (reference: MetaDataIndexStateService — open/close is cluster
        state, not a node-local flag). Peers apply it on adopt."""
        self.cluster.ensure_not_blocked("metadata_write")
        if not self.cluster.is_master:
            return self.cluster.transport.send_remote(
                self.cluster.master_addr, ACTION_SET_CLOSED,
                {"name": name, "closed": closed})
        return self._on_set_closed({"name": name, "closed": closed})

    def _on_set_closed(self, payload: dict) -> dict:
        # forwarded metadata ops re-check on ARRIVAL: a stale view may
        # route to a stepped-down or never-master node — it must fail
        # typed, never execute and publish a state the quorum's master
        # will contradict
        self.cluster.ensure_not_blocked("metadata_write")
        self.cluster._require_master(ACTION_SET_CLOSED)
        from elasticsearch_tpu_torch.cluster.metadata import (close_index,
                                                        open_index)

        name, closed = payload["name"], payload["closed"]
        with self.cluster._indices_lock:
            meta = self.cluster.dist_indices.get(name)
            prior = None if meta is None else meta.get("closed")
            if meta is not None:
                meta["closed"] = bool(closed)
            had_local = self.node.index_exists(name)
            if had_local:
                (close_index if closed else open_index)(self.node, name)
        try:
            self.cluster.publish_indices()
        except Exception:
            # not committed: revert both halves (metadata flag + local
            # open/close) so this node doesn't diverge from the state
            # the quorum's master will republish
            with self.cluster._indices_lock:
                if meta is not None:
                    if prior is None:
                        meta.pop("closed", None)
                    else:
                        meta["closed"] = prior
                if had_local:
                    (close_index if prior else open_index)(self.node,
                                                           name)
                self.cluster._persist_dist_meta()
            raise
        return {"acknowledged": True}

    def delete_index(self, name: str) -> dict:
        """Delete a distributed index CLUSTER-WIDE: the master drops it
        from the published metadata (peers remove their local copies on
        the next publish — bootstrap._adopt_indices) and deletes its own
        copy. Reference: MetaDataDeleteIndexService. Without this, a
        local-only delete left the metadata alive and the next publish
        resurrected the index on every peer."""
        self.cluster.ensure_not_blocked("metadata_write")
        if not self.cluster.is_master:
            return self.cluster.transport.send_remote(
                self.cluster.master_addr, ACTION_DELETE_INDEX,
                {"name": name})
        return self._on_delete_index({"name": name})

    def _on_delete_index(self, payload: dict) -> dict:
        # forwarded metadata ops re-check on ARRIVAL: a stale view may
        # route to a stepped-down or never-master node — it must fail
        # typed, never execute and publish a state the quorum's master
        # will contradict
        self.cluster.ensure_not_blocked("metadata_write")
        self.cluster._require_master(ACTION_DELETE_INDEX)
        name = payload["name"]
        with self.cluster._indices_lock:
            prior = self.cluster.dist_indices.pop(name, None)
        try:
            self.cluster.publish_indices()
        except Exception:
            # the delete never committed (no publish quorum — the master
            # stepped down): restore the metadata and KEEP the local
            # shard data; destroying it before the quorum gate would
            # leave this node dataless for an index the majority still
            # serves, after telling the client 503 "not committed"
            with self.cluster._indices_lock:
                if prior is not None \
                        and name not in self.cluster.dist_indices:
                    self.cluster.dist_indices[name] = prior
                self.cluster._persist_dist_meta()
            raise
        with self.cluster._indices_lock:
            if self.node.index_exists(name):
                # bypass Node.delete_index's dist routing (we ARE it);
                # destruction happens only AFTER the quorum committed
                self.node._delete_local_index(name)
        return {"acknowledged": True}

    def refresh(self, index: str) -> None:
        index = self.resolve_index(index)
        self._meta(index)
        self.node.indices[index].refresh()
        errs = []
        for nid in self._other_nodes():
            try:
                self._send(nid, ACTION_REFRESH, {"index": index})
            except Exception as e:
                # keep going: one dead peer must not leave LATER peers
                # unrefreshed (a snapshot would then capture them stale
                # while counting their shards successful)
                errs.append(nid)
                last = e
        if errs:
            raise TransportError(
                f"refresh of [{index}] failed on {errs}: {last}")

    def _other_nodes(self) -> List[str]:
        me = self._local_id()
        return [nid for nid, n in
                sorted(self.node.cluster_state.nodes.items())
                if nid != me and ":" in n.transport_address]

    def _on_refresh(self, payload: dict) -> dict:
        self.node.indices[payload["index"]].refresh()
        return {"ok": True}

    # -- distributed snapshot / restore --------------------------------------

    def create_snapshot(self, location: str, snap_name: str,
                        indices: Optional[List[str]] = None,
                        include_global_state: bool = True,
                        repo_name: str = "_snapshot") -> dict:
        """Snapshot distributed indices into a SHARED filesystem repository:
        the master assembles the manifest, each shard's primary owner
        writes that shard's blobs itself (reference:
        snapshots/SnapshotsService.java — master drives the snapshot
        cluster-state machine; SnapshotShardsService on each data node
        writes its own shard files to the repository)."""
        payload = {"location": location, "snapshot": snap_name,
                   "indices": indices, "repo_name": repo_name,
                   "include_global_state": include_global_state}
        if not self.cluster.is_master:
            return self.cluster.transport.send_remote(
                self.cluster.master_addr, ACTION_SNAPSHOT, payload,
                timeout=300.0)
        return self._on_snapshot(payload)

    def _on_snapshot(self, payload: dict) -> dict:
        """Master: assemble the manifest via the shared create_snapshot,
        with a shard writer that fans each distributed index's shards out
        to their primary owners (one batched RPC per owner). A failed
        owner RPC records its shards failed and the snapshot PARTIAL —
        same accounting local shard failures already get."""
        from elasticsearch_tpu_torch.index.snapshots import (FsRepository,
                                                       _local_shards_meta,
                                                       create_snapshot,
                                                       snapshot_shard)

        repo = FsRepository(payload.get("repo_name") or "_snapshot",
                            payload["location"])

        def shards_fn(iname: str, svc) -> dict:
            meta = self.cluster.dist_indices.get(iname)
            if meta is None:  # a master-local (non-distributed) index
                return _local_shards_meta(repo, svc)
            try:
                self.refresh(iname)  # refresh-consistent view everywhere
            except Exception:
                # a dead peer must degrade to PARTIAL below, not abort the
                # whole snapshot; local copies refreshed before the raise
                pass
            shards_meta: List[Optional[dict]] = [None] * meta["num_shards"]
            failed = 0
            by_owner: Dict[str, List[int]] = {}
            for sid in range(meta["num_shards"]):
                try:
                    owner = self.owner_of(iname, sid)
                except Exception:
                    # no active copies (mid-recovery / lost shard): a
                    # failed snapshot shard, same as a dead owner's
                    failed += 1
                    shards_meta[sid] = {"blobs": [], "versions": {},
                                        "failed": True}
                    continue
                by_owner.setdefault(owner, []).append(sid)
            for owner, sids in sorted(by_owner.items()):
                try:
                    if owner == self._local_id():
                        got = [snapshot_shard(repo, svc.shards[sid])
                               for sid in sids]
                    else:
                        got = self._send(
                            owner, ACTION_SNAPSHOT_SHARD,
                            {"location": payload["location"],
                             "repo_name": repo.name,
                             "index": iname, "shards": sids}, timeout=300.0)
                    for sid, m in zip(sids, got):
                        shards_meta[sid] = m
                except Exception:
                    failed += len(sids)
                    for sid in sids:
                        shards_meta[sid] = {"blobs": [], "versions": {},
                                            "failed": True}
            # the manifest must round-trip the CROSS-HOST replica count:
            # _on_create pops number_of_replicas out of the local settings,
            # so svc.settings alone would restore with zero redundancy
            settings = dict(svc.settings)
            if meta.get("replicas"):
                settings["number_of_replicas"] = meta["replicas"]
            return {"shards": shards_meta, "failed": failed,
                    "settings": settings}

        indices = payload.get("indices")
        if indices is None:
            indices = sorted(set(self.node.indices)
                             | set(self.cluster.dist_indices))
        return create_snapshot(
            self.node, repo, payload["snapshot"], indices=indices,
            include_global_state=payload.get("include_global_state", True),
            shards_fn=shards_fn)

    def _on_snapshot_shard(self, payload: dict) -> List[dict]:
        """Shard owner: write the requested shards' blobs into the shared
        repo; one batched call per owner process."""
        from elasticsearch_tpu_torch.index.snapshots import (FsRepository,
                                                       snapshot_shard)

        repo = FsRepository(payload.get("repo_name") or "_snapshot",
                            payload["location"])
        svc = self.node.indices[payload["index"]]
        # self-contained freshness: the coordinator's refresh fan-out may
        # have failed for this peer without aborting the snapshot
        svc.refresh()
        return [snapshot_shard(repo, svc.shards[sid])
                for sid in payload["shards"]]

    def restore_snapshot(self, location: str, snap_name: str,
                         indices: Optional[List[str]] = None,
                         rename_pattern: Optional[str] = None,
                         rename_replacement: Optional[str] = None,
                         partial: bool = False,
                         repo_name: str = "_snapshot") -> dict:
        """Restore a snapshot INTO the multi-host cluster: the master
        computes a fresh cross-host shard assignment for each restored
        index, then every assigned copy replays its shard's blobs from the
        shared repository (reference: snapshots/RestoreService.java:1-120 —
        the master creates restore routing with a SNAPSHOT recovery
        source; each data node recovers its shards from the repo)."""
        self.cluster.ensure_not_blocked("metadata_write")
        payload = {"location": location, "snapshot": snap_name,
                   "indices": indices, "rename_pattern": rename_pattern,
                   "rename_replacement": rename_replacement,
                   "partial": partial, "repo_name": repo_name}
        if not self.cluster.is_master:
            return self.cluster.transport.send_remote(
                self.cluster.master_addr, ACTION_RESTORE, payload,
                timeout=300.0)
        return self._on_restore(payload)

    def _on_restore(self, payload: dict) -> dict:
        from elasticsearch_tpu_torch.index.snapshots import FsRepository, \
            select_restore_targets

        # restore only READS the repository — never mkdir its location
        # (a url repo's location is not a local path at all)
        repo = FsRepository(payload.get("repo_name") or "_snapshot",
                            payload["location"], create=False)
        snap = payload["snapshot"]
        manifest = repo.get_manifest(snap)
        indices = payload.get("indices")
        # validate EVERY target before touching any index — a collision on
        # index B must not leave index A half-restored (shared with the
        # single-node path; the extra `exists` covers dist_indices)
        selected = select_restore_targets(
            self.node, manifest, indices, payload.get("rename_pattern"),
            payload.get("rename_replacement"),
            bool(payload.get("partial")),
            exists=lambda t: t in self.cluster.dist_indices)
        restored: List[str] = []
        total = failed = 0
        for iname, target, imeta in selected:
            num_shards = len(imeta["shards"])
            total += num_shards
            settings = dict(imeta.get("settings") or {})
            settings["number_of_shards"] = num_shards
            body = {"settings": settings, "mappings": imeta["mappings"]}
            # copies start INITIALIZING (not searchable/writable) and
            # graduate per-owner as their replays succeed — a client must
            # never see a half-replayed shard as active, and a concurrent
            # write racing the replay's external-version replay is
            # impossible because no primary exists yet
            res = self._on_create({"name": target, "body": body,
                                   "pending": True})
            desired = res["assignment"]
            aliases = imeta.get("aliases", {})
            if aliases:
                # aliases ride the published metadata so EVERY process
                # (owners and pure coordinators) can resolve them; the
                # master applies its local copy here, peers in
                # _adopt_indices on the next publish
                with self.cluster._indices_lock:
                    self.cluster.dist_indices[target]["aliases"] = aliases
                self.node.indices[target].aliases.update(aliases)
            by_owner: Dict[str, List[int]] = {}
            for sid in range(num_shards):
                for owner in desired[str(sid)]:
                    by_owner.setdefault(owner, []).append(sid)
            ok: Dict[int, set] = {sid: set() for sid in range(num_shards)}
            for owner, sids in sorted(by_owner.items()):
                sp = {"location": payload["location"],
                      "repo_name": repo.name, "snapshot": snap,
                      "src": iname, "target": target, "shards": sids,
                      "aliases": aliases, "body": res["local_body"]}
                try:
                    if owner == self._local_id():
                        self._on_restore_shards(sp)
                    else:
                        self._send(owner, ACTION_RESTORE_SHARDS, sp,
                                   timeout=300.0)
                    for sid in sids:
                        ok[sid].add(owner)
                except Exception:
                    pass  # copy stays out of the active assignment
            with self.cluster._indices_lock:
                meta = self.cluster.dist_indices[target]
                init = meta.setdefault("initializing", {})
                for sid in range(num_shards):
                    live = [o for o in desired[str(sid)] if o in ok[sid]]
                    meta["assignment"][str(sid)] = live
                    init[str(sid)] = []
                    if not live or imeta["shards"][sid].get("failed"):
                        # every copy's replay failed, or the shard's blobs
                        # were missing from a PARTIAL manifest (it came
                        # back active but EMPTY): a failed restore shard,
                        # same accounting as the single-node path
                        failed += 1
            try:
                self.cluster.publish_indices()
            except Exception:
                # the restore target never committed (publish lost
                # quorum — the master stepped down): back the working
                # metadata out like create does, so a stepped-down node
                # holds no restored index the majority never saw, and
                # fail the restore typed (already-published targets in
                # `restored` stay — they committed)
                with self.cluster._indices_lock:
                    self.cluster.dist_indices.pop(target, None)
                    self.cluster._persist_dist_meta()
                raise
            restored.append(target)
        from elasticsearch_tpu_torch.index.snapshots import apply_global_state

        apply_global_state(self.node, manifest, indices)
        global_failed: List[str] = []
        if "global_state" in manifest and not indices:
            # templates are node-local state the publish doesn't carry:
            # fan the restored global state to every peer so a template
            # lookup works on whichever coordinator the client hits. A
            # failed peer is REPORTED (a transiently-unreachable peer
            # would otherwise silently miss the templates forever)
            gp = {"global_state": manifest["global_state"]}
            for nid in self._other_nodes():
                try:
                    self._send(nid, ACTION_APPLY_GLOBAL, gp)
                except Exception:
                    global_failed.append(nid)
        resp = {"snapshot": {"snapshot": snap, "indices": restored,
                             "shards": {"total": total, "failed": failed,
                                        "successful": total - failed}}}
        if global_failed:
            resp["snapshot"]["global_state_failed_nodes"] = global_failed
        return resp

    def _on_apply_global(self, payload: dict) -> dict:
        from elasticsearch_tpu_torch.index.snapshots import apply_global_state

        apply_global_state(self.node, payload, None)
        return {"ok": True}

    def _on_restore_shards(self, payload: dict) -> dict:
        """Restore target: replay the assigned shards' blobs from the
        shared repository into the local index copy. The index may not
        exist locally yet when this races the metadata publish."""
        from elasticsearch_tpu_torch.index.snapshots import (FsRepository,
                                                       replay_shard)

        index = payload["target"]
        with self.cluster._indices_lock:
            if not self.node.index_exists(index):
                self.node.create_index(index, payload.get("body"))
        svc = self.node.indices[index]
        # read-side handle: restore never writes, so never mkdir
        repo = FsRepository(payload.get("repo_name") or "_snapshot",
                            payload["location"], create=False)
        imeta = repo.get_manifest(payload["snapshot"])["indices"][
            payload["src"]]
        for sid in payload["shards"]:
            replay_shard(svc, repo, imeta, sid)
        svc.aliases.update(payload.get("aliases") or {})
        svc.refresh()
        return {"ok": True, "shards": payload["shards"]}

    # -- routed writes / reads ----------------------------------------------

    def index_doc(self, index: str, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, **kw) -> dict:
        # NO_MASTER write block: a headless (minority / stepped-down)
        # node must fail writes typed 503, never route them into a state
        # the quorum's master will not have (searches stay unblocked)
        self.cluster.ensure_not_blocked("write")
        index = self.resolve_index(index)
        meta = self._meta(index)
        if doc_id is None:
            doc_id = uuid.uuid4().hex  # route on the final id, as the owner will
        sid = shard_id_for(doc_id, meta["num_shards"], routing)
        owner = self.owner_of(index, sid)
        if owner == self._local_id():
            return self._primary_write("index", index, sid, doc_id, source,
                                       routing, kw)
        return self._send(owner, ACTION_INDEX,
                          {"index": index, "id": doc_id, "source": source,
                           "routing": routing, "kw": kw})

    def _write_lock(self, index: str, sid: int) -> threading.Lock:
        with self._lock:
            return self._write_locks.setdefault((index, sid),
                                                threading.Lock())

    def _ensure_primary(self, op: str, index: str, sid: int,
                        payload: dict, forwarded: bool) -> Optional[dict]:
        """A write landed here but THIS node's published metadata names a
        different primary: the sender routed on stale state (or this node
        was just demoted). Applying locally would ack under the new term
        without the real primary ever seeing the op — acked-op loss — so
        forward ONE hop to the owner this node believes in (reference:
        TransportReplicationAction rerouting on stale routing). A write
        that was already forwarded and still finds no agreement fails
        typed instead of ping-ponging."""
        meta = self._meta(index)
        owners = meta["assignment"].get(str(sid), [])
        if not owners or owners[0] == self._local_id():
            return None  # we are the primary (or the shard is lost —
            # owner_of raises on the read side; writes fail below anyway)
        if forwarded:
            raise StalePrimaryException(index, sid,
                                        self._shard_term(meta, sid),
                                        self._shard_term(meta, sid))
        fwd = dict(payload)
        fwd["forwarded"] = True
        action = {"index": ACTION_INDEX, "delete": ACTION_DELETE,
                  "update": ACTION_UPDATE}[op]
        return self._send(owners[0], action, fwd)

    def _primary_write(self, op: str, index: str, sid: int, doc_id: str,
                       source: Optional[dict], routing: Optional[str],
                       kw: dict, forwarded: bool = False) -> dict:
        """Apply on the primary, then fan out to every cross-host copy —
        committed replicas AND initializing (recovering) ones — with the
        primary-assigned version (external_gte keeps replica replay
        idempotent and ordered — the reference's
        TransportShardReplicationOperationAction primary → replicas hop).
        The per-shard lock makes apply+fanout atomic so two client
        threads' fanouts cannot reach a replica out of version order."""
        # also fences writes FORWARDED to a headless node on stale routing
        self.cluster.ensure_not_blocked("write")
        rerouted = self._ensure_primary(
            op, index, sid,
            {"index": index, "id": doc_id, "source": source,
             "routing": routing, "kw": kw}, forwarded)
        if rerouted is not None:
            return rerouted
        svc = self.node.indices[index]
        with self._write_lock(index, sid):
            meta = self._meta(index)
            # stamp the op with THIS node's published view of the shard's
            # primary term; if a newer term already reached the local
            # engine (a recovery stream from the real primary), the
            # engine-level fence rejects right here — before any fanout
            term = self._shard_term(meta, sid)
            kw = dict(kw)
            kw["primary_term"] = term
            if op == "index":
                res = svc.index_doc(doc_id, source, routing=routing, **kw)
            else:
                res = svc.delete_doc(doc_id, routing=routing, **kw)
            tracker = self._checkpoint_tracker(index, sid, meta)
            tracker.update_local(
                self._local_id(),
                svc.shards[sid].engine.local_checkpoint)
            rep_kw = dict(kw)
            rep_kw.update(version=res["_version"],
                          version_type="external_gte",
                          seq_no=res.get("_seq_no"), primary_term=term)
            action = ACTION_INDEX if op == "index" else ACTION_DELETE
            copies = (meta["assignment"][str(sid)][1:]
                      + meta.get("initializing", {}).get(str(sid), []))
            for rep in copies:
                if rep == self._local_id():
                    continue
                try:
                    FAULTS.check("replication.fanout", index=index,
                                 shard=sid, target=rep, op=op)
                    r = self._send(rep, action,
                                   {"index": index, "id": doc_id,
                                    "source": source, "routing": routing,
                                    "kw": rep_kw, "replica": True})
                    if isinstance(r, dict) and "local_checkpoint" in r:
                        tracker.update_local(rep, r["local_checkpoint"])
                except RemoteException as e:
                    if e.error_type == "stale_primary_exception":
                        # the REPLICA is fine — THIS primary was demoted
                        # and doesn't know it: never ack the write, never
                        # demote the copy that fenced us (the zombie-
                        # primary window closes here). The typed 409
                        # relays as-is.
                        raise
                    self._report_copy_failed(index, sid, rep)
                except Exception:
                    # a copy that missed an acknowledged write must stop
                    # being promotable — report it failed so the master
                    # demotes it and re-syncs via the recovery stream
                    # (reference: ShardStateAction.shardFailed on a failed
                    # replication hop)
                    self._report_copy_failed(index, sid, rep)
        res["_global_checkpoint"] = tracker.global_checkpoint
        return res

    def _report_copy_failed(self, index: str, sid: int,
                            node_id: str) -> None:
        payload = {"index": index, "shard": sid, "node": node_id}
        try:
            if self.cluster.is_master:
                self._on_shard_failed(payload)
            else:
                self.cluster.transport.send_remote(
                    self.cluster.master_addr, ACTION_SHARD_FAILED,
                    payload, timeout=5.0)
        except Exception:
            pass  # master unreachable: fault detection is already dying

    def _on_shard_failed(self, payload: dict) -> dict:
        """Master: drop a failed REPLICA copy from the promotable set and
        schedule a re-sync (primary failure is fault detection's job)."""
        if not self.cluster.is_master:
            raise TransportError("shard_failed must go to the master")
        index, sid = payload["index"], payload["shard"]
        node_id = payload["node"]
        directive = None
        with self.cluster._indices_lock:
            meta = self.cluster.dist_indices.get(index)
            if meta is None:
                return {"ok": False}
            owners = meta["assignment"].get(str(sid), [])
            if node_id not in owners or owners[0] == node_id:
                return {"ok": False}
            owners.remove(node_id)
            # the copy missed an acknowledged write: it leaves the
            # in-sync set until its re-sync stream completes
            insync = self._shard_in_sync(meta, sid)
            if node_id in insync:
                insync.remove(node_id)
            if owners and node_id in self.node.cluster_state.nodes:
                # back through INITIALIZING so live writes keep fanning
                # out to it while the re-sync stream runs
                pend = meta.setdefault("initializing", {}) \
                    .setdefault(str(sid), [])
                if node_id not in pend:
                    pend.append(node_id)
                directive = {"index": index, "shard": sid,
                             "target": node_id, "source": owners[0],
                             "body": meta["body"]}
        try:
            self.cluster.publish_indices()
        except FailedToCommitClusterStateException:
            # the master just lost publish quorum and stepped down; the
            # in-sync shrink is conservative (it only REMOVES a failed
            # copy) and the quorum's master redoes allocation — the
            # REPORTER must not receive a publish error for a failure
            # report it delivered successfully
            return {"ok": False}
        if directive:
            self.start_recoveries([directive])
        return {"ok": True}

    def _on_index(self, payload: dict) -> dict:
        index, doc_id = payload["index"], payload["id"]
        routing = payload.get("routing")
        if payload.get("replica"):
            kw = payload.get("kw") or {}
            sid = shard_id_for(doc_id, self._meta(index)["num_shards"],
                               routing)
            self._fence_replica_op(index, sid, kw.get("primary_term"))
            res = self.node.indices[index].index_doc(
                doc_id, payload["source"], routing=routing, **kw)
            # the ack reports this copy's local checkpoint so the primary
            # can advance the shard's global checkpoint
            res["local_checkpoint"] = self.node.indices[index] \
                .shards[sid].engine.local_checkpoint
            return res
        sid = shard_id_for(doc_id, self._meta(index)["num_shards"], routing)
        return self._primary_write("index", index, sid, doc_id,
                                   payload["source"], routing,
                                   payload.get("kw") or {},
                                   forwarded=bool(payload.get("forwarded")))

    def delete_doc(self, index: str, doc_id: str,
                   routing: Optional[str] = None, **kw) -> dict:
        self.cluster.ensure_not_blocked("write")
        index = self.resolve_index(index)
        meta = self._meta(index)
        sid = shard_id_for(doc_id, meta["num_shards"], routing)
        owner = self.owner_of(index, sid)
        if owner == self._local_id():
            return self._primary_write("delete", index, sid, doc_id, None,
                                       routing, kw)
        return self._send(owner, ACTION_DELETE,
                          {"index": index, "id": doc_id, "routing": routing,
                           "kw": kw})

    def update_doc(self, index: str, doc_id: str, body: dict,
                   routing: Optional[str] = None, **kw) -> dict:
        """Routed partial update: executes ON the primary owner (the merge
        must read the current source there), which then fans the resulting
        full doc out through the normal replica hop (reference:
        TransportUpdateAction resolving to an index op on the primary)."""
        self.cluster.ensure_not_blocked("write")
        index = self.resolve_index(index)
        meta = self._meta(index)
        sid = shard_id_for(doc_id, meta["num_shards"], routing)
        owner = self.owner_of(index, sid)
        if owner == self._local_id():
            return self._primary_update(index, sid, doc_id, body, routing,
                                        kw)
        return self._send(owner, ACTION_UPDATE,
                          {"index": index, "id": doc_id, "body": body,
                           "routing": routing, "kw": kw})

    def _primary_update(self, index: str, sid: int, doc_id: str,
                        body: dict, routing: Optional[str],
                        kw: dict, forwarded: bool = False) -> dict:
        self.cluster.ensure_not_blocked("write")
        rerouted = self._ensure_primary(
            "update", index, sid,
            {"index": index, "id": doc_id, "body": body,
             "routing": routing, "kw": kw}, forwarded)
        if rerouted is not None:
            return rerouted
        svc = self.node.indices[index]
        with self._write_lock(index, sid):
            meta = self._meta(index)
            term = self._shard_term(meta, sid)
            # the published term rides into the engine like any primary
            # write: a demoted node whose engine already adopted a newer
            # term (via a recovery stream) fences HERE instead of acking
            # an update its replacement never sees
            kw = dict(kw)
            kw["primary_term"] = term
            res = svc.update_doc(doc_id, body, routing=routing, **kw)
            got = svc.get_doc(doc_id, routing=routing)
            copies = (meta["assignment"][str(sid)][1:]
                      + meta.get("initializing", {}).get(str(sid), []))
            if got.get("found"):
                # the merged doc's engine-assigned (seq_no, term) identity
                # rides the fanout like any primary write
                loc = svc.shards[sid].engine._locations.get(str(doc_id))
                rep_kw = {"version": res["_version"],
                          "version_type": "external_gte",
                          "seq_no": loc.seq_no if loc else None,
                          "primary_term": loc.term if loc else term}
                for rep in copies:
                    if rep == self._local_id():
                        continue
                    try:
                        FAULTS.check("replication.fanout", index=index,
                                     shard=sid, target=rep, op="update")
                        self._send(rep, ACTION_INDEX,
                                   {"index": index, "id": doc_id,
                                    "source": got["_source"],
                                    "routing": routing, "kw": rep_kw,
                                    "replica": True})
                    except RemoteException as e:
                        if e.error_type == "stale_primary_exception":
                            raise  # demoted primary: never ack
                        self._report_copy_failed(index, sid, rep)
                    except Exception:
                        self._report_copy_failed(index, sid, rep)
        return res

    def _on_update(self, payload: dict) -> dict:
        index, doc_id = payload["index"], payload["id"]
        routing = payload.get("routing")
        sid = shard_id_for(doc_id, self._meta(index)["num_shards"], routing)
        return self._primary_update(index, sid, doc_id, payload["body"],
                                    routing, payload.get("kw") or {},
                                    forwarded=bool(payload.get("forwarded")))

    def _on_delete(self, payload: dict) -> dict:
        index, doc_id = payload["index"], payload["id"]
        routing = payload.get("routing")
        if payload.get("replica"):
            from elasticsearch_tpu_torch.utils.errors import \
                DocumentMissingException

            kw = payload.get("kw") or {}
            sid = shard_id_for(doc_id, self._meta(index)["num_shards"],
                               routing)
            self._fence_replica_op(index, sid, kw.get("primary_term"))
            eng = self.node.indices[index].shards[sid].engine
            try:
                res = self.node.indices[index].delete_doc(
                    doc_id, routing=routing, **kw)
            except DocumentMissingException:
                # a delete for a doc this copy never saw (e.g. it raced the
                # recovery snapshot): per-shard fanout ordering plus the
                # tombstones shipped by _on_shard_sync make skipping safe —
                # but the op's seq no is still processed (no-op), or this
                # copy's checkpoint stalls on the hole
                eng.note_noop(kw.get("seq_no"), kw.get("primary_term"))
                return {"found": False, "_id": doc_id,
                        "local_checkpoint": eng.local_checkpoint}
            res["local_checkpoint"] = eng.local_checkpoint
            return res
        sid = shard_id_for(doc_id, self._meta(index)["num_shards"], routing)
        return self._primary_write("delete", index, sid, doc_id, None,
                                   routing, payload.get("kw") or {},
                                   forwarded=bool(payload.get("forwarded")))

    def by_query(self, index: str, body: Optional[dict], op: str,
                 script=None, params=None) -> dict:
        """Distributed delete/update-by-query: fan one scan+apply pass to
        each PRIMARY owner for its shards, merge counts. Reference:
        AbstractAsyncBulkByScrollAction (scroll-driven scan + bulk), here
        scoped per owner so every apply runs on the doc's primary and
        fans to replicas through the ordinary write hop.

        Runs as a CANCELLABLE task: each remote owner's pass registers a
        child task (the wire header carries the parent id), so ``POST
        /_tasks/{this}/_cancel`` reaches the remote scans too; a
        cancellation mid-fanout returns the PARTIAL counts applied so
        far with a ``"canceled"`` reason, the reference's
        BulkByScrollResponse shape."""
        self.cluster.ensure_not_blocked("write")
        index = self.resolve_index(index)
        meta = self._meta(index)
        self.refresh(index)
        by_owner: Dict[str, List[int]] = {}
        out: Dict[str, Any] = {"took": 0, "total": 0, "failures": [],
                               "timed_out": False}
        for sid in range(meta["num_shards"]):
            owners = meta["assignment"][str(sid)]
            if owners:
                by_owner.setdefault(owners[0], []).append(sid)
            else:
                # a shard with no active copies (mid-reheal) must SURFACE
                # as a failure, not silently under-delete — single-doc
                # writes in the same state raise 'no active copies'
                out["failures"].append({
                    "index": index, "shard": sid,
                    "status": 503,
                    "cause": {"type": "unavailable_shards_exception",
                              "reason": f"[{index}][{sid}] has no active "
                                        f"copies"}})
        deleted = updated = noops = 0
        action = by_query_task_action(op)
        t0 = time.perf_counter()
        with self.node.tasks.task(action,
                                  description=f"{op}-by-query [{index}]") \
                as task:
            try:
                for owner, sids in sorted(by_owner.items()):
                    # cooperative checkpoint BETWEEN owners: a cancel
                    # must stop the fanout before the next destructive
                    # pass starts (the in-flight owner stops itself at
                    # its own checkpoints)
                    task.check_cancelled()
                    payload = {"index": index,
                               "query": (body or {}).get("query"),
                               "op": op, "shards": sids, "script": script,
                               "params": params}
                    try:
                        if owner == self._local_id():
                            res = self._on_by_query(payload)
                        else:
                            res = self._send(owner, ACTION_BY_QUERY,
                                             payload, timeout=300.0)
                    except Exception as e:
                        # a dead owner after earlier owners already applied
                        # destructive writes: report ITS shards failed — the
                        # caller must see partial success, not a bare 500
                        out["failures"].extend({
                            "index": index, "shard": sid, "node": owner,
                            "status": 503,
                            "cause": {"type": "node_unavailable",
                                      "reason": str(e)}} for sid in sids)
                        continue
                    deleted += res.get("deleted", 0)
                    updated += res.get("updated", 0)
                    noops += res.get("noops", 0)
                    out["total"] += res.get("total", 0)
                    out["failures"].extend(res.get("failures", []))
                    if res.get("canceled"):
                        # an owner's pass was cancelled — cascade cancel
                        # reached it first, or an operator cancelled the
                        # CHILD directly. Either way the operation is
                        # over: stop the fanout NOW (remaining owners
                        # must not run their destructive passes under a
                        # response that claims cancellation) and report
                        # whatever was applied
                        out["canceled"] = res["canceled"]
                        task.cancel(res["canceled"])
                        break
            except TaskCancelledException as e:
                out["canceled"] = str(e)
        try:
            self.refresh(index)
        except Exception:
            pass  # a dead peer is already in failures; keep the response
        if op == "delete":
            out["deleted"] = deleted
        else:
            out["updated"] = updated
            out["noops"] = noops
        out["took"] = int((time.perf_counter() - t0) * 1000)
        return out

    def _on_by_query(self, payload: dict) -> dict:
        """Owner-side by-query pass, restricted to the PRIMARY shards this
        process owns (the local index also holds replica copies of remote
        primaries — touching those here would race their owners). The
        scan loop is SHARED with the single-node REST actions
        (search/byquery.py); every apply goes through
        _primary_write/_primary_update so replicas stay in version
        order.

        Registers a CHILD task (parent = the coordinator's task, carried
        by the transport wire header): cancelling the coordinator
        cascades here, and the scan loop's cooperative checkpoints
        (search/byquery.py) stop the pass between docs — the partial
        counts applied so far return with ``"canceled"``."""
        from elasticsearch_tpu_torch.search.byquery import (failure_entry,
                                                      run_by_query)
        from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

        index, op = payload["index"], payload["op"]
        sids = set(payload["shards"])
        script = payload.get("script")
        s_params = payload.get("params")
        svc = self.node.indices[index]
        num_shards = self._meta(index)["num_shards"]
        svc.refresh()
        counted: set = set()
        counts = {"deleted": 0, "updated": 0, "noops": 0}
        failures: List[dict] = []

        def apply(doc_id, loc):
            routing = loc.routing if loc else None
            sid = shard_id_for(doc_id, num_shards, routing)
            if sid not in sids:
                return  # a replica copy: its primary handles it
            counted.add(doc_id)
            try:
                if op == "delete":
                    self._primary_write("delete", index, sid, doc_id,
                                        None, routing, {})
                    counts["deleted"] += 1
                elif script is not None:
                    self._primary_update(index, sid, doc_id,
                                         {"script": script,
                                          "params": s_params},
                                         routing, {})
                    counts["updated"] += 1
                else:
                    got = svc.get_doc(doc_id, routing=routing)
                    if got.get("found"):
                        kw: Dict[str, Any] = {}
                        if loc is not None and loc.doc_type:
                            kw["doc_type"] = loc.doc_type
                        if loc is not None and loc.parent:
                            kw["parent"] = loc.parent
                        self._primary_write("index", index, sid, doc_id,
                                            got["_source"], routing, kw)
                        counts["updated"] += 1
                    else:
                        counts["noops"] += 1
            except ElasticsearchTpuException as e:
                failures.append(failure_entry(index, doc_id, e))

        canceled: Optional[str] = None
        with self.node.tasks.task(
                by_query_task_action(payload["op"]) + "[s]",
                description=f"{payload['op']}-by-query [{index}] "
                            f"shards {sorted(sids)}"):
            try:
                run_by_query(svc, payload.get("query"), apply)
            except TaskCancelledException as e:
                canceled = str(e)
        out: Dict[str, Any] = {"total": len(counted), "failures": failures}
        if op == "delete":
            out["deleted"] = counts["deleted"]
        else:
            out["updated"] = counts["updated"]
            out["noops"] = counts["noops"]
        if canceled is not None:
            out["canceled"] = canceled
        return out

    def cancel_task_children(self, parent_node: str, parent_id: int,
                             reason: str = "by user request") -> dict:
        """Fan a parent-task cancellation to every OTHER member so their
        child tasks (registered under the wire-propagated parent id)
        cancel too — the cross-node half of ``POST /_tasks/{id}/_cancel``
        (reference: TransportCancelTasksAction's ban propagation).
        Returns per-node cancelled task listings; a dead peer is
        REPORTED in ``node_failures``, never silently skipped (its tasks
        die with it anyway)."""
        payload = {"parent_node": parent_node, "parent_id": int(parent_id),
                   "reason": reason}
        nodes: Dict[str, Any] = {}
        failures: List[dict] = []
        for nid in self._other_nodes():
            try:
                res = self._send(nid, ACTION_CANCEL_TASKS, payload,
                                 timeout=5.0)
                if res.get("tasks"):
                    nodes[nid] = {"tasks": res["tasks"]}
            except Exception as e:
                failures.append({"node_id": nid, "reason": str(e)})
        out: Dict[str, Any] = {"nodes": nodes}
        if failures:
            out["node_failures"] = failures
        return out

    def _on_cancel_tasks(self, payload: dict) -> dict:
        """Cancel every local task descending from the named parent."""
        cancelled = self.node.tasks.cancel_by_parent(
            payload.get("parent_node") or "", int(payload["parent_id"]),
            payload.get("reason") or "by user request")
        return {"tasks": {t.tagged_id: t.to_json() for t in cancelled}}

    def proxy_doc_rest(self, index: str, doc_id: str,
                       routing: Optional[str], method: str, path: str,
                       params: dict, body: Optional[bytes]):
        """Route a doc-level REST op (explain / termvectors) to the doc's
        primary owner and relay its (status, body); None when the owner
        is THIS process — the caller then runs its own handler against
        the local shards, which hold the doc. Reference: the per-node
        transport handlers behind RestExplainAction /
        RestTermVectorsAction (each executes on the shard's node)."""
        index = self.resolve_index(index)
        meta = self._meta(index)
        sid = shard_id_for(doc_id, meta["num_shards"], routing)
        owner = self.owner_of(index, sid)
        if owner == self._local_id():
            return None
        res = self._send(owner, ACTION_REST_PROXY, {
            "method": method, "path": path, "params": dict(params or {}),
            "body": (body or b"").decode("utf-8", "replace")})
        return res["status"], res["payload"]

    def suggest_fan(self, index: str,
                    suggest_body: dict) -> Tuple[dict, dict]:
        """Suggest on a distributed index: one request per PRIMARY owner,
        each restricted (via the `_shards` param) to its primary shards
        so replica copies never double-count frequencies; merged per
        entry (search/suggest.py::merge_suggest). Returns
        (merged, _shards accounting) — a failed owner counts ITS shard
        count failed, and an unassigned shard is failed too. When
        embedded in a search, a dead peer already shows in the QUERY
        phase's _shards (suggest rides the same per-shard phase in the
        reference), so the search path reports the merged result
        without double-accounting."""
        import json as _json

        from urllib.parse import quote

        from elasticsearch_tpu_torch.search.suggest import merge_suggest

        index = self.resolve_index(index)
        meta = self._meta(index)
        by_owner: Dict[str, List[int]] = {}
        failed_shards = 0
        for sid in range(meta["num_shards"]):
            owners = meta["assignment"][str(sid)]
            if owners:
                by_owner.setdefault(owners[0], []).append(sid)
            else:
                failed_shards += 1
        payloads = []
        raw = _json.dumps(suggest_body).encode()
        for owner, sids in sorted(by_owner.items()):
            req = {"method": "POST",
                   "path": f"/{quote(index, safe='')}/_suggest",
                   "params": {"_shards": ",".join(map(str, sids))},
                   "body": raw.decode("utf-8", "replace")}
            try:
                if owner == self._local_id():
                    res = self._on_rest_proxy(req)
                else:
                    res = self._send(owner, ACTION_REST_PROXY, req)
            except Exception:
                failed_shards += len(sids)
                continue
            if res["status"] == 200:
                payloads.append(res["payload"])
            else:
                failed_shards += len(sids)
        total = meta["num_shards"]
        return merge_suggest(suggest_body, payloads), {
            "total": total, "successful": total - failed_shards,
            "failed": failed_shards}

    def nodes_fan(self) -> dict:
        """Cluster-wide /_nodes: this node's entry plus every live
        member's, each sourced from the member itself over the REST proxy
        (reference: TransportNodesInfoAction fans to all nodes and merges
        per-node responses). A dead peer simply drops out of the map."""
        out = self.node.nodes_stats()
        for nid in self._other_nodes():
            try:
                res = self._send(nid, ACTION_REST_PROXY, {
                    "method": "GET", "path": "/_nodes", "params": {}})
                if res.get("status") == 200:
                    out["nodes"].update(
                        (res.get("payload") or {}).get("nodes", {}))
            except Exception:
                pass
        return out

    def _on_rest_proxy(self, payload: dict) -> dict:
        """Dispatch a proxied REST request into this process's own route
        table (lazily built — a pure data node may never serve HTTP)."""
        ctrl = self._proxy_controller
        if ctrl is None:
            from elasticsearch_tpu_torch.rest.server import RestController

            ctrl = self._proxy_controller = RestController(self.node)
        params = dict(payload.get("params") or {})
        # pin to THIS node: the dispatched handler must serve from local
        # shards, never re-forward (divergent ownership views would
        # ping-pong the request unboundedly)
        params["_local_only"] = "1"
        status, body = ctrl.dispatch(
            payload["method"], payload["path"], params,
            (payload.get("body") or "").encode())
        return {"status": status, "payload": body}

    def get_doc(self, index: str, doc_id: str,
                routing: Optional[str] = None, realtime: bool = True,
                with_meta: bool = False) -> dict:
        index = self.resolve_index(index)
        meta = self._meta(index)
        owner = self.owner_of(
            index, shard_id_for(doc_id, meta["num_shards"], routing))
        if owner == self._local_id():
            return self.node.indices[index].get_doc(
                doc_id, routing=routing, realtime=realtime,
                with_meta=with_meta)
        # realtime get is idempotent: transport flakes retry with backoff
        return self._send_idempotent(
            owner, ACTION_GET,
            {"index": index, "id": doc_id, "routing": routing,
             "realtime": realtime, "meta": with_meta}, timeout=10.0)

    def _on_get(self, payload: dict) -> dict:
        return self.node.indices[payload["index"]].get_doc(
            payload["id"], routing=payload.get("routing"),
            realtime=payload.get("realtime", True),
            with_meta=payload.get("meta", False))

    # -- allocation signals ---------------------------------------------------

    def local_alloc_usage(self) -> dict:
        """This node's placement signals for the allocator's usage probe
        (and the multihost `_cat/allocation` row): device bytes from the
        breaker hierarchy over the ``ESTPU_HBM_BYTES`` capacity, local copy count from the published
        metadata, and a serving-load score folding per-shard query totals
        with breaker-trip and eviction churn (the live ``estpu_*``
        families the LoadDecider steers by). The breakers and the
        residency registry are this node's own (the reference reads its
        process-wide ones: in a trio of members in one process each
        reports the process's total, ROADMAP C)."""
        used, capacity = self.node.breakers.hbm_usage()
        bstats = self.node.breakers.stats()
        tripped = sum(int(b.get("tripped", 0)) for b in bstats.values())
        rstats = self.node.residency.stats()
        evictions = sum(int(t.get("evictions", 0))
                        for t in rstats.get("tiers", {}).values())
        local = self._local_id()
        shards = 0
        with self.cluster._indices_lock:
            for meta in self.cluster.dist_indices.values():
                for sid in range(int(meta.get("num_shards", 0))):
                    owners = meta["assignment"].get(str(sid), [])
                    if local in owners:
                        shards += 1
        queries = 0
        for svc in list(self.node.indices.values()):
            for shard in getattr(svc, "shards", []):
                try:
                    queries += int(shard.searcher.stats.query_total)
                except Exception:  # a stats-less
                    pass           # shard must not fail the probe
        return {"hbm_used": used, "hbm_capacity": capacity,
                "shards": shards,
                "load": float(queries + 10 * tripped + evictions),
                "queries": queries, "breaker_trips": tripped,
                "evictions": evictions}

    def _on_shard_ckpt(self, payload: dict) -> dict:
        """This copy's local checkpoint — the recency signal the master's
        promotion pass ranks in-sync survivors by (the copy with the
        highest checkpoint replays the shortest suffix)."""
        svc = self.node.indices.get(payload["index"])
        if svc is None:
            return {"checkpoint": NO_OPS_PERFORMED}
        return {"checkpoint":
                svc.shards[payload["shard"]].engine.local_checkpoint}

    def _on_cluster_settings(self, payload: dict) -> dict:
        """Adopt a peer's ``PUT /_cluster/settings`` broadcast: persist
        the raw persistent/transient structure and re-apply the MERGED
        map to every live consumer (breakers, serving, allocator) — so a
        drain exclusion PUT to ANY node reaches the master's allocator."""
        self.node.cluster_settings = payload["cluster_settings"]
        merged = payload.get("merged") or {}
        self.node.breakers.apply_cluster_settings(merged)
        serving = getattr(self.node, "serving", None)
        if serving is not None:
            serving.apply_cluster_settings(merged)
        alloc = getattr(self.cluster, "allocator", None)
        if alloc is not None:
            alloc.apply_cluster_settings(merged)
        return {"acknowledged": True}

    # -- shard recovery / relocation -----------------------------------------

    def _promotion_checkpoints(self) -> Dict[Tuple[str, int],
                                             Dict[str, int]]:
        """Local checkpoints of the promotion candidates, for every shard
        whose primary died leaving MORE than one in-sync survivor —
        promotion should pick the copy with the highest checkpoint so the
        new primary replays the shortest suffix. Best-effort and outside
        the indices lock: an unreachable candidate just drops out of the
        map (select_primary falls back to owner order, which is never
        unsafe — every candidate is in-sync)."""
        alive = set(self.node.cluster_state.nodes)
        wanted: Dict[Tuple[str, int], List[str]] = {}
        with self.cluster._indices_lock:
            for name, meta in self.cluster.dist_indices.items():
                for sid in range(int(meta.get("num_shards", 0))):
                    owners = meta["assignment"].get(str(sid), [])
                    if not owners or owners[0] in alive:
                        continue  # no promotion pending for this shard
                    insync = set(self._shard_in_sync(meta, sid))
                    survivors = [o for o in owners
                                 if o in alive and o in insync]
                    if len(survivors) > 1:
                        wanted[(name, sid)] = survivors
        out: Dict[Tuple[str, int], Dict[str, int]] = {}
        for (name, sid), cands in wanted.items():
            m: Dict[str, int] = {}
            for nid in cands:
                try:
                    if nid == self._local_id():
                        m[nid] = self.node.indices[name].shards[sid] \
                            .engine.local_checkpoint
                    else:
                        m[nid] = int(self._send(
                            nid, ACTION_SHARD_CKPT,
                            {"index": name, "shard": sid},
                            timeout=2.0)["checkpoint"])
                except Exception:
                    continue
            if m:
                out[(name, sid)] = m
        return out

    def reconcile(self):
        """Master-side allocation pass after a membership change: drop dead
        nodes from every copy list (which promotes the next surviving
        COMMITTED copy to primary), then top shards back up to 1+replicas
        copies on alive nodes. A new copy starts in `initializing` — it
        receives live write fanout but is not promotable or searchable —
        and graduates into `assignment` only when its recovery stream
        succeeds (_run_recoveries), so a failed recovery can never leave a
        promotable empty copy. Returns (directives, changed).
        Reference: RoutingNodes promotion + INITIALIZING→STARTED shard
        states; recovery itself mirrors RecoverySourceHandler phase 1/2 as
        ops-based streaming (see index/recovery.py for why shipping live
        docs IS our segment copy)."""
        # checkpoint probe OUTSIDE the lock: it sends transport requests
        ckpts = self._promotion_checkpoints()
        with self.cluster._indices_lock:
            alive = set(self.node.cluster_state.nodes)
            order = sorted(alive)
            directives: List[dict] = []
            changed = False
            for name, meta in self.cluster.dist_indices.items():
                want = 1 + int(meta.get("replicas", 0))
                init = meta.setdefault("initializing", {})
                for sid in range(meta["num_shards"]):
                    old_primary = (meta["assignment"][str(sid)] or [None])[0]
                    owners = [o for o in meta["assignment"][str(sid)]
                              if o in alive]
                    if owners != meta["assignment"][str(sid)]:
                        changed = True
                    # promotion only ever selects an IN-SYNC copy: a copy
                    # that missed an acknowledged write (shard_failed) or
                    # is still recovering must never become primary — it
                    # would silently roll back acked ops (reference:
                    # allocation promotes from the in-sync allocation ids)
                    insync = self._shard_in_sync(meta, sid)
                    dropped = [o for o in insync if o not in alive]
                    if dropped:
                        changed = True
                        insync[:] = [o for o in insync if o in alive]
                    from elasticsearch_tpu_torch.cluster.routing import \
                        select_primary

                    reordered = select_primary(owners, insync,
                                               ckpts.get((name, sid)))
                    if reordered != owners:
                        owners = reordered
                        changed = True
                    meta["assignment"][str(sid)] = owners
                    if owners and owners[0] != old_primary:
                        # primary changed hands: BUMP THE TERM so any op
                        # still in flight from the demoted primary is
                        # fenced by every copy that adopts this publish
                        terms = meta.setdefault("primary_terms", {})
                        terms[str(sid)] = self._shard_term(meta, sid) + 1
                        changed = True
                    pend = [t for t in init.get(str(sid), []) if t in alive]
                    if pend != init.get(str(sid), []):
                        changed = True
                    init[str(sid)] = pend
                    if not owners:
                        continue  # lost shard: nothing to copy from
                    for k in range(len(order)):
                        if len(owners) + len(pend) >= want:
                            break
                        cand = order[(sid + k) % len(order)]
                        if cand in owners or cand in pend:
                            continue
                        pend.append(cand)
                        directives.append({
                            "index": name, "shard": sid, "target": cand,
                            "source": owners[0], "body": meta["body"]})
                        changed = True
            return directives, changed

    def _on_shard_docs(self, payload: dict) -> dict:
        svc = self.node.indices.get(payload["index"])
        if svc is None:
            return {"docs": -1}
        return {"docs": svc.shards[payload["shard"]].engine.num_docs}

    def resurrect_lost(self) -> None:
        """Gateway-style primary allocation from on-disk copies: a shard
        with NO active copies adopts the alive node holding the most
        local docs for it — a member that restarted with its data_path
        and rejoined under a new node id. Shards nobody holds data for
        stay unassigned (a visible failure, like the reference's lost
        primaries without an explicit force-allocate). Reference:
        gateway/GatewayAllocator primary allocation from shard stores."""
        with self.cluster._indices_lock:
            lost = [(name, sid)
                    for name, meta in self.cluster.dist_indices.items()
                    for sid in range(meta["num_shards"])
                    if not meta["assignment"].get(str(sid))]
        if not lost:
            return
        changed = False
        for name, sid in lost:
            best_docs, best_nid = 0, None
            for nid in sorted(self.node.cluster_state.nodes):
                try:
                    if nid == self._local_id():
                        docs = self.node.indices[name].shards[sid] \
                            .engine.num_docs
                    else:
                        docs = self._send(nid, ACTION_SHARD_DOCS,
                                          {"index": name, "shard": sid},
                                          timeout=5.0)["docs"]
                except Exception:
                    continue
                if docs > best_docs:
                    best_docs, best_nid = docs, nid
            if best_nid is None:
                continue
            with self.cluster._indices_lock:
                meta2 = self.cluster.dist_indices[name]
                owners = meta2["assignment"].get(str(sid))
                if owners == []:  # still lost (no race with a recovery)
                    owners.append(best_nid)
                    # gateway adoption is a primary change: new term, and
                    # the adopted copy is the in-sync set's sole member
                    meta2.setdefault("primary_terms", {})[str(sid)] = \
                        self._shard_term(meta2, sid) + 1
                    meta2.setdefault("in_sync", {})[str(sid)] = [best_nid]
                    changed = True
        if changed:
            try:
                self.cluster.publish_indices()
                # replicas top back up from the resurrected primaries
                directives, changed2 = self.reconcile()
                if changed2:
                    self.cluster.publish_indices()
            except FailedToCommitClusterStateException:
                # background thread on a master that just lost quorum:
                # it stepped down; the quorum's master redoes allocation
                return
            self.start_recoveries(directives)

    def start_recoveries(self, directives: List[dict]) -> None:
        """Run the recovery streams on a background thread: callers are
        transport handlers or the fault-detector loop, and a recovery can
        take as long as the shard is big. Each directive registers a
        PENDING task up front (visible in /_cluster/pending_tasks while
        queued behind earlier streams) that flips to running as its
        stream starts — cancelling it skips/aborts that stream."""
        if not directives:
            return
        tasks = [self.node.tasks.register(
            ACTION_RECOVER,
            description=f"recover [{d['index']}][{d['shard']}] "
                        f"{d['source']} -> {d['target']}",
            status="pending") for d in directives]
        threading.Thread(target=self._run_recoveries,
                         args=(directives, tasks),
                         name="tpu-recovery", daemon=True).start()

    def _run_recoveries(self, directives: List[dict],
                        tasks: Optional[list] = None) -> None:
        from elasticsearch_tpu_torch.tracing.tasks import (reset_current,
                                                     set_current)

        promoted = False
        for i, d in enumerate(directives):
            task = tasks[i] if tasks else None
            ok = False
            token = None
            # cancelled while queued: the stream never starts, but the
            # bookkeeping below MUST still run — skipping it would leave
            # the target in `initializing` forever (write fanout keeps
            # targeting a copy whose recovery never ran, and no retry is
            # ever scheduled because the copy still looks in-flight)
            cancelled_queued = task is not None and task.cancelled
            try:
                if not cancelled_queued:
                    if task is not None:
                        task.start()
                        # current-task context: the stream's checkpoints
                        # (_on_recover / remote shard_sync) see this task
                        token = set_current(task)
                    if d["target"] == self._local_id():
                        self._on_recover(d)
                    else:
                        self._send(d["target"], ACTION_RECOVER, d,
                                   timeout=120.0)
                    ok = True
            except Exception:
                pass
            finally:
                if token is not None:
                    reset_current(token)
                if task is not None:
                    self.node.tasks.unregister(task)
            with self.cluster._indices_lock:
                meta = self.cluster.dist_indices.get(d["index"])
                if meta is None:
                    continue
                pend = meta.get("initializing", {}).get(str(d["shard"]), [])
                if d["target"] in pend:
                    pend.remove(d["target"])
                owners = meta["assignment"].get(str(d["shard"]))
                if ok and owners is not None and d["target"] not in owners \
                        and d["target"] in self.node.cluster_state.nodes:
                    owners.append(d["target"])  # INITIALIZING → STARTED
                    # recovery caught the copy up to the source's
                    # checkpoint: it joins the in-sync set and becomes
                    # promotable
                    insync = self._shard_in_sync(meta, d["shard"])
                    if d["target"] not in insync:
                        insync.append(d["target"])
                    promoted = True
        if promoted:
            try:
                self.cluster.publish_indices()
            except FailedToCommitClusterStateException:
                # recovery thread on a master that just lost quorum: the
                # graduation stays local; the quorum's master republishes
                pass

    def _on_recover(self, payload: dict) -> dict:
        """Recovery target: checkpoint handshake with the source copy,
        then EITHER replay the translog op suffix above this copy's local
        checkpoint (incremental — the seq-no era RecoveryTarget) OR pull
        the full live-doc snapshot (fallback for diverged copies, flushed
        ops, legacy frames). The index may not exist locally yet when
        recovery races the metadata publish — create it from the
        directive's body."""
        index, sid = payload["index"], payload["shard"]
        if payload.get("relocate"):
            # allocator-driven move: the deterministic wedge point — an
            # armed fault fails the stream BEFORE any registry entry or
            # index creation, so the relocation watchdog's cancel +
            # reschedule path is what recovers, not local cleanup
            FAULTS.check("relocation.stream", index=index, shard=sid,
                         source=payload["source"],
                         target=self._local_id())
        with self.cluster._indices_lock:
            if not self.node.index_exists(index):
                self.node.create_index(index, payload.get("body"))
        svc = self.node.indices[index]
        engine = svc.shards[sid].engine
        ckpt = engine.local_checkpoint
        rec = svc.recoveries.start(
            sid, "relocation" if payload.get("relocate") else "peer",
            source=payload["source"], target=self._local_id())
        copied = skipped = replayed = 0
        from elasticsearch_tpu_torch.utils.errors import (DocumentMissingException,
                                                    VersionConflictException)

        try:
            req = {"index": index, "shard": sid, "checkpoint": ckpt,
                   "last_term": engine.term_at(ckpt),
                   "target": self._local_id(),
                   # the kernel-library blobs this node holds: the source
                   # ships the rest beside the stream
                   "kso_have": ivf_cache.list_blob_keys(aot._EXT)}
            res = self._send(payload["source"], ACTION_SHARD_SYNC, req,
                             timeout=60.0)
            # child task on the TARGET node (parent: the driving recovery
            # task, via the wire header): a cancel aborts the replay
            # between ops/docs, the copy stays INITIALIZING and never
            # graduates
            with self.node.tasks.task(
                    ACTION_RECOVER + "[t]",
                    description=f"recover [{index}][{sid}] "
                                f"from {payload['source']}") as task:
                if res.get("mode") == "ops":
                    rec.update(mode="ops", stage="translog")
                    for op in res["ops"]:
                        task.check_cancelled()
                        FAULTS.check("recovery.ops_replay", index=index,
                                     shard=sid, seq_no=op.get("seq_no"))
                        try:
                            svc.replay_op(sid, _translog_to_replay(op))
                            replayed += 1
                        except (VersionConflictException,
                                DocumentMissingException):
                            # racing fanout write was newer: a no-op,
                            # but its seq no still counts as processed
                            # or the checkpoint stalls on the hole
                            engine.note_noop(op.get("seq_no"),
                                             op.get("term"))
                            skipped += 1
                        rec["ops_replayed"] = replayed
                        rec["docs_skipped"] = skipped
                    # an idle new primary's bumped term still propagates
                    engine.bump_term(int(res.get("term", 0)))
                else:
                    rec.update(mode="full", stage="index")
                    for d in res["docs"]:
                        task.check_cancelled()
                        try:
                            # docs AND tombstones ride the stream (a
                            # delete that landed on the source after a
                            # racing fanout index on this copy still wins
                            # by version); percolator-registry maintenance
                            # happens atomically with the engine op
                            # (IndexService.replay_op)
                            svc.replay_op(sid, d)
                            copied += 1
                        except (VersionConflictException,
                                DocumentMissingException):
                            engine.note_noop(d.get("seq_no"),
                                             d.get("term"))
                            skipped += 1  # already newer (racing write)
                        rec["docs_copied"] = copied
                        rec["docs_skipped"] = skipped
                    # prune stale-era docs the source no longer has: a
                    # diverged copy (demoted primary whose fenced write
                    # was applied locally but never acked) may hold docs
                    # from an older term that external_gte cannot remove.
                    # Current-term docs above the snapshot horizon are
                    # racing live-fanout arrivals and must survive.
                    src_term = int(res.get("term", 0))
                    src_ckpt = int(res.get("local_checkpoint", -1))
                    snap_ids = {d["id"] for d in res["docs"]}
                    with engine._lock:
                        extras = [
                            (doc_id, loc.version, loc.seq_no, loc.term)
                            for doc_id, loc in engine._locations.items()
                            if not loc.deleted and doc_id not in snap_ids
                            and (loc.term < src_term
                                 or (loc.term == src_term
                                     and 0 <= loc.seq_no <= src_ckpt))]
                    for doc_id, cur_version, stale_seq, stale_term \
                            in extras:
                        try:
                            # the tombstone reuses the pruned doc's OWN
                            # (seq_no, term): a local cleanup must not
                            # consume numbers from the primary's stream —
                            # a generated seqno would push this copy's
                            # checkpoint past the source's and doom every
                            # future handshake to the full-copy path
                            # (same rule as recovery._recover_full_copy)
                            svc.replay_op(sid, {"id": doc_id,
                                                "deleted": True,
                                                "version": cur_version,
                                                "seq_no": stale_seq,
                                                "term": stale_term})
                        except (VersionConflictException,
                                DocumentMissingException):
                            pass
                    # adopt the source's checkpoint + term history so the
                    # NEXT bounce of this copy recovers incrementally
                    engine.adopt_seq_state(
                        {int(t): m for t, m in
                         (res.get("term_seq") or {}).items()},
                        int(res.get("local_checkpoint", -1)),
                        int(res.get("term", 0)))
            # the source's kernel-library blobs: this node loads them
            # instead of running nvcc for its first request
            rec["kso_seeded"] = self._adopt_library_blobs(
                res.get("kso_blobs"))
            rec["stage"] = "finalize"
            svc.shards[sid].engine.refresh()
            svc.recoveries.finish(rec, ok=True)
        except Exception:
            svc.recoveries.finish(rec, ok=False)
            raise
        # the copy graduated here: adopt the census that rode the stream
        # (this node may share no blob directory with the source), flush
        # it, and queue the pre-warm replay before the copy's first
        # search (best-effort, cooldown-guarded)
        try:
            self._adopt_census_debounced(index, res.get("census"))
            self._flush_census_debounced(index)
            self.node.serving.warmup.kick("shard_assignment", [index])
        except Exception:
            pass  # warmup plumbing never fails a completed recovery
        return {"copied": copied, "skipped": skipped,
                "ops_replayed": replayed, "mode": rec["mode"]}

    #: per-index debounce window for the recovery path's census work:
    #: a recovery runs once a shard, the census is per index
    _CENSUS_DEBOUNCE_S = 5.0

    def _census_window(self, name: str, index: str):
        """(hit, stamp) of one named per-index debounce window: ``hit``
        is True while the window is open (skip the work), ``stamp()``
        opens it."""
        ts = getattr(self, name, None)
        if ts is None:
            ts = {}
            setattr(self, name, ts)
        now = time.monotonic()
        hit = now - ts.get(index, float("-inf")) < self._CENSUS_DEBOUNCE_S
        return hit, (lambda: ts.__setitem__(index, now))

    def _flush_census_debounced(self, index: str) -> None:
        """The recovery path's census flush, once a window an index."""
        hit, stamp = self._census_window("_census_flush_ts", index)
        if hit:
            return
        stamp()
        census.store_census(index)

    def _export_census_debounced(self, index: str):
        """The source's census payload for a shard-sync reply, computed
        once a window an index for all of one recovery's shards."""
        cache = getattr(self, "_census_export_cache", None)
        if cache is None:
            cache = self._census_export_cache = {}
        hit, stamp = self._census_window("_census_export_ts", index)
        if hit and index in cache:
            return cache[index]
        payload = census.export_census(index)
        cache[index] = payload
        stamp()
        return payload

    def _adopt_census_debounced(self, index: str, payload) -> None:
        """The target's adoption, once a window an index: every shard's
        recovery carries the same payload."""
        if payload is None:
            return
        hit, stamp = self._census_window("_census_adopt_ts", index)
        if hit:
            return
        if census.adopt_census(index, payload):
            stamp()

    #: cap on the library bytes one shard-sync reply ships (base64 in
    #: the JSON transport); the next handshake ships the remainder
    _KSO_SHIP_MAX_BYTES = 32 << 20

    def _adopt_library_blobs(self, blobs: Optional[dict]) -> int:
        """Target side: seed the shipped kernel-library blobs into the
        local tier (content-addressed keys: an existing file is kept;
        each blob is still checked at its load). Returns the count
        seeded; never raises."""
        if not blobs:
            return 0
        import base64

        n = 0
        for key, b64 in blobs.items():
            try:
                ivf_cache.store_blob(key, base64.b64decode(b64), aot._EXT,
                                     overwrite=False, memory=False)
                n += 1
            except Exception:
                continue  # one bad blob must not drop the rest
        return n

    def _export_library_blobs(self, have, target) -> Optional[dict]:
        """Source side: the kernel-library blobs the target reported
        missing, base64, size-capped, once a window a target."""
        if have is None or target is None:
            return None
        hit, stamp = self._census_window("_kso_export_ts", str(target))
        if hit:
            return None
        import base64

        missing = set(ivf_cache.list_blob_keys(aot._EXT)) - set(have)
        out: Dict[str, str] = {}
        total = 0
        for key in sorted(missing):
            blob = ivf_cache.load_blob(key, aot._EXT)
            if blob is None:
                continue
            if total + len(blob) > self._KSO_SHIP_MAX_BYTES:
                break  # the remainder ships on the next handshake
            total += len(blob)
            out[key] = base64.b64encode(blob).decode("ascii")
        stamp()
        return out or None

    def _on_shard_sync(self, payload: dict) -> dict:
        """Recovery source: checkpoint comparison first — when the
        target's history is a clean prefix (log-matching on the term at
        its checkpoint) and the retained translog covers everything above
        it, answer with ``mode=ops`` and just that suffix. Otherwise
        snapshot this shard's docs AND tombstones with their full
        (version, seq_no, term) identity — RecoverySourceHandler's
        phase-1 stream in ops form; concurrent writes during the copy win
        on the target via version comparison (phase 2 for free)."""
        FAULTS.check("recovery.shard_sync", index=payload["index"],
                     shard=payload["shard"])
        svc = self.node.indices[payload["index"]]
        engine = svc.shards[payload["shard"]].engine
        svc.recoveries.source_started()
        try:
            resp = self._shard_sync_response(engine, payload)
            # the census and the target's missing kernel-library blobs
            # ride the stream: the target may share no blob directory
            # with this node
            try:
                resp["census"] = self._export_census_debounced(
                    payload["index"])
                blobs = self._export_library_blobs(
                    payload.get("kso_have"), payload.get("target"))
                if blobs:
                    resp["kso_blobs"] = blobs
            except Exception:
                pass  # warmup plumbing never fails a recovery handshake
            return resp
        finally:
            svc.recoveries.source_finished()
            # this node served the index: its census is the target's
            # work list (one flush covers every shard's handshake)
            try:
                self._flush_census_debounced(payload["index"])
            except Exception:
                pass
    def _shard_sync_response(self, engine, payload: dict) -> dict:
        ckpt = payload.get("checkpoint")
        if ckpt is not None:
            ops = engine.recovery_ops(int(ckpt), payload.get("last_term"))
            if ops is not None:
                return {"mode": "ops", "ops": ops,
                        "term": engine.primary_term,
                        "local_checkpoint": engine.local_checkpoint,
                        "max_seq_no": engine.max_seq_no}
        with engine._lock:
            ids = [(doc_id, loc.version, loc.doc_type, loc.parent,
                    loc.routing, loc.deleted, loc.seq_no, loc.term)
                   for doc_id, loc in engine._locations.items()]
            term_seq = dict(engine._term_seq)
            src_term = engine.primary_term
            src_ckpt = engine.local_checkpoint
        docs = []
        for doc_id, version, doc_type, parent, routing, deleted, seq_no, \
                term in ids:
            if deleted:
                docs.append({"id": doc_id, "version": version,
                             "deleted": True, "seq_no": seq_no,
                             "term": term})
                continue
            got = engine.get(doc_id)
            if got is None:
                continue  # deleted mid-snapshot
            loc = engine._locations.get(doc_id)
            docs.append({"id": doc_id, "source": got["_source"],
                         "version": version, "type": doc_type,
                         "parent": parent, "routing": routing,
                         "seq_no": seq_no, "term": term,
                         # _timestamp/_ttl ride the stream too, or the
                         # recovered copy would regenerate/lose them
                         "timestamp": getattr(loc, "timestamp", None),
                         "ttl_expiry": getattr(loc, "ttl_expiry", None)})
        return {"mode": "docs", "docs": docs, "term": src_term,
                "local_checkpoint": src_ckpt, "term_seq": term_seq}

    # -- query phase (remote endpoint) ---------------------------------------

    def _on_query(self, payload: dict) -> dict:
        """Run the query phase on the requested LOCAL shards; park the
        candidate docs under a context id for the fetch phase (reference:
        SearchService.executeQueryPhase → QuerySearchResult with id)."""
        index, body = payload["index"], payload.get("body") or {}
        shard_ids = payload["shards"]
        svc = self.node.indices.get(index)
        if svc is None:
            raise IndexNotFoundException(index)
        self._prune_contexts()
        pairs: List[Tuple[Any, Any]] = []
        shards_out = []
        agg_lists: List[dict] = []
        # the owner's census: the programs this query phase runs belong
        # to this node's index (the node a relocation streams away
        # from), and so does the body; a pre-warm replay records neither
        prewarm = warmup_mod.in_prewarm()
        if not prewarm:
            svc._record_census_body(body)
        for sid in shard_ids:
            searcher = svc.groups[sid].reader().searcher
            with self.node.tracer.span("shard.query_phase", index=index,
                                       shard=sid), \
                    programs.index_scope(None if prewarm else index):
                r = searcher.query_phase(body)
            docs_out = []
            for d in r.docs:
                docs_out.append({
                    "pos": len(pairs), "shard": sid,
                    "score": None if np.isnan(d.score) else float(d.score),
                    "sort": wire.pack(list(d.sort_values)),
                })
                pairs.append((searcher, d))
            shard_entry = {
                "shard": sid, "total": r.total_hits,
                "max_score": (None if np.isnan(r.max_score)
                              else float(r.max_score)),
                "docs": docs_out,
                "timed_out": r.timed_out,
                "terminated_early": r.terminated_early,
            }
            if r.profile is not None:
                # ?profile=true: the per-shard phase breakdown rides
                # the query-phase reply (plain ints — wire-safe)
                shard_entry["profile"] = r.profile
            shards_out.append(shard_entry)
            if r.agg_partials:
                agg_lists.extend(r.agg_partials["_list"])
        cid = uuid.uuid4().hex
        with self._lock:
            self._contexts[cid] = {"pairs": pairs, "body": body,
                                   "index": index, "born": time.time()}
        return {"context_id": cid, "shards": shards_out,
                "aggs": wire.pack(agg_lists) if agg_lists else None}

    def _on_fetch(self, payload: dict) -> List[dict]:
        """Fetch-phase endpoint: resolve context positions → hit JSON
        (reference: SearchService.executeFetchPhase by context id).
        The context is freed after serving — cross-host scroll keeps its
        state on the coordinator, never here."""
        with self._lock:
            ctx = self._contexts.pop(payload["context_id"], None)
        if ctx is None:
            from elasticsearch_tpu_torch.utils.errors import \
                SearchContextMissingException

            raise SearchContextMissingException(payload["context_id"])
        positions: List[int] = payload["positions"]
        with programs.index_scope(ctx["index"]):
            hit_of = _fetch_grouped(
                [(p,) + ctx["pairs"][p] for p in positions],
                ctx["body"], ctx["index"])
        return [hit_of[p] for p in positions]

    def _on_free(self, payload: dict) -> dict:
        with self._lock:
            self._contexts.pop(payload["context_id"], None)
        return {"ok": True}

    def _prune_contexts(self) -> None:
        now = time.time()
        with self._lock:
            for cid in [c for c, v in self._contexts.items()
                        if now - v["born"] > _CONTEXT_TTL]:
                del self._contexts[cid]

    def _free_remote(self, remote_ctx: Dict[str, str]) -> None:
        for owner, cid in remote_ctx.items():
            try:
                self._send(owner, ACTION_FREE, {"context_id": cid},
                           timeout=5.0)
            except Exception:
                pass  # TTL pruning on the owner collects it

    # -- coordinator ---------------------------------------------------------

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        """Scatter the query phase over every shard owner, merge ranked
        candidates, fetch the selected page from each owner, reduce aggs.
        Mirrors TransportSearchQueryThenFetchAction's three steps.

        Observability: runs as a registered task under one root span —
        the wire header carries both, so every remote owner's
        transport.handle/shard.query_phase spans share this trace id and
        its shard tasks parent to this one."""
        # the coordinator's census scope: the data plane calls
        # searcher.query_phase directly, outside IndexService.search; a
        # pre-warm replay stays out of it
        prewarm = warmup_mod.in_prewarm()
        try:
            scope = None if prewarm else self.resolve_index(index)
        except Exception:
            scope = None
        with self.node.tasks.task("indices:data/read/search",
                                  description=f"indices[{index}]"):
            with self.node.tracer.span("search.coordinate", index=index):
                with programs.index_scope(scope):
                    resp = self._search_inner(index, body)
        # slow log at the COORDINATOR: the owner-side query phases call
        # searcher.query_phase directly, so without this hook a
        # distributed index's thresholds would silently never fire
        # (single-node searches record inside IndexService.search)
        svc = self.node.indices.get(self.resolve_index(index))
        if svc is not None:
            svc.slowlog.on_search(resp.get("took", 0), body, resp)
            if not prewarm:
                svc._record_census_body(body or {})
        return resp

    def _mesh_all_local(self, index: str, svc, body: dict,
                        t0: float) -> Optional[dict]:
        """The co-resident case: every shard's primary owner is this
        node, so the coordinator hands the whole request to the index's
        mesh path (parallel/mesh_service.py: one round a segment over
        every shard's slot, the per-shard top k and the global merge on
        the card). Any refusal (an unsupported body feature, a breaker
        denial) returns None and the scatter loop serves the request."""
        from elasticsearch_tpu_torch.monitor import kernels

        if not getattr(svc, "_mesh_enabled", lambda: False)():
            return None
        try:
            searchers = [g.reader().searcher for g in svc.groups]
            from elasticsearch_tpu_torch.parallel.mesh_service import \
                try_mesh_search

            with self.node.tracer.span("shard.query_phase.mesh",
                                       index=index):
                resp = try_mesh_search(svc, searchers, body)
        except Exception:  # the scatter loop is
            kernels.record("dist_mesh_error")  # the reference path; any
            return None                        # mesh failure degrades
        if resp is None:
            kernels.record("dist_mesh_fallback")
            return None
        kernels.record("dist_mesh_search")
        resp["took"] = int((time.perf_counter() - t0) * 1000)
        return resp

    def _search_inner(self, index: str, body: Optional[dict]) -> dict:
        from elasticsearch_tpu_torch.search.aggregations.base import (parse_aggs,
                                                                reduce_aggs)
        from elasticsearch_tpu_torch.search.service import (_parse_sort, _sort_key)

        body = body or {}
        t0 = time.perf_counter()
        index = self.resolve_index(index)
        meta = self._meta(index)
        svc0 = self.node.indices.get(index)
        if svc0 is not None:
            from elasticsearch_tpu_torch.cluster.metadata import check_open

            check_open(svc0, op="read")  # closed-ness is published state
        local_id = self._local_id()
        # cross-host scroll: the per-owner fetch contexts are one-shot, so
        # the coordinator MATERIALIZES the window (capped at the 10k
        # result window — DEVIATIONS.md) and pages from it; the shards see
        # a full-window query phase
        scroll = body.get("scroll")
        page_size = int(body.get("size", 10))
        if scroll:
            body = {k: v for k, v in body.items() if k != "scroll"}
            body["size"] = 10_000
            body["from"] = 0
        if body.get("query"):
            # MLT liked ids resolve via the ROUTED cross-host get before
            # the scatter — each owner only holds its own shards' docs
            from elasticsearch_tpu_torch.search.queries import rewrite_mlt_in_body

            def _lookup(doc_id, routing=None, index=None, _ix=index):
                # an aliased _index must resolve before the dist check
                target = self.resolve_index(index or _ix)
                try:
                    if target in self.cluster.dist_indices:
                        got = self.get_doc(target, doc_id, routing=routing)
                    else:  # a like item naming a coordinator-local index
                        svc = self.node.indices.get(target)
                        if svc is None:
                            return None
                        return svc.mlt_source(doc_id, routing=routing)
                except Exception:
                    return None
                return got.get("_source") if got.get("found") else None

            q2 = rewrite_mlt_in_body(body["query"], _lookup)
            if q2 is not body["query"]:
                body = dict(body, query=q2)
        by_owner: Dict[str, List[int]] = {}
        unassigned: List[dict] = []
        for sid in range(meta["num_shards"]):
            owners = meta["assignment"][str(sid)]
            if not owners:
                unassigned.append(shard_failure_entry(
                    index, sid, error_type="unavailable_shards_exception",
                    reason="no active copies", status=503))
                continue
            by_owner.setdefault(owners[0], []).append(sid)
        sort_spec = _parse_sort(body.get("sort"))
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0))
        # per-shard query/fetch deadline: the body `timeout` (which the
        # shards also apply to their collect loops) caps the COORDINATOR'S
        # total scatter+fetch wall time; without one, a default stops a
        # hung peer from wedging the search forever
        from elasticsearch_tpu_torch.search.service import _parse_timeout

        deadline = time.monotonic() + (_parse_timeout(body.get("timeout"))
                                       or _SEARCH_DEADLINE)

        entries: List[dict] = []
        agg_lists: List[dict] = []
        remote_ctx: Dict[str, str] = {}
        profiles: List[dict] = []
        total = 0
        max_score = float("-inf")
        timed_out = False
        terminated = False
        # per-shard failures are collected, not fatal, matching the
        # reference's ShardSearchFailure accounting — unless EVERY shard
        # failed, in which case the search as a whole is an error
        failed: List[dict] = list(unassigned)
        owner_order = {nid: i for i, nid in enumerate(sorted(by_owner))}
        svc = self.node.indices.get(index)
        # mesh preference: when every shard's primary owner is THIS node,
        # the whole query phase runs as the index's mesh round instead of
        # the serial per-shard scatter below. TCP remains the control plane —
        # metadata/assignment above, remote fetch and the scatter loop as
        # the unconditional fallback (scroll and suggest keep the scatter
        # path: their post-merge machinery lives there).
        if (svc is not None and by_owner and not unassigned
                and not scroll and not body.get("suggest")
                and set(by_owner) == {local_id}):
            resp = self._mesh_all_local(index, svc, body, t0)
            if resp is not None:
                return resp
        from elasticsearch_tpu_torch.tracing import check_cancelled

        try:
            for owner, sids in sorted(by_owner.items()):
                # cooperative checkpoint between owners: a cancelled
                # search stops scattering (already-parked remote contexts
                # free in the finally)
                check_cancelled()
                if owner == local_id:
                    for sid in sids:
                        try:
                            searcher = svc.groups[sid].reader().searcher
                            with self.node.tracer.span(
                                    "shard.query_phase", index=index,
                                    shard=sid):
                                r = searcher.query_phase(body)
                        except Exception as e:
                            # a single bad local shard degrades to a
                            # partial result, same as a dead peer's —
                            # broad on purpose: the remote path catches
                            # ANY failure, and shard placement must not
                            # change whether degradation happens
                            failed.append(shard_failure_entry(
                                index, sid, e, node=owner))
                            continue
                        total += r.total_hits
                        if r.docs and not np.isnan(r.max_score):
                            max_score = max(max_score, r.max_score)
                        timed_out |= r.timed_out
                        terminated |= r.terminated_early
                        if r.profile is not None:
                            profiles.append(_shard_profile(
                                owner, index, sid, r.profile))
                        for d in r.docs:
                            entries.append({
                                "owner": owner, "shard": sid,
                                "score": d.score, "sort": d.sort_values,
                                "local": (searcher, d), "pos": -1,
                            })
                        if r.agg_partials:
                            agg_lists.extend(r.agg_partials["_list"])
                    continue
                try:
                    res = self._send_idempotent(
                        owner, ACTION_QUERY,
                        {"index": index, "body": body, "shards": sids},
                        deadline=deadline)
                except Exception as e:
                    failed.extend(shard_failure_entry(index, sid, e,
                                                      node=owner)
                                  for sid in sids)
                    continue
                remote_ctx[owner] = res["context_id"]
                for sh in res["shards"]:
                    total += sh["total"]
                    if sh["max_score"] is not None:
                        max_score = max(max_score, sh["max_score"])
                    timed_out |= sh["timed_out"]
                    terminated |= sh["terminated_early"]
                    if sh.get("profile"):
                        profiles.append(_shard_profile(
                            owner, index, sh["shard"], sh["profile"]))
                    for d in sh["docs"]:
                        entries.append({
                            "owner": owner, "shard": sh["shard"],
                            "score": (float("nan") if d["score"] is None
                                      else d["score"]),
                            "sort": tuple(wire.unpack(d["sort"])),
                            "local": None, "pos": d["pos"],
                        })
                if res.get("aggs") is not None:
                    agg_lists.extend(wire.unpack(res["aggs"]))
            if failed and len(failed) == meta["num_shards"]:
                # graceful degradation has a floor: NOTHING answered, so
                # there is no partial result to serve (reference:
                # SearchPhaseExecutionException "all shards failed")
                raise TransportError(
                    "all shards failed: "
                    f"{[f['reason']['reason'] for f in failed]}")

            if sort_spec:
                entries.sort(key=lambda e: _sort_key(e["sort"], sort_spec))
            else:
                entries.sort(key=lambda e: (-e["score"],
                                            owner_order[e["owner"]],
                                            e["shard"], e["pos"]))
            page = entries[frm:frm + size]

            # fetch phase: local directly, remote by context positions
            hit_of: Dict[int, dict] = _fetch_grouped(
                [(i, e["local"][0], e["local"][1])
                 for i, e in enumerate(page) if e["local"] is not None],
                body, index)
            by_remote: Dict[str, List[int]] = {}
            for i, e in enumerate(page):
                if e["local"] is None:
                    by_remote.setdefault(e["owner"], []).append(i)
            for owner, idxs in by_remote.items():
                try:
                    hits = self._send_idempotent(
                        owner, ACTION_FETCH,
                        {"context_id": remote_ctx[owner],
                         "positions": [page[i]["pos"] for i in idxs]},
                        deadline=deadline)
                except Exception as e:
                    # an owner that died BETWEEN query and fetch: its
                    # page hits drop, its shards are reported failed, the
                    # rest of the page still serves (reference: fetch-
                    # phase ShardSearchFailure accounting). Drop its
                    # context from the free list too — the finally's
                    # synchronous free would block the response on the
                    # same dead peer; the owner's TTL pruning collects it
                    remote_ctx.pop(owner, None)
                    for sid in sorted({page[i]["shard"] for i in idxs}):
                        failed.append(shard_failure_entry(index, sid, e,
                                                          node=owner))
                    continue
                remote_ctx.pop(owner, None)  # served: nothing to free
                for i, h in zip(idxs, hits):
                    hit_of[i] = h
        finally:
            # owners whose contexts were never fetched (no page hits, or an
            # error later in the scatter/fetch) must not leak parked results
            self._free_remote(remote_ctx)
            remote_ctx.clear()

        # a deadline blown mid-scatter/fetch surfaces as timed_out=true
        # ONLY when it degraded something (failure entries exist) — a
        # slow-but-complete search is complete, not timed out
        timed_out |= bool(failed) and time.monotonic() > deadline
        response: Dict[str, Any] = {
            "took": int((time.perf_counter() - t0) * 1000),
            "timed_out": timed_out,
            "_shards": {"total": meta["num_shards"],
                        "successful": meta["num_shards"] - len(failed),
                        "failed": len(failed)},
            "hits": {
                "total": total,
                "max_score": (None if (max_score == float("-inf")
                                       or sort_spec) else max_score),
                # fetch-failed owners' hits are absent from hit_of: the
                # page compacts around them (partial results, not holes)
                "hits": [hit_of[i] for i in range(len(page))
                         if i in hit_of],
            },
        }
        if failed:
            response["_shards"]["failures"] = failed
        if terminated:
            response["terminated_early"] = True
        if profiles:
            response["profile"] = {"shards": profiles}
        agg_tree = parse_aggs(body.get("aggs") or body.get("aggregations"))
        if agg_tree and agg_lists:
            response["aggregations"] = reduce_aggs(agg_tree, agg_lists)
        if body.get("suggest"):
            # a dead peer already shows in the query phase's _shards above
            response["suggest"] = self.suggest_fan(index,
                                                   body["suggest"])[0]
        if scroll:
            from elasticsearch_tpu_torch.search.service import register_scroll_hits

            full = response["hits"]["hits"]
            # search_type=scan: the first response carries NO hits by
            # contract — everything serves via scroll pages (clients like
            # helpers.scan discard the initial page)
            is_scan = str(body.get("search_type", "")) == "scan"
            response["_scroll_id"] = register_scroll_hits(
                {"size": page_size}, full, total,
                consumed=0 if is_scan else page_size)
            response["hits"]["hits"] = [] if is_scan else full[:page_size]
        return response


def _shard_profile(owner: str, index: str, sid: int, tpu: dict) -> dict:
    """One cross-host ``profile.shards[]`` entry: the owner NODE joins
    the label (the reference's profile shard ids carry the node id).
    The envelope time is the timer's MEASURED wall total — phase buckets
    overlap (topk also files under device_*), so a phase sum would
    over-report."""
    from elasticsearch_tpu_torch.tracing.profiler import shard_profile_entry

    return shard_profile_entry(f"[{owner}][{index}][{sid}]",
                               int((tpu or {}).get("query_total_nanos", 0)),
                               tpu)


def _fetch_grouped(triples: List[Tuple[Any, Any, Any]], body: dict,
                   index_name: str) -> Dict[Any, dict]:
    """(key, searcher, ShardDoc) triples → {key: hit JSON}, batching the
    fetch phase per searcher (shared by the fetch endpoint and the
    coordinator's local-shard fetch)."""
    by_searcher: Dict[int, List[Tuple[Any, Any]]] = {}
    searchers: Dict[int, Any] = {}
    for key, searcher, doc in triples:
        searchers[id(searcher)] = searcher
        by_searcher.setdefault(id(searcher), []).append((key, doc))
    out: Dict[Any, dict] = {}
    for sk, items in by_searcher.items():
        hits = searchers[sk].fetch_phase([d for _, d in items], body,
                                         index_name)
        for (key, _d), h in zip(items, hits):
            out[key] = h
    return out
