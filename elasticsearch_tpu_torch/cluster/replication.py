"""Write replication: primary → replica fan-out, failover, replica reads.

Port of elasticsearch_tpu/cluster/replication.py (ES's
TransportShardReplicationOperationAction and the primary promotion of
its allocation). A write executes on the primary, then fans out
synchronously to every replica under the primary's (version, seq no,
term); a replica that fails the op leaves the group and its in-sync set,
and the client's write still succeeds, with the failure counted in its
``_shards``. A replica that refuses the op's term (StalePrimaryException)
is not at fault: the primary was demoted, and the write is never
acknowledged (the zombie-primary fence).

On one card a replica is a whole ``IndexShard``: its own engine and its
own device-resident segments, charged to the node's breakers like the
primary's. It keeps no translog (durability lives on the primary) and
re-syncs by peer recovery (``index/recovery.py``). ``reader`` picks the
copy a search reads: ``_primary``, ``_replica`` (the first replica) or,
by default, the next copy in turn.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, List, Optional

from elasticsearch_tpu_torch.index.recovery import recover_peer
from elasticsearch_tpu_torch.index.seqno import GlobalCheckpointTracker
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  StalePrimaryException)
from elasticsearch_tpu_torch.utils.faults import FAULTS

logger = logging.getLogger(__name__)


class ReplicationGroup:
    """One shard's copies: a primary plus N replicas.

    Lock order: ``_lock`` is the outermost lock of a replicated write;
    under it the copies' engines (``Engine._lock`` → ``Translog._lock``)
    and the checkpoint tracker are taken. Nothing under an engine lock
    calls back into the group."""

    def __init__(self, shard_id: int, primary,
                 replicas: Optional[list] = None):
        self.shard_id = shard_id
        self.primary = primary
        self.replicas: List[Any] = list(replicas or [])
        self.failed_replicas: List[Any] = []
        self._lock = threading.RLock()
        self._read_rr = 0
        # the in-sync copy set, keyed by engine commit id (the in-process
        # stand-in for ES's allocation ids)
        self.checkpoints = GlobalCheckpointTracker(
            in_sync=[c.engine.commit_id for c in self.copies])

    # -- writes ----------------------------------------------------------------

    @property
    def primary_term(self) -> int:
        return self.primary.engine.primary_term

    def index(self, doc_id, source, **kw):
        """Index on the primary, then fan out with its (version, seq no,
        term). Returns (id, version, created, replicas failed, seq no,
        term)."""
        with self._lock:
            rid, version, created = self.primary.engine.index(doc_id, source,
                                                              **kw)
            loc = self.primary.engine._locations[rid]
            seq_no, term = loc.seq_no, loc.term
            failed = self._fanout("index", rid, source=source,
                                  version=version, seq_no=seq_no, term=term,
                                  kw=kw)
            self._note_checkpoints()
            return rid, version, created, failed, seq_no, term

    def delete(self, doc_id, **kw):
        """Returns (version, replicas failed, seq no, term)."""
        with self._lock:
            version = self.primary.engine.delete(doc_id, **kw)
            loc = self.primary.engine._locations.get(str(doc_id))
            seq_no = loc.seq_no if loc else -2
            term = loc.term if loc else self.primary_term
            failed = self._fanout("delete", doc_id, version=version,
                                  seq_no=seq_no, term=term, kw=kw)
            self._note_checkpoints()
            return version, failed, seq_no, term

    def _fanout(self, op: str, doc_id, source=None, version=None,
                seq_no=None, term=None, kw=None) -> int:
        """Apply one op on every replica; returns how many failed (each is
        moved to ``failed_replicas`` and out of the in-sync set: a copy
        that missed an acknowledged write must not be promoted until a
        recovery re-syncs it). A stale-term refusal propagates: this
        primary was demoted and the write must not be acknowledged."""
        kw = dict(kw or {})
        for k in ("version", "version_type", "op_type", "seq_no",
                  "primary_term"):
            kw.pop(k, None)
        failed = 0
        for replica in list(self.replicas):
            try:
                FAULTS.check("replication.fanout", shard=self.shard_id,
                             op=op, id=str(doc_id))
                if op == "index":
                    replica.engine.index(doc_id, source, version=version,
                                         version_type="external_gte",
                                         seq_no=seq_no, primary_term=term,
                                         _replay=True, **kw)
                else:
                    try:
                        replica.engine.delete(doc_id, seq_no=seq_no,
                                              primary_term=term,
                                              _replay=True)
                    except StalePrimaryException:
                        raise
                    except ElasticsearchTpuException:
                        # absent on the replica: a no-op, but its seq no
                        # is processed (the checkpoint must not stall)
                        replica.engine.note_noop(seq_no, term)
            except StalePrimaryException:
                raise
            except Exception:
                # any fault of one copy fails that copy, never the write
                logger.warning("shard [%s]: replica failed %s [%s]; failing "
                               "the copy", self.shard_id, op, doc_id,
                               exc_info=True)
                if replica in self.replicas:
                    self.replicas.remove(replica)
                    self.failed_replicas.append(replica)
                    self.checkpoints.remove(replica.engine.commit_id)
                failed += 1
        return failed

    def _note_checkpoints(self) -> None:
        """Report every copy's local checkpoint; the global checkpoint is
        their in-sync minimum."""
        for c in self.copies:
            self.checkpoints.update_local(c.engine.commit_id,
                                          c.engine.local_checkpoint)

    @property
    def global_checkpoint(self) -> int:
        return self.checkpoints.global_checkpoint

    def replicate_current(self, doc_id: str):
        """Fan out the primary's current state of ``doc_id`` (after a
        partial update, whose merged source exists only there)."""
        with self._lock:
            eng = self.primary.engine
            loc = eng._locations.get(str(doc_id))
            if loc is None or loc.deleted:
                seq_no = loc.seq_no if loc else None
                term = loc.term if loc else self.primary_term
                self._fanout("delete", doc_id, seq_no=seq_no, term=term)
                return
            got = eng.get(str(doc_id))
            self._fanout("index", str(doc_id), source=got["_source"],
                         version=loc.version, seq_no=loc.seq_no,
                         term=loc.term,
                         kw={"routing": loc.routing, "doc_type": loc.doc_type,
                             "parent": loc.parent})
            self._note_checkpoints()

    # -- copies ----------------------------------------------------------------

    def add_replica(self, replica, entry: Optional[dict] = None) -> dict:
        """Peer-recover ``replica`` from the primary and start it, under
        the lock writes fan out under: it joins the replicas and, its
        checkpoint caught up, the in-sync set, so it can be promoted
        (the reference never marks such a copy in sync: ROADMAP C15).
        ``entry`` (a RecoveryRegistry dict) records the recovery.
        Returns the recovery's stats."""
        with self._lock:
            stats = recover_peer(self.primary.engine, replica.engine, entry)
            if replica in self.failed_replicas:
                self.failed_replicas.remove(replica)
            self.replicas.append(replica)
            self.checkpoints.mark_in_sync(replica.engine.commit_id,
                                          replica.engine.local_checkpoint)
            self._note_checkpoints()
            return stats

    # -- failover --------------------------------------------------------------

    def fail_primary(self):
        """Promote the first in-sync replica under a bumped primary term;
        the old primary leaves the in-sync set, and every surviving copy
        fences any op still carrying its term."""
        with self._lock:
            in_sync = self.checkpoints.in_sync
            candidates = [r for r in self.replicas
                          if r.engine.commit_id in in_sync]
            if not candidates:
                raise ElasticsearchTpuException(
                    f"shard [{self.shard_id}]: no in-sync replica to promote")
            old = self.primary
            new_term = max(c.engine.primary_term for c in self.copies) + 1
            promoted = candidates[0]
            self.replicas.remove(promoted)
            self.primary = promoted
            self.primary.engine.bump_term(new_term)
            self.failed_replicas.append(old)
            self.checkpoints.remove(old.engine.commit_id)
            return self.primary

    # -- reads -----------------------------------------------------------------

    def reader(self, preference: Optional[str] = None):
        """The copy a search reads (query-then-fetch's shard pick)."""
        with self._lock:
            if preference == "_primary" or not self.replicas:
                return self.primary
            if preference == "_replica":
                return self.replicas[0]
            copies = [self.primary] + self.replicas
            self._read_rr = (self._read_rr + 1) % len(copies)
            return copies[self._read_rr]

    @property
    def copies(self) -> list:
        return [self.primary] + list(self.replicas)

    def refresh(self):
        for c in self.copies:
            c.refresh()
