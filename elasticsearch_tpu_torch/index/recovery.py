"""Shard recovery: the per-index record of recoveries, local (gateway)
recovery and peer recovery (primary → replica).

Port of elasticsearch_tpu/index/recovery.py. ``RecoveryRegistry`` keeps
each index's recovery entries (ES's RecoveriesCollection and
RecoveryState): plain dicts the running recovery updates in place,

    shard, type ("gateway"|"replica"), mode (None for a gateway replay,
    "ops"|"full" for a peer recovery), stage
    ("init"|"index"|"translog"|"finalize"|"done"|"failed"), source,
    target, ops_replayed, docs_copied, docs_skipped, start_millis,
    total_time_in_millis

``recover_local`` is the gateway's replay of one shard: its committed
blocks, then its translog (``IndexShard.recover``).

``recover_peer`` is ES's checkpoint-based peer recovery: when the
target's history is a clean prefix of the source's and the source's
translog still holds every op above the target's local checkpoint, only
that suffix is replayed (``mode="ops"``); otherwise every doc is copied
(``mode="full"``), tombstones included, the target's stale-era docs are
pruned and it adopts the source's checkpoint and term history. The full
copy re-indexes in the order of the source's location table, so a copy
gets the same local doc ids and tie order as a fresh primary of the same
writes. On the card a copied doc is re-analysed and frozen into the
target's own device segments: that rebuild is why the ops mode matters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from elasticsearch_tpu_torch.tracing.tasks import check_cancelled
from elasticsearch_tpu_torch.utils.errors import (DocumentMissingException,
                                                  VersionConflictException)
from elasticsearch_tpu_torch.utils.faults import FAULTS


class RecoveryRegistry:
    def __init__(self, max_entries: int = 64):
        self._lock = threading.Lock()
        self._entries: "deque[dict]" = deque(maxlen=max_entries)
        # streams this node serves as a cluster recovery source
        self._source_active = 0

    def source_started(self) -> None:
        with self._lock:
            self._source_active += 1

    def source_finished(self) -> None:
        with self._lock:
            self._source_active = max(0, self._source_active - 1)

    @property
    def source_active(self) -> int:
        with self._lock:
            return self._source_active

    def start(self, shard: int, rtype: str, source: str = "local",
              target: str = "local") -> dict:
        entry = {"shard": shard, "type": rtype, "mode": None,
                 "stage": "init", "source": source, "target": target,
                 "ops_replayed": 0, "docs_copied": 0, "docs_skipped": 0,
                 "start_millis": int(time.time() * 1000),
                 "total_time_in_millis": 0, "_t0": time.perf_counter()}
        with self._lock:
            self._entries.append(entry)
        return entry

    @staticmethod
    def finish(entry: dict, ok: bool = True) -> None:
        entry["total_time_in_millis"] = int(
            (time.perf_counter() - entry.pop("_t0", time.perf_counter()))
            * 1000)
        entry["stage"] = "done" if ok else "failed"

    def entries(self, shard: Optional[int] = None) -> list:
        with self._lock:
            out = [dict(e) for e in self._entries]
        if shard is not None:
            out = [e for e in out if e["shard"] == shard]
        return out


def recover_local(shard, registry: RecoveryRegistry) -> int:
    """Gateway recovery of one shard, recorded in ``registry`` as a
    ``gateway`` entry: ``ops_replayed`` counts the committed docs and the
    translog ops replayed; a failed replay leaves a ``failed`` entry and
    raises. Returns ops replayed."""
    entry = registry.start(shard.shard_id, "gateway")
    try:
        entry["stage"] = "translog"
        entry["ops_replayed"] = shard.recover()
    except Exception:
        registry.finish(entry, ok=False)
        raise
    registry.finish(entry)
    return entry["ops_replayed"]


def recover_peer(source_engine, target_engine,
                 entry: Optional[dict] = None) -> dict:
    """Sync the target copy from the source: ops replay when safe, else
    the full copy (module doc). Cancellable between ops and docs; an
    aborted stream leaves the target partly synced but versioned, so a
    retry resumes. ``entry`` (a RecoveryRegistry dict) is updated as it
    runs. Returns the recovery's stats."""
    entry = entry if entry is not None else {}
    ckpt = target_engine.local_checkpoint
    ops = source_engine.recovery_ops(ckpt, target_engine.term_at(ckpt))
    if ops is None:
        return _recover_full_copy(source_engine, target_engine, entry)
    entry.update(mode="ops", stage="translog")
    replayed = skipped = 0
    for op in ops:
        check_cancelled()
        FAULTS.check("recovery.ops_replay", seq_no=op.get("seq_no"),
                     index=source_engine.index_name)
        try:
            target_engine.apply_translog_op(op)
            replayed += 1
        except (VersionConflictException, DocumentMissingException):
            # newer state already covers the op: a no-op whose seq no is
            # still processed, or the checkpoint stalls on the hole
            target_engine.note_noop(op.get("seq_no"), op.get("term"))
            skipped += 1
        entry["ops_replayed"] = replayed
        entry["docs_skipped"] = skipped
    # an idle promoted primary has a newer term and no ops yet: the term
    # still reaches the copy, so it fences the old primary
    target_engine.bump_term(source_engine.primary_term)
    entry["stage"] = "finalize"
    target_engine.refresh()
    return {"mode": "ops", "ops_replayed": replayed, "skipped": skipped,
            "copied": 0}


def _recover_full_copy(source_engine, target_engine, entry: dict) -> dict:
    """Snapshot the source's location table (live docs and tombstones)
    and re-index it on the target; writes racing the copy are settled by
    versions, not by holding the source's lock."""
    entry.update(mode="full", stage="index")
    copied = skipped = 0
    with source_engine._lock:
        snapshot = [(doc_id, loc.version, loc.doc_type, loc.parent,
                     loc.routing, loc.deleted, loc.seq_no, loc.term)
                    for doc_id, loc in source_engine._locations.items()]
        src_term = source_engine.primary_term
        src_ckpt = source_engine.local_checkpoint
        src_term_seq = dict(source_engine._term_seq)
    snapshot_ids = {doc_id for doc_id, *_ in snapshot}
    for doc_id, version, doc_type, parent, routing, deleted, seq_no, term \
            in snapshot:
        check_cancelled()
        if deleted:
            # a tombstone rides the stream: a target that holds the doc
            # from an earlier aborted recovery must see the delete
            try:
                target_engine.delete(doc_id, version=version,
                                     version_type="external_gte",
                                     seq_no=seq_no, primary_term=term,
                                     _replay=True, _history=True)
            except DocumentMissingException:
                target_engine.note_noop(seq_no, term)
            except VersionConflictException:
                target_engine.note_noop(seq_no, term)
                skipped += 1
            continue
        got = source_engine.get(doc_id)
        if got is None:  # deleted mid-copy: its tombstone fans out live
            skipped += 1
            continue
        try:
            target_engine.index(
                doc_id, got["_source"], version=version,
                version_type="external_gte", doc_type=doc_type,
                parent=parent, routing=routing, seq_no=seq_no,
                primary_term=term, _replay=True, _history=True)
            copied += 1
        except VersionConflictException:
            target_engine.note_noop(seq_no, term)
            skipped += 1  # the target already has a newer op
        entry["docs_copied"] = copied
        entry["docs_skipped"] = skipped
    # prune the stale-era docs the source no longer has (a demoted
    # primary's unacknowledged local writes, which external_gte can never
    # remove); current-term docs above the snapshot are live fan-out
    # racing the copy and stay
    with target_engine._lock:
        extras = [(doc_id, loc.seq_no, loc.term)
                  for doc_id, loc in target_engine._locations.items()
                  if not loc.deleted and doc_id not in snapshot_ids
                  and (loc.term < src_term
                       or (loc.term == src_term
                           and 0 <= loc.seq_no <= src_ckpt))]
    for doc_id, stale_seq, stale_term in extras:
        try:
            # a local clean-up under the pruned doc's own (seq no, term):
            # it takes no number from the primary's stream
            target_engine.delete(doc_id, version_type="force", version=0,
                                 seq_no=stale_seq, primary_term=stale_term,
                                 _replay=True, _history=True)
        except DocumentMissingException:
            pass
    # the target mirrors the source wholesale: the next recovery can be
    # ops-based
    target_engine.adopt_seq_state(src_term_seq, src_ckpt, src_term)
    entry["stage"] = "finalize"
    target_engine.refresh()
    return {"mode": "full", "copied": copied, "skipped": skipped,
            "ops_replayed": 0}
