"""Sequence numbers and checkpoints: the replication-safety substrate.

Reference: org/elasticsearch/index/seqno/ — SequenceNumbers.java
(UNASSIGNED/NO_OPS_PERFORMED sentinels), LocalCheckpointTracker.java (the
max-contiguous-processed-seqno tracker, bitset over the window above the
checkpoint) and ReplicationTracker.java (global checkpoint = min local
checkpoint over the in-sync copy set). This is the ES 6.x seq-no upgrade
grafted onto the 2.0 architecture the paper reproduces: every engine op
gets a (primary term, seq no) identity assigned by the primary, each copy
tracks the highest contiguous seq no it has durably processed (its LOCAL
checkpoint), and the replication group derives the GLOBAL checkpoint that
peer recovery uses to replay only the missing op suffix instead of
re-shipping every live doc.

TPU relevance: segments here are device-resident arrays regenerated from
_source (BM25S-style eager scoring, arXiv:2407.03618), so a full-copy
recovery is not "rsync some files" — it re-freezes whole device slabs.
Checkpointed ops-replay is what makes a node bounce under write load
cheap.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Set

#: no operations have been performed yet / empty-copy checkpoint
NO_OPS_PERFORMED = -1
#: an op that never got a sequence number (legacy translog frames)
UNASSIGNED_SEQ_NO = -2


class LocalCheckpointTracker:
    """Tracks the max contiguous processed seq no for ONE shard copy.

    The primary calls ``generate()`` to assign the next seq no under its
    term; every copy (primary included) calls ``mark_processed`` once the
    op is applied. Replica appends can arrive out of order (concurrent
    fanout), so processed seq nos above the checkpoint park in a set and
    the checkpoint advances only over a contiguous prefix — exactly the
    reference's CountedBitSet window, sans the fixed-size paging."""

    def __init__(self, max_seq_no: int = NO_OPS_PERFORMED,
                 local_checkpoint: int = NO_OPS_PERFORMED):
        self._lock = threading.Lock()
        self._next = max_seq_no + 1
        self._checkpoint = local_checkpoint
        self._pending: Set[int] = set()  # processed seq nos > checkpoint

    def generate(self) -> int:
        """Assign the next seq no (primary only)."""
        with self._lock:
            s = self._next
            self._next += 1
            return s

    def mark_processed(self, seq_no: int) -> None:
        if seq_no < 0:
            return  # UNASSIGNED: legacy op, contributes nothing
        with self._lock:
            if seq_no >= self._next:
                self._next = seq_no + 1
            if seq_no <= self._checkpoint:
                return  # duplicate delivery (retried fanout)
            self._pending.add(seq_no)
            while self._checkpoint + 1 in self._pending:
                self._checkpoint += 1
                self._pending.discard(self._checkpoint)

    def advance_to(self, checkpoint: int) -> None:
        """Adopt a checkpoint wholesale (full-copy recovery: the target
        received the source's complete state, so every seq no up to the
        source's local checkpoint is by definition processed here)."""
        with self._lock:
            if checkpoint <= self._checkpoint:
                return
            self._checkpoint = checkpoint
            self._next = max(self._next, checkpoint + 1)
            self._pending = {s for s in self._pending if s > checkpoint}
            while self._checkpoint + 1 in self._pending:
                self._checkpoint += 1
                self._pending.discard(self._checkpoint)

    @property
    def checkpoint(self) -> int:
        with self._lock:
            return self._checkpoint

    @property
    def max_seq_no(self) -> int:
        with self._lock:
            return self._next - 1

    def has_gaps(self) -> bool:
        """True when ops above the checkpoint arrived out of order and a
        hole is still unfilled (replica mid-fanout)."""
        with self._lock:
            return bool(self._pending)


class GlobalCheckpointTracker:
    """Derives the replication group's GLOBAL checkpoint: the highest seq
    no every IN-SYNC copy has processed (reference: ReplicationTracker —
    min over in-sync allocation ids' reported local checkpoints).

    Copies are keyed by an allocation id (engine commit id in-process,
    node id cross-host). A copy with no report yet counts as
    NO_OPS_PERFORMED, so adding an un-synced copy to the in-sync set
    drags the global checkpoint down — which is why recovery only
    graduates a copy INTO the set after its checkpoint caught up. The
    global checkpoint is monotonic: late/stale reports never move it
    backwards."""

    def __init__(self, in_sync: Optional[Iterable[str]] = None):
        self._lock = threading.Lock()
        self._local: Dict[str, int] = {}
        self._in_sync: Set[str] = set(in_sync or ())
        self._global = NO_OPS_PERFORMED

    def update_local(self, alloc_id: str, local_checkpoint: int) -> None:
        with self._lock:
            cur = self._local.get(alloc_id, NO_OPS_PERFORMED)
            if local_checkpoint > cur:
                self._local[alloc_id] = local_checkpoint
            self._recompute()

    def mark_in_sync(self, alloc_id: str,
                     local_checkpoint: Optional[int] = None) -> None:
        with self._lock:
            self._in_sync.add(alloc_id)
            if local_checkpoint is not None:
                cur = self._local.get(alloc_id, NO_OPS_PERFORMED)
                self._local[alloc_id] = max(cur, local_checkpoint)
            self._recompute()

    def remove(self, alloc_id: str) -> None:
        """A copy failed/left: it stops holding the global checkpoint
        back (reference: in-sync set shrink on shard-failed)."""
        with self._lock:
            self._in_sync.discard(alloc_id)
            self._local.pop(alloc_id, None)
            self._recompute()

    def set_in_sync(self, alloc_ids: Iterable[str]) -> None:
        with self._lock:
            self._in_sync = set(alloc_ids)
            self._recompute()

    def _recompute(self) -> None:
        if not self._in_sync:
            return  # nothing in sync: keep the last known value
        floor = min(self._local.get(a, NO_OPS_PERFORMED)
                    for a in self._in_sync)
        if floor > self._global:
            self._global = floor

    @property
    def global_checkpoint(self) -> int:
        with self._lock:
            return self._global

    @property
    def in_sync(self) -> Set[str]:
        with self._lock:
            return set(self._in_sync)
