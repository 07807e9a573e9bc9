"""Index engine: the write path.

Port of elasticsearch_tpu/index/engine.py for the slice: versioned
index/get/delete with optimistic concurrency, realtime GET from the
not-yet-refreshed buffer, tombstone deletes, NRT refresh (the buffer
freezes into an immutable device-resident segment), the per-segment
``segments`` breaker charge, translog append and replay with (primary
term, seq no) identity, and merges: after each refresh that froze a
segment the tiered policy (``index/merge.py``) may fold a tier, or a
segment with too many deletes, into one new segment built on the
node's device from the live docs' sources; ``merge()`` with no subset
is the force merge. ``update`` merges a partial doc or runs an update
script over the current source and re-indexes it, keeping its routing,
type and parent. Docs whose ``_ttl`` expiry has passed are purged (as
deletes through the translog) at each refresh and merge; a merge checks
for cancellation between the segments it reads.

``flush`` is a durable commit: it refreshes, writes each frozen
segment's doc block (``index/snapshots.py``'s ``_segment_payload``, the
IVF/PQ blobs with it) as a content-addressed blob under
``<shard>/_commit/blobs/``, then ``commit.json`` naming them with the
live versions and the max seq no (through a temporary file and
``os.replace``), and only then lets the translog drop its generations.
``recover_from_commit`` replays the committed blocks, one segment each,
and ``recover_from_translog`` then skips the ops the commit already
holds (seq no at or below its max), so a crash between the commit point
and the translog's commit replays nothing twice. The reference's flush
drops the translog with no segment on disk, losing every flushed doc at
restart (ROADMAP C12).

Replication safety (``index/seqno.py``): the engine keeps the primary
term this copy believes its shard runs under, a local-checkpoint tracker
and each term's max seq no. A live op (a primary's own write, a
replica's fan-out) from an older term is fenced with
StalePrimaryException; a history op (translog replay, a recovery
stream, ``_history=True``) applies under its recorded term.
``recovery_ops`` serves a peer recovery the translog suffix above the
target's checkpoint, or None when only a full copy is safe;
``adopt_seq_state`` takes a full copy's checkpoint and term history.
``fail`` fails the engine closed after a tragic event; ``adopt_store``
hands a promoted replica the failed primary's translog and commit.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.doc_parser import DocumentParser
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.merge import TieredMergePolicy
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, TpuSegment
from elasticsearch_tpu_torch.index.seqno import (NO_OPS_PERFORMED,
                                                 UNASSIGNED_SEQ_NO,
                                                 LocalCheckpointTracker)
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.monitor import flight
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.tracing.tasks import check_cancelled
from elasticsearch_tpu_torch.utils.errors import (
    ActionRequestValidationException, CircuitBreakingException,
    DocumentMissingException, EngineFailedException, ScriptException,
    StalePrimaryException, VersionConflictException)
from elasticsearch_tpu_torch.utils.faults import FAULTS


@dataclass
class DocLocation:
    version: int
    deleted: bool = False
    # "buffer" or a segment id; buffer docs re-resolve on refresh
    where: Any = "buffer"
    local_id: int = -1
    source: Optional[dict] = None  # for realtime get of buffered docs
    # _type / _parent / routing, kept across partial updates
    doc_type: Optional[str] = None
    parent: Optional[str] = None
    routing: Optional[str] = None
    # the resolved _timestamp and _ttl expiry (epoch millis)
    timestamp: Optional[int] = None
    ttl_expiry: Optional[int] = None
    seq_no: int = UNASSIGNED_SEQ_NO
    term: int = 0


@dataclass
class EngineStats:
    index_total: int = 0
    delete_total: int = 0
    get_total: int = 0
    refresh_total: int = 0
    flush_total: int = 0
    index_time_ms: float = 0.0
    # ES 2.0's merge stats: merges run, docs they wrote, their time
    merge_total: int = 0
    merge_docs: int = 0
    merge_time_ms: float = 0.0


class Engine:
    """Buffer → frozen segments, doc identity, versioning, translog."""

    def __init__(self, mappings: Mappings, analysis: AnalysisRegistry,
                 residency: Residency, translog_path: Optional[str] = None,
                 index_name: str = ""):
        self.index_name = index_name
        self.mappings = mappings
        self.analysis = analysis
        self.residency = residency
        self.parser = DocumentParser(mappings, analysis)
        self.translog = Translog(translog_path)
        # the durable commit sits beside the translog (flush)
        self.commit_dir = (os.path.join(os.path.dirname(translog_path),
                                        "_commit")
                           if translog_path else None)
        # the commit's max seq no: translog ops at or below it are in it
        self._committed_seq = NO_OPS_PERFORMED
        self.buffer = SegmentBuilder(mappings, residency)
        self.segments: List[TpuSegment] = []
        self._locations: Dict[str, DocLocation] = {}
        self._buffer_ids: Dict[str, int] = {}
        self._lock = threading.RLock()
        self.stats = EngineStats()
        # the copy's identity: the replication group's in-sync set and the
        # shard stats' commit section key on it
        self.commit_id = uuid.uuid4().hex
        self.failed_reason: Optional[str] = None
        self.primary_term = 1
        self.seq = LocalCheckpointTracker()
        self._term_seq: Dict[int, int] = {}
        self._auto_id = 0
        self.merge_policy = TieredMergePolicy()
        # a segment lost docs since the last refresh: the next refresh
        # runs the merge check even when it freezes nothing
        self._deletes_pending = False

    # -- sequence numbers --------------------------------------------------------

    @property
    def local_checkpoint(self) -> int:
        return self.seq.checkpoint

    @property
    def max_seq_no(self) -> int:
        return self.seq.max_seq_no

    def bump_term(self, term: int) -> None:
        """Adopt a higher primary term (a promotion, or a newer primary's
        recovery stream)."""
        with self._lock:
            if term > self.primary_term:
                self.primary_term = term

    def _fence_term(self, op_term: Optional[int],
                    history: bool = False) -> int:
        """The term one op runs under. A live op from a term older than
        this copy's comes from a demoted primary and is refused; a newer
        one is adopted. A history op applies under its recorded term
        unfenced: replaying a term-1 op onto a term-2 copy is how a copy
        catches up. Must hold ``_lock``."""
        if op_term is None:
            return self.primary_term  # the primary's own op
        if history:
            return op_term
        if op_term < self.primary_term:
            raise StalePrimaryException(self.index_name, "?", op_term,
                                        self.primary_term)
        self.primary_term = op_term
        return op_term

    def _note_op(self, term: int, seq_no: int) -> None:
        """Record (term, seq no) in the checkpoint tracker and the
        per-term history. Must hold ``_lock``."""
        if seq_no < 0:
            return
        self.seq.mark_processed(seq_no)
        if seq_no > self._term_seq.get(term, NO_OPS_PERFORMED):
            self._term_seq[term] = seq_no

    def term_at(self, seq_no: int) -> Optional[int]:
        """The term the op at ``seq_no`` ran under: the lowest term whose
        max seq no covers it (a new primary numbers on past its
        predecessor). 0 for an empty history, None when this copy has no
        record of ``seq_no``."""
        if seq_no < 0:
            return 0
        with self._lock:
            for term in sorted(self._term_seq):
                if self._term_seq[term] >= seq_no:
                    return term
        return None

    def seq_no_stats(self) -> dict:
        return {"max_seq_no": self.max_seq_no,
                "local_checkpoint": self.local_checkpoint,
                "primary_term": self.primary_term}

    def note_noop(self, seq_no: Optional[int], term: Optional[int]) -> None:
        """Mark an op's seq no processed without applying it (a replayed
        or fanned-out op that newer state already covers: ES's NoOp), or
        the hole would hold the local checkpoint back for good."""
        if seq_no is None:
            return
        with self._lock:
            self._note_op(self.primary_term if term is None else term,
                          seq_no)

    def adopt_seq_state(self, term_seq: Dict[int, int], checkpoint: int,
                        term: int) -> None:
        """A full copy's target takes the source's checkpoint and term
        history. Terms below the source's current one are replaced, not
        merged: a diverged copy's phantom ops would otherwise fail every
        later log-matching check; the current term's entry keeps the
        larger max (live fan-out racing the copy extends it)."""
        with self._lock:
            fresh = {int(t): m for t, m in (term_seq or {}).items()}
            for t, m in self._term_seq.items():
                if t >= term and m > fresh.get(t, NO_OPS_PERFORMED):
                    fresh[t] = m
            self._term_seq = fresh
            self.seq.advance_to(checkpoint)
            if term > self.primary_term:
                self.primary_term = term

    def recovery_ops(self, checkpoint: int,
                     last_term: Optional[int] = None) -> Optional[list]:
        """A recovery source's translog ops above the target's
        ``checkpoint``, in seq-no order, or None when only a full copy is
        safe: the target is ahead of this copy, its term at its
        checkpoint differs from this copy's (the log-matching check), or
        the retained translog no longer covers the suffix (a flush
        dropped it). The log is read outside the engine lock, so a
        handshake never stalls writes; ops landing meanwhile reach the
        target by fan-out."""
        with self._lock:
            if checkpoint > self.seq.checkpoint:
                return None
            if checkpoint >= 0 and last_term is not None:
                t = self.term_at(checkpoint)
                if t is None or t != last_term:
                    return None
            upper = self.seq.max_seq_no
        by_seq: Dict[int, dict] = {}
        try:
            for op in self.translog.ops_above(checkpoint):
                s = op["seq_no"]
                prev = by_seq.get(s)
                if prev is None or op.get("term", 0) >= prev.get("term", 0):
                    by_seq[s] = op
        except OSError:
            return None
        if any(s not in by_seq for s in range(checkpoint + 1, upper + 1)):
            return None
        return [by_seq[s] for s in sorted(by_seq) if s <= upper]

    # -- tragic events -----------------------------------------------------------

    @property
    def is_failed(self) -> bool:
        return self.failed_reason is not None

    def fail(self, reason: str) -> None:
        """Fail the engine closed after a tragic event (idempotent): every
        later write raises EngineFailedException; reads still serve."""
        with self._lock:
            if self.failed_reason is not None:
                return
            self.failed_reason = reason
            try:
                self.translog.close()
            except OSError:
                pass  # the channel is what failed; the flag is what counts
        # outside the engine lock: an engine has no node back-reference,
        # so the event fans to every recorder of the process
        flight.record("engine_failures", index=self.index_name,
                      reason=reason)

    def adopt_store(self, translog_path: str) -> None:
        """Take over a failed primary's store (a promotion on a data
        path): open the translog at ``translog_path`` and the commit
        beside it, then flush, so the commit holds this copy's state and
        the old primary's translog generations are dropped before this
        copy's first write as primary. The old primary's engine must be
        failed first (``fail``: its translog is closed)."""
        with self._lock:
            self._ensure_open()
            self.translog.close()
            self.translog = Translog(translog_path)
            self.commit_dir = os.path.join(os.path.dirname(translog_path),
                                           "_commit")
            self.flush()

    def _ensure_open(self) -> None:
        if self.failed_reason is not None:
            raise EngineFailedException(self.index_name, self.failed_reason)

    def _translog_append(self, entry: dict) -> None:
        """An IO/fsync failure fails the engine CLOSED and the op is NOT
        acknowledged, so the acknowledged ops are exactly what replay
        reproduces."""
        try:
            self.translog.append(entry)
        except OSError as e:
            self.fail(f"translog append failed: {e}")
            raise EngineFailedException(self.index_name,
                                        self.failed_reason) from e

    # -- write path ------------------------------------------------------------

    def index(self, doc_id: Optional[str], source: dict,
              version: Optional[int] = None, version_type: str = "internal",
              op_type: str = "index", routing: Optional[str] = None,
              doc_type: Optional[str] = None, parent: Optional[str] = None,
              timestamp: Optional[Any] = None, ttl: Optional[Any] = None,
              ttl_expiry: Optional[int] = None,
              seq_no: Optional[int] = None,
              primary_term: Optional[int] = None,
              _replay: bool = False,
              _history: bool = False) -> Tuple[str, int, bool]:
        """Index/create a document. Returns (id, new_version, created).
        ``parent`` is a child's parent id (its ``_parent`` doc value); a
        doc with nested objects joins the buffer as one block.
        ``timestamp``/``ttl`` feed the ``_timestamp``/``_ttl`` meta
        fields; ``ttl_expiry`` is a resolved expiry a replay carries.

        Internal versioning requires the given version to equal the
        current one; external requires it to be strictly greater (gte
        allows equal). op_type=create fails if the doc exists.

        ``seq_no``/``primary_term``: None on a primary (a fresh seq no
        under the current term); a replica, a replay and a recovery
        stream pass the primary's. ``_replay`` skips the translog (a
        replica keeps none); ``_history`` applies an older term unfenced
        (``_fence_term``)."""
        t0 = time.perf_counter()
        with self._lock:
            self._ensure_open()
            op_term = self._fence_term(primary_term, history=_history)
            if doc_id is None:
                self._auto_id += 1
                doc_id = f"auto_{self._auto_id}_{int(time.time() * 1000)}"
            doc_id = str(doc_id)
            loc = self._locations.get(doc_id)
            exists = loc is not None and not loc.deleted
            current = loc.version if exists else 0
            if op_type == "create" and exists:
                raise VersionConflictException(self.index_name, doc_id,
                                               current, 0)
            if version is not None:
                if version_type == "force":
                    new_version = version
                elif version_type in ("external", "external_gt", "external_gte"):
                    ok = (loc is None or version > loc.version
                          or (version_type == "external_gte" and version >= loc.version))
                    if not ok:
                        raise VersionConflictException("", doc_id, loc.version, version)
                    new_version = version
                else:
                    if current != version:
                        raise VersionConflictException("", doc_id, current, version)
                    new_version = current + 1
            else:
                new_version = (loc.version if loc else 0) + 1

            parsed = self.parser.parse(doc_id, source, routing=routing,
                                       doc_type=doc_type, parent=parent,
                                       timestamp=timestamp, ttl=ttl,
                                       ttl_expiry=ttl_expiry)
            # seq no after validation: a rejected op consumes no number
            if seq_no is None:
                seq_no = self.seq.generate()
            self._remove_existing(doc_id)
            self._buffer_ids[doc_id] = self.buffer.add(parsed)
            self._locations[doc_id] = DocLocation(
                version=new_version, where="buffer",
                local_id=self._buffer_ids[doc_id], source=source,
                doc_type=doc_type, parent=parent, routing=routing,
                timestamp=parsed.meta.get("timestamp"),
                ttl_expiry=parsed.meta.get("ttl_expiry"),
                seq_no=seq_no, term=op_term)
            if not _replay:
                entry = {"op": "index", "id": doc_id, "source": source,
                         "version": new_version, "routing": routing,
                         "seq_no": seq_no, "term": op_term}
                if doc_type:
                    entry["doc_type"] = doc_type
                if parent:
                    entry["parent"] = parent
                # resolved meta values: a replay must not re-resolve "now"
                for key in ("timestamp", "ttl_expiry"):
                    if key in parsed.meta:
                        entry[key] = parsed.meta[key]
                self._translog_append(entry)
            self._note_op(op_term, seq_no)
            self.stats.index_total += 1
            self.stats.index_time_ms += (time.perf_counter() - t0) * 1e3
            return doc_id, new_version, not exists

    def delete(self, doc_id: str, version: Optional[int] = None,
               version_type: str = "internal", seq_no: Optional[int] = None,
               primary_term: Optional[int] = None,
               _replay: bool = False, _history: bool = False) -> int:
        with self._lock:
            self._ensure_open()
            op_term = self._fence_term(primary_term, history=_history)
            doc_id = str(doc_id)
            loc = self._locations.get(doc_id)
            if loc is None or loc.deleted:
                raise DocumentMissingException("", doc_id)
            if version is not None:
                if version_type == "internal" and loc.version != version:
                    raise VersionConflictException("", doc_id, loc.version, version)
                if version_type in ("external", "external_gt") \
                        and version <= loc.version:
                    raise VersionConflictException("", doc_id, loc.version, version)
                if version_type == "external_gte" and version < loc.version:
                    raise VersionConflictException("", doc_id, loc.version, version)
            if seq_no is None:
                seq_no = self.seq.generate()
            self._remove_existing(doc_id)
            if version is not None and version_type in (
                    "external", "external_gt", "external_gte", "force"):
                new_version = version
            else:
                new_version = loc.version + 1
            self._locations[doc_id] = DocLocation(
                version=new_version, deleted=True, where=None,
                seq_no=seq_no, term=op_term)
            if not _replay:
                self._translog_append({"op": "delete", "id": doc_id,
                                       "version": new_version,
                                       "seq_no": seq_no, "term": op_term})
            self._note_op(op_term, seq_no)
            self.stats.delete_total += 1
            return new_version

    def update(self, doc_id: str, partial: Optional[dict] = None,
               script: Optional[str] = None,
               script_params: Optional[dict] = None,
               upsert: Optional[dict] = None, doc_as_upsert: bool = False,
               scripted_upsert: bool = False,
               doc_type: Optional[str] = None, routing: Optional[str] = None,
               parent: Optional[str] = None, version: Optional[int] = None,
               version_type: str = "internal",
               primary_term: Optional[int] = None) -> Tuple[int, bool]:
        """Partial update (ES 2.0's update API): merge ``partial`` into the
        current source, or run ``script`` over it, then re-index; a missing
        doc is created from ``upsert`` (through the script when
        ``scripted_upsert``) or from ``partial`` when ``doc_as_upsert``.
        Only internal versioning applies, and a versioned update of a
        missing doc is a conflict even with an upsert. ``primary_term``
        (a cluster primary's published term) rides the re-index, so a
        demoted primary's engine fences it. Returns (version, created)."""
        if version is not None and version_type != "internal":
            raise ActionRequestValidationException(
                f"version type [{version_type}] is not supported by the "
                f"update API")
        with self._lock:
            doc_id = str(doc_id)
            got = self.get(doc_id)
            if got is None:
                if version is not None:
                    raise VersionConflictException("", doc_id, -1, version)
                if upsert is not None:
                    up = dict(upsert)
                    if scripted_upsert and script is not None:
                        up = self._run_update_script(
                            script, script_params or {}, up)
                    _, v, _ = self.index(doc_id, up, doc_type=doc_type,
                                         routing=routing, parent=parent,
                                         primary_term=primary_term)
                    return v, True
                if doc_as_upsert and partial is not None:
                    _, v, _ = self.index(doc_id, partial, doc_type=doc_type,
                                         routing=routing, parent=parent,
                                         primary_term=primary_term)
                    return v, True
                raise DocumentMissingException("", doc_id)
            if version is not None and got["_version"] != version:
                raise VersionConflictException("", doc_id, got["_version"],
                                               version)
            source = dict(got["_source"])
            if script is not None:
                source = self._run_update_script(script, script_params or {},
                                                 source)
            elif partial is not None:
                _deep_merge(source, partial)
            # the stored _type, _parent and routing ride the re-index, or a
            # partial update would sever a child from its parent
            loc = self._locations.get(doc_id)
            _, v, _ = self.index(
                doc_id, source,
                routing=loc.routing if loc and loc.routing else routing,
                doc_type=loc.doc_type if loc else doc_type,
                parent=loc.parent if loc and loc.parent else parent,
                primary_term=primary_term)
            return v, False

    def _run_update_script(self, script: str, params: dict,
                           source: dict) -> dict:
        """An update script is a list of ``ctx._source.<field> = <expr>``
        statements. Each right side is compiled by ``search/scripting.py``
        with the source's current values written in as literals; groovy's
        params bind as bare names too. A tensor result becomes its Python
        value, as the reference's ``.item()`` makes one of a jnp value."""
        from elasticsearch_tpu_torch.search.scripting import compile_script

        reserved = {"doc", "params", "Math", "ctx", "_score", "_source",
                    "true", "false", "null"}
        extra = tuple(pn for pn in (params or {})
                      if pn.isidentifier() and pn not in reserved)
        for stmt in script.split(";"):
            stmt = stmt.strip()
            if not stmt:
                continue
            if "=" in stmt and "==" not in stmt.split("=", 1)[0]:
                lhs, _, rhs = stmt.partition("=")
                lhs = lhs.strip()
                prefix = "ctx._source."
                if not lhs.startswith(prefix):
                    raise ScriptException(
                        f"update script must assign ctx._source.*: [{stmt}]")
                rhs = rhs.strip()
                for fname, fval in source.items():
                    rhs = rhs.replace(f"ctx._source.{fname}", repr(fval))
                val = compile_script(rhs, extra_vars=extra).run(
                    lambda f: None, params=params)
                if hasattr(val, "item"):
                    val = val.item()
                source[lhs[len(prefix):]] = val
            else:
                raise ScriptException(
                    f"unsupported update script statement [{stmt}]")
        return source

    def _remove_existing(self, doc_id: str):
        loc = self._locations.get(doc_id)
        if loc is None or loc.deleted:
            return
        if loc.where == "buffer":
            idx = self._buffer_ids.pop(doc_id, None)
            if idx is not None:
                self.buffer.docs[idx] = None  # freeze() skips tombstones
        else:
            for seg in self.segments:
                if seg.seg_id == loc.where:
                    seg.delete_local(loc.local_id)
                    self._deletes_pending = True
                    break

    # -- read path -------------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> Optional[dict]:
        """Realtime get: buffered docs are visible before refresh."""
        with self._lock:
            self.stats.get_total += 1
            doc_id = str(doc_id)
            loc = self._locations.get(doc_id)
            if loc is None or loc.deleted:
                return None
            if loc.where == "buffer":
                if not realtime:
                    return None
                src = loc.source
            else:
                seg = next((s for s in self.segments if s.seg_id == loc.where),
                           None)
                if seg is None:
                    return None
                src = seg.sources[loc.local_id]
            return {"_id": doc_id, "_type": loc.doc_type or "_doc",
                    "_version": loc.version, "_source": src, "found": True}

    def version_of(self, doc_id: str) -> Optional[int]:
        loc = self._locations.get(str(doc_id))
        return None if loc is None or loc.deleted else loc.version

    def exists(self, doc_id: str) -> bool:
        loc = self._locations.get(str(doc_id))
        return loc is not None and not loc.deleted

    @property
    def num_docs(self) -> int:
        with self._lock:
            return sum(1 for l in self._locations.values() if not l.deleted)

    # -- lifecycle -------------------------------------------------------------

    def purge_expired(self) -> int:
        """Delete the docs whose ``_ttl`` expiry has passed (ES's TTL
        purger; here at each refresh and merge) through the ordinary
        delete path, so versions and the translog stay consistent.
        Returns how many were deleted."""
        if not self.mappings._ttl_enabled or self.failed_reason is not None:
            return 0
        now = int(time.time() * 1000)
        expired: List[str] = []
        with self._lock:
            for seg in self.segments:
                col = seg.numerics.get("_ttl")
                if col is None or col.exact is None:
                    continue
                n = seg.num_docs
                hit = np.nonzero(seg.live_host[:n] & col.exists_host[:n]
                                 & (col.exact[:n] < now))[0]
                expired.extend(seg.ids[int(i)] for i in hit)
            for d in self.buffer.docs:
                if d is not None and d.doc_values.get("_ttl") \
                        and d.doc_values["_ttl"][0] < now:
                    expired.append(d.doc_id)
            for doc_id in expired:
                try:
                    self.delete(doc_id)
                except DocumentMissingException:
                    pass
        return len(expired)

    def refresh(self, _replay: bool = False) -> bool:
        """Purge expired docs, freeze the buffer into a new searchable
        segment (NRT refresh), then run the merge check. A refresh that
        freezes nothing runs it too when segments lost docs since the
        last one, as Lucene's NRT reopen does after it applies deletes
        (the reference returns first, so its deletion-heavy segments wait
        for the next write). ``_replay`` (a committed block's replay)
        only freezes, so the committed layout comes back as it was.
        Returns whether a segment was frozen or merged."""
        with self._lock:
            if not _replay:
                self.purge_expired()
            # roots only: a root re-adds its block; a replaced root leaves
            # its nested docs behind as orphans, which go with the buffer
            live_docs = [d for d, p in zip(self.buffer.docs,
                                           self.buffer.parent_of)
                         if d is not None and p < 0]
            if not live_docs:
                pending, self._deletes_pending = self._deletes_pending, False
                return self.maybe_merge() if pending else False
            # a refresh failure is retryable, not tragic: the buffer keeps
            # the docs and a later refresh serves them
            FAULTS.check("segment.freeze", index=self.index_name)
            fresh = SegmentBuilder(self.mappings, self.residency)
            for d in live_docs:
                fresh.add(d)
            seg = fresh.freeze()
            try:
                self._charge_segment(seg)
            except CircuitBreakingException:
                # reclaim before giving up: a merge of deleted docs is the
                # one path that frees segment budget, and maybe_merge
                # otherwise runs only after a successful refresh
                self.maybe_merge()
                self._charge_segment(seg)
            self.segments.append(seg)
            for doc_id, local in seg.id_map.items():
                loc = self._locations.get(doc_id)
                if loc is not None and loc.where == "buffer":
                    loc.where = seg.seg_id
                    loc.local_id = local
                    loc.source = None
            self.buffer = SegmentBuilder(self.mappings, self.residency)
            self._buffer_ids.clear()
            if _replay:
                return True
            self.stats.refresh_total += 1
            self._deletes_pending = False
            self.maybe_merge()
            return True

    def flush(self) -> None:
        """Refresh, write the durable commit (module doc), then commit the
        translog, then drop the commit blobs no longer named. Without a
        data path there is nothing on disk: the in-memory translog
        clears."""
        from elasticsearch_tpu_torch.index.snapshots import (gc_commit,
                                                             write_commit)

        with self._lock:
            self._ensure_open()
            self.refresh()
            commit = None
            if self.commit_dir is not None:
                commit = write_commit(
                    self.commit_dir, self.segments,
                    {d: (l.version, l.seq_no, l.term)
                     for d, l in self._locations.items() if not l.deleted},
                    {d: (l.version, l.seq_no, l.term)
                     for d, l in self._locations.items() if l.deleted},
                    self.max_seq_no, self.primary_term)
            try:
                self.translog.commit()
            except OSError as e:
                # the commit point is down, so no acknowledged op is lost;
                # the engine fails as on a failed append
                self.fail(f"translog commit failed: {e}")
                raise EngineFailedException(self.index_name,
                                            self.failed_reason) from e
            if commit is not None:
                gc_commit(self.commit_dir, commit)
            self._committed_seq = self.max_seq_no
            self.stats.flush_total += 1

    def merge(self, max_segments: Optional[int] = None,
              subset: Optional[List[TpuSegment]] = None) -> bool:
        """Merge segments by re-parsing their live docs' sources into one
        new segment. With ``subset``: the policy's partial merge, whose
        output follows the segments it keeps; without: the force merge,
        every segment in order into one (nothing to do at or below
        ``max_segments``). Returns whether it merged."""
        with self._lock:
            self.purge_expired()
            if subset is None and len(self.segments) <= (max_segments or 1):
                return False
            t0 = time.perf_counter()
            targets = list(subset) if subset is not None \
                else list(self.segments)
            target_ids = {s.seg_id for s in targets}
            builder = SegmentBuilder(self.mappings, self.residency)
            for seg in targets:
                # a cancelled merge (a force merge's task) stops before the
                # freeze: nothing is swapped in, nothing is lost
                check_cancelled()
                # live roots only, each re-parsed into its whole block
                keep = seg.live_host[: seg.num_docs]
                if seg.roots_host is not None:
                    keep = keep & seg.roots_host[: seg.num_docs]
                for local in np.nonzero(keep)[0].tolist():
                    meta = seg.metas[local]
                    builder.add(self.parser.parse(
                        seg.ids[local], seg.sources[local],
                        routing=meta.get("routing"),
                        doc_type=meta.get("_type"),
                        parent=meta.get("_parent"),
                        timestamp=meta.get("timestamp"),
                        ttl_expiry=meta.get("ttl_expiry")))
            merged = builder.freeze()
            keep = [s for s in self.segments if s.seg_id not in target_ids]
            # release, then charge: a merge nets memory down, so its charge
            # is forced; only new data (a refresh) can trip the breaker
            br = self.residency.breakers.breaker("segments")
            for s in targets:
                br.release(getattr(s, "_charged", 0))
                s._charged = 0
                s.release_fielddata()
            if merged is not None:
                merged._charged = merged.memory_bytes()
                br.force(merged._charged)
                keep.append(merged)
                for doc_id, local in merged.id_map.items():
                    loc = self._locations.get(doc_id)
                    if loc is not None and not loc.deleted:
                        loc.where = merged.seg_id
                        loc.local_id = local
            self.segments[:] = keep  # in place: the searcher shares it
            self.stats.merge_total += 1
            self.stats.merge_docs += len(builder)
            self.stats.merge_time_ms += (time.perf_counter() - t0) * 1e3
            return True

    def maybe_merge(self) -> bool:
        """The merge check after a refresh (ES's maybeMerge through its
        merge scheduler; synchronous here): one policy merge at most."""
        with self._lock:
            found = self.merge_policy.find_merge(self.segments)
            return self.merge(subset=found) if found else False

    def add_segment(self, seg: TpuSegment) -> None:
        """Serve an already-built segment (index/convert.py): its docs
        join the location table at version 1."""
        with self._lock:
            self._charge_segment(seg)
            self.segments.append(seg)
            for doc_id, local in seg.id_map.items():
                if seg.live_host[local] and (seg.roots_host is None
                                             or seg.roots_host[local]):
                    self._locations[doc_id] = DocLocation(
                        version=1, where=seg.seg_id, local_id=local)

    def recover_from_commit(self) -> int:
        """Replay the durable commit, if there is one: each committed block
        is parsed into the buffer and frozen as one segment, its deleted
        docs deleted again, so the segments come back as they were
        written; each live doc keeps its version, seq no and term, and
        the tombstones their versions. The seq-no tracker advances to the
        commit's max. Returns the live docs replayed."""
        from elasticsearch_tpu_torch.index.snapshots import (commit_payloads,
                                                             read_commit)

        commit = read_commit(self.commit_dir) if self.commit_dir else None
        if commit is None:
            return 0
        docs = commit["docs"]
        n = 0
        with self._lock:
            for payload, dead in zip(commit_payloads(
                    self.commit_dir, commit, self.residency.blob_dir),
                                     commit["dead"]):
                dead = set(dead)
                for doc in payload["docs"]:
                    meta = doc.get("meta") or {}
                    parsed = self.parser.parse(
                        doc["id"], doc["source"], routing=meta.get("routing"),
                        doc_type=meta.get("_type"),
                        parent=meta.get("_parent"),
                        timestamp=meta.get("timestamp"),
                        ttl_expiry=meta.get("ttl_expiry"))
                    local = self.buffer.add(parsed)
                    if doc["id"] in dead:
                        continue
                    version, seq_no, term = docs[doc["id"]]
                    self._buffer_ids[doc["id"]] = local
                    self._locations[doc["id"]] = DocLocation(
                        version=version, where="buffer", local_id=local,
                        source=doc["source"], doc_type=meta.get("_type"),
                        parent=meta.get("_parent"),
                        routing=meta.get("routing"),
                        timestamp=parsed.meta.get("timestamp"),
                        ttl_expiry=parsed.meta.get("ttl_expiry"),
                        seq_no=seq_no, term=term)
                    self._note_op(term, seq_no)
                    n += 1
                if self.refresh(_replay=True):
                    seg = self.segments[-1]
                    for doc_id in dead:
                        seg.delete_local(seg.id_map[doc_id])
            for doc_id, (version, seq_no, term) in commit["deleted"].items():
                self._locations[doc_id] = DocLocation(
                    version=version, deleted=True, where=None,
                    seq_no=seq_no, term=term)
            self.seq.advance_to(commit["max_seq_no"])
            self.primary_term = max(self.primary_term, commit["term"])
            self._committed_seq = commit["max_seq_no"]
        return n

    def recover_from_translog(self) -> int:
        """Replay the translog; frames carry (term, seq_no), so replay
        restores the seq-no tracker and the primary term. An op whose seq
        no is at or below the commit's max is already in the commit and is
        skipped. Returns ops replayed."""
        replayed = 0
        max_term = 0
        with self._lock:
            for op in self.translog.replay():
                max_term = max(max_term, op.get("term", 0))
                seq = op.get("seq_no", UNASSIGNED_SEQ_NO)
                seq = UNASSIGNED_SEQ_NO if seq is None else seq
                if 0 <= seq <= self._committed_seq:
                    continue
                if op["op"] == "index":
                    self.index(op["id"], op["source"], routing=op.get("routing"),
                               doc_type=op.get("doc_type"),
                               parent=op.get("parent"),
                               timestamp=op.get("timestamp"),
                               ttl_expiry=op.get("ttl_expiry"), seq_no=seq,
                               primary_term=op.get("term"), _replay=True,
                               _history=True)
                    self._locations[op["id"]].version = op["version"]
                    replayed += 1
                elif op["op"] == "delete":
                    try:
                        self.delete(op["id"], seq_no=seq,
                                    primary_term=op.get("term"), _replay=True,
                                    _history=True)
                        self._locations[op["id"]].version = op["version"]
                        replayed += 1
                    except DocumentMissingException:
                        pass
            # the highest term in the log is this copy's: a promotion
            # survives a close and reopen
            self.bump_term(max_term)
        return replayed

    def apply_translog_op(self, op: dict) -> None:
        """Apply one foreign translog op (an ops-based recovery stream):
        the op's version rides ``external_gte``, so a newer state already
        here wins, and its (term, seq no) is kept. Raises
        VersionConflictException or DocumentMissingException for the
        caller to count as a skip."""
        vt = "external_gte" if op.get("version") is not None else "internal"
        if op["op"] == "delete":
            self.delete(op["id"], version=op.get("version"), version_type=vt,
                        seq_no=op.get("seq_no"), primary_term=op.get("term"),
                        _replay=True, _history=True)
            return
        self.index(op["id"], op["source"], version=op.get("version"),
                   version_type=vt, routing=op.get("routing"),
                   doc_type=op.get("doc_type"), parent=op.get("parent"),
                   timestamp=op.get("timestamp"),
                   ttl_expiry=op.get("ttl_expiry"), seq_no=op.get("seq_no"),
                   primary_term=op.get("term"), _replay=True, _history=True)

    def _charge_segment(self, seg: TpuSegment) -> None:
        """Charge a segment to the ``segments`` breaker; a denial fails
        the refresh with a typed CircuitBreakingException and the buffer
        keeps its docs."""
        br = self.residency.breakers.breaker("segments")
        n = seg.memory_bytes()
        if not br.reserve(n):
            raise CircuitBreakingException(
                f"[segments] data for new segment would be "
                f"[{br.used + n}/{br.total}] bytes, which is larger than "
                f"the limit")
        seg._charged = n

    def close(self):
        br = self.residency.breakers.breaker("segments")
        for seg in self.segments:
            br.release(getattr(seg, "_charged", 0))
            seg._charged = 0
            seg.release_fielddata()
        self.translog.close()


def _deep_merge(dst: dict, src: dict) -> None:
    """Merge ``src`` into ``dst`` in place: objects merge key by key, any
    other value replaces."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
