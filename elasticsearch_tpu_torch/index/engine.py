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
is the force merge. Updates, TTL purging, peer recovery and replication
are not in the slice yet (ROADMAP A10).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.doc_parser import DocumentParser
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.merge import TieredMergePolicy
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, TpuSegment
from elasticsearch_tpu_torch.index.seqno import (NO_OPS_PERFORMED,
                                                 UNASSIGNED_SEQ_NO,
                                                 LocalCheckpointTracker)
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils.errors import (CircuitBreakingException,
                                                  DocumentMissingException,
                                                  EngineFailedException,
                                                  VersionConflictException)


@dataclass
class DocLocation:
    version: int
    deleted: bool = False
    # "buffer" or a segment id; buffer docs re-resolve on refresh
    where: Any = "buffer"
    local_id: int = -1
    source: Optional[dict] = None  # for realtime get of buffered docs
    doc_type: Optional[str] = None
    routing: Optional[str] = None
    seq_no: int = UNASSIGNED_SEQ_NO
    term: int = 0


@dataclass
class EngineStats:
    index_total: int = 0
    delete_total: int = 0
    get_total: int = 0
    refresh_total: int = 0
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
        self.buffer = SegmentBuilder(mappings, residency)
        self.segments: List[TpuSegment] = []
        self._locations: Dict[str, DocLocation] = {}
        self._buffer_ids: Dict[str, int] = {}
        self._lock = threading.RLock()
        self.stats = EngineStats()
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

    def _note_op(self, term: int, seq_no: int) -> None:
        if seq_no < 0:
            return
        self.seq.mark_processed(seq_no)
        if seq_no > self._term_seq.get(term, NO_OPS_PERFORMED):
            self._term_seq[term] = seq_no

    # -- tragic events -----------------------------------------------------------

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
            self.failed_reason = f"translog append failed: {e}"
            raise EngineFailedException(self.index_name,
                                        self.failed_reason) from e

    # -- write path ------------------------------------------------------------

    def index(self, doc_id: Optional[str], source: dict,
              version: Optional[int] = None, version_type: str = "internal",
              op_type: str = "index", routing: Optional[str] = None,
              doc_type: Optional[str] = None, seq_no: Optional[int] = None,
              primary_term: Optional[int] = None,
              _replay: bool = False) -> Tuple[str, int, bool]:
        """Index/create a document. Returns (id, new_version, created).

        Internal versioning requires the given version to equal the
        current one; external requires it to be strictly greater (gte
        allows equal). op_type=create fails if the doc exists."""
        t0 = time.perf_counter()
        with self._lock:
            self._ensure_open()
            op_term = self.primary_term if primary_term is None else primary_term
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
                                       doc_type=doc_type)
            # seq no after validation: a rejected op consumes no number
            if seq_no is None:
                seq_no = self.seq.generate()
            self._remove_existing(doc_id)
            self._buffer_ids[doc_id] = self.buffer.add(parsed)
            self._locations[doc_id] = DocLocation(
                version=new_version, where="buffer",
                local_id=self._buffer_ids[doc_id], source=source,
                doc_type=doc_type, routing=routing, seq_no=seq_no,
                term=op_term)
            if not _replay:
                entry = {"op": "index", "id": doc_id, "source": source,
                         "version": new_version, "routing": routing,
                         "seq_no": seq_no, "term": op_term}
                if doc_type:
                    entry["doc_type"] = doc_type
                self._translog_append(entry)
            self._note_op(op_term, seq_no)
            self.stats.index_total += 1
            return doc_id, new_version, not exists

    def delete(self, doc_id: str, version: Optional[int] = None,
               version_type: str = "internal", seq_no: Optional[int] = None,
               primary_term: Optional[int] = None,
               _replay: bool = False) -> int:
        with self._lock:
            self._ensure_open()
            op_term = self.primary_term if primary_term is None else primary_term
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

    @property
    def num_docs(self) -> int:
        with self._lock:
            return sum(1 for l in self._locations.values() if not l.deleted)

    # -- lifecycle -------------------------------------------------------------

    def refresh(self) -> bool:
        """Freeze the buffer into a new searchable segment (NRT refresh),
        then run the merge check. A refresh that freezes nothing runs it
        too when segments lost docs since the last one, as Lucene's NRT
        reopen does after it applies deletes (the reference returns
        first, so its deletion-heavy segments wait for the next write).
        Returns whether a segment was frozen or merged."""
        with self._lock:
            live_docs = [d for d in self.buffer.docs if d is not None]
            if not live_docs:
                pending, self._deletes_pending = self._deletes_pending, False
                return self.maybe_merge() if pending else False
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
            self.stats.refresh_total += 1
            self._deletes_pending = False
            self.maybe_merge()
            return True

    def merge(self, max_segments: Optional[int] = None,
              subset: Optional[List[TpuSegment]] = None) -> bool:
        """Merge segments by re-parsing their live docs' sources into one
        new segment. With ``subset``: the policy's partial merge, whose
        output follows the segments it keeps; without: the force merge,
        every segment in order into one (nothing to do at or below
        ``max_segments``). Returns whether it merged."""
        with self._lock:
            if subset is None and len(self.segments) <= (max_segments or 1):
                return False
            t0 = time.perf_counter()
            targets = list(subset) if subset is not None \
                else list(self.segments)
            target_ids = {s.seg_id for s in targets}
            builder = SegmentBuilder(self.mappings, self.residency)
            for seg in targets:
                live = seg.live_host
                for local, doc_id in enumerate(seg.ids):
                    if live[local]:
                        loc = self._locations[doc_id]
                        builder.add(self.parser.parse(
                            doc_id, seg.sources[local], routing=loc.routing,
                            doc_type=loc.doc_type))
            merged = builder.freeze()
            keep = [s for s in self.segments if s.seg_id not in target_ids]
            # release, then charge: a merge nets memory down, so its charge
            # is forced; only new data (a refresh) can trip the breaker
            br = self.residency.breakers.breaker("segments")
            for s in targets:
                br.release(getattr(s, "_charged", 0))
                s._charged = 0
                self.residency.release(s.fielddata_bytes())
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
                if seg.live_host[local]:
                    self._locations[doc_id] = DocLocation(
                        version=1, where=seg.seg_id, local_id=local)

    def recover_from_translog(self) -> int:
        """Replay the translog; frames carry (term, seq_no), so replay
        restores the seq-no tracker and the primary term. Returns ops
        replayed."""
        replayed = 0
        max_term = 0
        with self._lock:
            for op in self.translog.replay():
                max_term = max(max_term, op.get("term", 0))
                seq = op.get("seq_no", UNASSIGNED_SEQ_NO)
                seq = UNASSIGNED_SEQ_NO if seq is None else seq
                if op["op"] == "index":
                    self.index(op["id"], op["source"], routing=op.get("routing"),
                               doc_type=op.get("doc_type"), seq_no=seq,
                               primary_term=op.get("term"), _replay=True)
                    self._locations[op["id"]].version = op["version"]
                    replayed += 1
                elif op["op"] == "delete":
                    try:
                        self.delete(op["id"], seq_no=seq,
                                    primary_term=op.get("term"), _replay=True)
                        self._locations[op["id"]].version = op["version"]
                        replayed += 1
                    except DocumentMissingException:
                        pass
            self.primary_term = max(self.primary_term, max_term)
        return replayed

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
            self.residency.release(seg.fielddata_bytes())
        self.translog.close()
