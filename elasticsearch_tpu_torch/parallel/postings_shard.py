"""The term-range split of an oversized field's postings.

Port of elasticsearch_tpu/parallel/postings_shard.py. The usual scaling
unit is the segment (segments as slots of the mesh, parallel/executor.py);
the tiered merge policy keeps segments small. This path is for what the
policy cannot help: one inverted field whose postings alone pass
``POSTINGS_SHARD_NNZ`` entries.

- The frozen term-major CSR is cut into S contiguous term ranges,
  balanced by postings mass (``build_split``: the reference's edges,
  ``bounds`` and ``bases``). A range is a slot, and the slots lie over
  the node's registries (``resources/residency.py::node_registries``),
  the reference's mesh rule: range s on registry ``s % len(registries)``.
  Each registry holds its ranges' postings as slot-stacked ``[S_m, L]``
  doc-id and tfnorm arrays, evictable ``fielddata`` handles charged to
  that registry's budget and the node's breakers; eviction and the
  segment's release (``release_fielddata``) give every charge back, and
  a touch rehydrates.
- Every scoring primitive of the term-group path (ops/scoring.py) is a
  sum of per-chunk scatter contributions, and a term's chunks lie wholly
  in its range, so the slots' partials merge exactly as the reference's
  ``psum`` does: a sum over the slots, in slot order. Scores and
  distinct-match counts add; a mask is a count above zero.
- At query time the host routes each term to its range (vocabulary ->
  term id -> range) and builds ``[S, Tb]`` chunk tables rebased into
  each range's slice. Each registry scores its ranges on its own device
  (one ``bm25_score_runs``, and ``match_count_runs`` where counts are
  asked, over its stacked arrays), every device's work queued before
  any ``[D]`` partial is copied to the field's device, where they add
  in slot order and the host loop goes on.

``build_split`` with no ``n_devices`` takes one slot a registry of the
node, so a node over one device declines as the reference does with
one device, and the host loop scores the field from its unsplit
postings; a node over ``["cpu"] * 4`` splits four ways. An explicit
``n_devices`` gives that many slots, wrapped over the registries.
Either way a field over the threshold is never stacked into the mesh's
``[S, ...]`` arrays: the mesh declines such an index to the host loop
(``mesh_fallback_total``), and its freeze keeps the postings on the host
until some path asks for the device copy (index/segment.py). Counter:
``bm25_postings_sharded``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.resources.residency import (Residency,
                                                         ResidentArray)
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

#: postings entries (doc id + tfnorm pairs) from which a field's CSR is
#: split: 64M entries, 512 MB of padded postings arrays
POSTINGS_SHARD_NNZ = int(os.environ.get("ESTPU_POSTINGS_SHARD_NNZ", 1 << 26))


class PostingsShardSplit:
    """The term-range split of one InvertedField, its slots over the
    node's registries. ``parts``: per registry that holds slots, (the
    registry, its slots in order, the doc-id and tfnorm handles of their
    stacked ``[S_m, L]`` arrays)."""

    def __init__(self, bounds: np.ndarray, bases: np.ndarray,
                 parts: List[Tuple[Residency, List[int], ResidentArray,
                                   ResidentArray]], L: int, max_docs: int,
                 vocab, offsets: np.ndarray, device: torch.device):
        self.S = int(bounds.shape[0]) - 1
        self.bounds = bounds  # i64[S+1] term-id range edges
        self.bases = bases  # i64[S] postings offset of each range start
        self.parts = parts
        self.L = L
        self.max_docs = max_docs
        self.device = device  # the field's: where the partials add
        self._vocab = vocab
        self._offsets = offsets

    def registry_of(self, s: int) -> Residency:
        return self.parts[s % len(self.parts)][0]

    def slot_arrays(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(doc ids i32[L], tfnorm f32[L]) of range s on its registry's
        device, padded with ``max_docs``."""
        _reg, slots, h_doc, h_tfn = self.parts[s % len(self.parts)]
        k = slots.index(s)
        return h_doc.get()[k], h_tfn.get()[k]

    def handles(self) -> List[ResidentArray]:
        return [h for part in self.parts for h in part[2:]]

    def close(self) -> None:
        """Give every registry's charge back (the segment's release)."""
        for h in self.handles():
            h.close()

    def chunk_tables(self, terms, weights) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray, int, int]:
        """Route the query's terms to their ranges: per-slot chunk tables
        (starts/lens i32[S, Tb], ws f32[S, Tb], P, n_present), the starts
        rebased into each slot's slice."""
        per_slot: List[List[Tuple[int, int, float]]] = [
            [] for _ in range(self.S)]
        n_present = 0
        max_run = 1
        for t, w in zip(terms, weights):
            tid = self._vocab.get(t, -1)
            if tid < 0:
                continue
            n_present += 1
            s = int(np.searchsorted(self.bounds, tid, side="right")) - 1
            start = int(self._offsets[tid] - self.bases[s])
            ln = int(self._offsets[tid + 1] - self._offsets[tid])
            if ln > 0:
                per_slot[s].append((start, ln, float(w)))
                max_run = max(max_run, ln)
        # runs chunked to a power of two P, as SegmentContext chunks them
        P = pow2_bucket(min(max_run, 1 << 14))
        chunked: List[List[Tuple[int, int, float]]] = [
            [] for _ in range(self.S)]
        for s, runs in enumerate(per_slot):
            for start, ln, w in runs:
                off = 0
                while off < ln:
                    chunked[s].append((start + off, min(P, ln - off), w))
                    off += P
        Tb = pow2_bucket(max((len(c) for c in chunked), default=1),
                         minimum=1)
        starts = np.zeros((self.S, Tb), np.int32)
        lens = np.zeros((self.S, Tb), np.int32)
        ws = np.zeros((self.S, Tb), np.float32)
        for s, cs in enumerate(chunked):
            for i, (st, ln, w) in enumerate(cs):
                starts[s, i], lens[s, i], ws[s, i] = st, ln, w
        return starts, lens, ws, P, n_present

    def term_group(self, terms, weights, with_counts: bool,
                   all_positive: bool, D: int):
        """(scores f32[D], matched, n_present) on the field's device: the
        split counterpart of ``queries._score_term_group``'s scatter
        path. ``matched`` is the i32[D] distinct-match counts with
        ``with_counts``, else a bool[D] mask."""
        from elasticsearch_tpu_torch.ops.scoring import (_upload_tables,
                                                         bm25_score_runs,
                                                         match_count_runs)

        dev = self.device
        starts, lens, ws, _P, n_present = self.chunk_tables(terms, weights)
        if n_present == 0:
            matched = torch.zeros(D, dtype=torch.int32 if with_counts
                                  else torch.bool, device=dev)
            return torch.zeros(D, dtype=torch.float32, device=dev), \
                matched, 0
        counted = with_counts or not all_positive
        score_rows: List[Optional[torch.Tensor]] = [None] * self.S
        count_rows: List[Optional[torch.Tensor]] = [None] * self.S
        # every registry's ranges scored on its device before any partial
        # leaves it
        for _reg, slots, h_doc, h_tfn in self.parts:
            doc_ids, tfnorm = h_doc.get(), h_tfn.get()
            st, ln, w, base, sizes = _upload_tables(
                doc_ids, starts[slots], lens[slots], ws[slots],
                np.arange(len(slots), dtype=np.int32))
            sc = bm25_score_runs(doc_ids, tfnorm, st, ln, w, sizes, D=D,
                                 base=base)
            cn = match_count_runs(doc_ids, st, ln, sizes, D=D,
                                  base=base) if counted else None
            for k, s in enumerate(slots):
                score_rows[s] = sc[k]
                if cn is not None:
                    count_rows[s] = cn[k]
        scores = _slot_sum(score_rows, dev)
        if counted:
            counts = _slot_sum(count_rows, dev)
            matched = counts if with_counts else counts > 0
        else:
            matched = scores > 0
        return scores, matched, n_present


def _slot_sum(rows: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The sum of the slots' [D] partials on ``dev``, in slot order (the
    reference's ``psum``)."""
    nb = dev.type == "cuda"
    out = rows[0].to(dev, non_blocking=nb, copy=True)
    for r in rows[1:]:
        out += r.to(dev, non_blocking=nb)
    return out


def build_split(inv, max_docs: int, n_devices: Optional[int] = None
                ) -> Optional[PostingsShardSplit]:
    """Cut ``inv``'s postings into balanced contiguous term ranges, one
    slot each, over the node's registries (range s on registry ``s %
    len(registries)``, charged there). ``n_devices`` slots when given,
    else one a registry of the node. None when the field has no host
    mirror or there is one slot: nothing to split over. Raises
    CircuitBreakingException when a registry cannot hold its ranges."""
    if inv.doc_ids_host is None:
        return None
    regs = inv.residency.node_registries
    S = int(n_devices) if n_devices is not None else len(regs)
    if S < 2:
        return None
    offsets = np.asarray(inv.offsets, np.int64)
    nnz = int(offsets[-1])
    V = len(offsets) - 1
    S = min(S, V)  # never more ranges than terms
    # balanced edges: the term id whose prefix mass crosses k * nnz / S
    targets = (np.arange(1, S) * nnz) // S
    cut = np.searchsorted(offsets, targets, side="left")
    bounds = np.concatenate([[0], cut, [V]]).astype(np.int64)
    bounds = np.maximum.accumulate(bounds)  # degenerate ranges stay valid
    bases = offsets[bounds[:-1]]
    sizes = offsets[bounds[1:]] - bases
    L = pow2_bucket(int(sizes.max()), minimum=8)
    doc_ids = np.full((S, L), max_docs, np.int32)  # sentinel pad
    tfnorm = np.zeros((S, L), np.float32)
    tfn_host = (inv.tfnorm_host if inv.tfnorm_host is not None
                else np.ones(nnz, np.float32))
    for s in range(S):
        lo, hi = int(bases[s]), int(offsets[bounds[s + 1]])
        doc_ids[s, : hi - lo] = inv.doc_ids_host[lo:hi]
        tfnorm[s, : hi - lo] = tfn_host[lo:hi]
    M = min(S, len(regs))
    parts: list = []
    try:
        for m in range(M):
            slots = list(range(m, S, M))
            reg = regs[m]
            h_doc = reg.put_array(doc_ids[slots], label="pshard.doc_ids")
            parts.append((reg, slots, h_doc, None))
            h_tfn = reg.put_array(tfnorm[slots], label="pshard.tfnorm")
            parts[-1] = (reg, slots, h_doc, h_tfn)
    except BaseException:
        for part in parts:
            for h in part[2:]:
                if h is not None:
                    h.close()
        raise
    return PostingsShardSplit(bounds, bases, parts, L, max_docs, inv.vocab,
                              offsets, inv.residency.device)
