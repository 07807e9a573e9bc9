"""The term-range split of an oversized field's postings.

Port of elasticsearch_tpu/parallel/postings_shard.py. The usual scaling
unit is the segment (segments as slots of the mesh, parallel/executor.py);
the tiered merge policy keeps segments small. This path is for what the
policy cannot help: one inverted field whose postings alone pass
``POSTINGS_SHARD_NNZ`` entries.

- The frozen term-major CSR is cut into S contiguous term ranges,
  balanced by postings mass (``build_split``: the reference's edges,
  ``bounds`` and ``bases``). A range is a slot, as in the port's mesh
  (parallel/mesh.py): range s's postings are row s of slot-stacked
  ``[S, L]`` doc-id and tfnorm arrays, on the field's device.
- Every scoring primitive of the term-group path (ops/scoring.py) is a
  sum of per-chunk scatter contributions, and a term's chunks lie wholly
  in its range, so the slots' partials merge exactly as the reference's
  ``psum`` does: a sum over the slot dimension, in slot order. Scores and
  distinct-match counts add; a mask is a count above zero.
- At query time the host routes each term to its range (vocabulary ->
  term id -> range) and builds ``[S, Tb]`` chunk tables rebased into
  each range's slice; one ``bm25_score_batch`` over the slot-stacked
  arrays gives the ``[S, D]`` partials.

The reference splits over its devices; the port's slots share the
field's own device (a node over several devices places each segment on
its shard's; the split across cards is queued, ROADMAP A).
``build_split`` with no ``n_devices`` takes the card count, so on one
card (or on the CPU) it declines as the reference does with one device,
and the host loop scores the field from its unsplit postings. An
explicit ``n_devices`` gives that many slots on the field's device.
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

from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

#: postings entries (doc id + tfnorm pairs) from which a field's CSR is
#: split: 64M entries, 512 MB of padded postings arrays
POSTINGS_SHARD_NNZ = int(os.environ.get("ESTPU_POSTINGS_SHARD_NNZ", 1 << 26))


class PostingsShardSplit:
    """The term-range split of one InvertedField, its slots stacked on
    the field's device."""

    def __init__(self, bounds: np.ndarray, bases: np.ndarray,
                 doc_ids_sh: torch.Tensor, tfnorm_sh: torch.Tensor, L: int,
                 max_docs: int, vocab, offsets: np.ndarray):
        self.S = int(bounds.shape[0]) - 1
        self.bounds = bounds  # i64[S+1] term-id range edges
        self.bases = bases  # i64[S] postings offset of each range start
        self.doc_ids_sh = doc_ids_sh  # i32[S, L], padded with max_docs
        self.tfnorm_sh = tfnorm_sh  # f32[S, L]
        self.L = L
        self.max_docs = max_docs
        self._vocab = vocab
        self._offsets = offsets

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
        """(scores f32[D], matched, n_present): the split counterpart of
        ``queries._score_term_group``'s scatter path. ``matched`` is the
        i32[D] distinct-match counts with ``with_counts``, else a bool[D]
        mask."""
        from elasticsearch_tpu_torch.ops.scoring import (_upload_tables,
                                                         bm25_score_runs,
                                                         match_count_runs)

        dev = self.doc_ids_sh.device
        starts, lens, ws, _P, n_present = self.chunk_tables(terms, weights)
        if n_present == 0:
            matched = torch.zeros(D, dtype=torch.int32 if with_counts
                                  else torch.bool, device=dev)
            return torch.zeros(D, dtype=torch.float32, device=dev), \
                matched, 0
        st, ln, w, base, sizes = _upload_tables(
            self.doc_ids_sh, starts, lens, ws,
            np.arange(self.S, dtype=np.int32))
        scores = _slot_sum(bm25_score_runs(
            self.doc_ids_sh, self.tfnorm_sh, st, ln, w, sizes, D=D,
            base=base))
        if with_counts or not all_positive:
            counts = _slot_sum(match_count_runs(
                self.doc_ids_sh, st, ln, sizes, D=D, base=base))
            matched = counts if with_counts else counts > 0
        else:
            matched = scores > 0
        return scores, matched, n_present


def _slot_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum over the slot dimension of [S, D] partials, in slot order
    (the reference's ``psum``)."""
    out = parts[0].clone()
    for s in range(1, parts.shape[0]):
        out += parts[s]
    return out


def build_split(inv, max_docs: int, n_devices: Optional[int] = None
                ) -> Optional[PostingsShardSplit]:
    """Cut ``inv``'s postings into balanced contiguous term ranges, one
    slot each, on the field's device. ``n_devices`` slots when given,
    else one per card (``torch.cuda.device_count()``; one on the CPU).
    None when the field has no host mirror or there is one slot: nothing
    to split over."""
    if inv.doc_ids_host is None:
        return None
    device = inv.residency.device
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
    S = int(n_devices)
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
    put = inv.residency.device_put
    return PostingsShardSplit(bounds, bases, put(doc_ids), put(tfnorm), L,
                              max_docs, inv.vocab, offsets)
