"""IVF approximate kNN: k-means coarse quantizer, inverted lists, probes.

Port of elasticsearch_tpu/ops/ivf.py. A build trains C centroids over a
segment's live vectors and buckets every vector into the padded
``lists[C, Lmax]`` of its nearest centroid (padding = the ``max_docs``
sentinel). A query probes the ``nprobe`` lists closest to it, with
nprobe sized so the probed lists cover about ``num_candidates`` vectors,
and scores only their vectors. With a PQ tier (``ops/pq.py``) the probed
candidates are ranked first by ADC table-sums over their uint8 codes
(kernel B3, ``ops/adc.py``) and only the top ``fine_k`` pay the exact f32
re-rank.

Everything is plain PyTorch on the tensors' device. The build is
deterministic, so a freeze replays identically: assignments come from
one argmax per chunk of rows, and cluster sums from a one-hot matrix
product per chunk, summed over the chunks in order (``index_add_`` with
float atomics would not be). Every selection among equal scores takes
the lower position, ``lax.top_k``'s rule, by a stable sort.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor.programs import REGISTRY, static_sig
from elasticsearch_tpu_torch.ops.adc import adc_scores
from elasticsearch_tpu_torch.ops.bitvec import test_bits
from elasticsearch_tpu_torch.ops.knn import knn_scores
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

#: elements of one [rows, C] affinity or one-hot block (256 MB of f32)
_BLOCK_ELEMS = 1 << 26


def _quantizer_affinity(vecs: torch.Tensor, cents: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """[N, C] affinity used for both k-means assignment and query-time
    probing: argmax picks the nearest centroid under the field's
    similarity. l2 uses the norm expansion (argmin |v-c|^2 == argmax
    v.c - |c|^2 / 2); cosine and dot take the dot with the centroid's
    direction (spherical k-means)."""
    if metric in ("l2_norm", "l2"):
        return vecs @ cents.T - 0.5 * torch.sum(cents * cents, dim=-1)[None, :]
    cn = cents / torch.clamp(
        torch.linalg.vector_norm(cents, dim=-1, keepdim=True), min=1e-12)
    return vecs @ cn.T


def top_positions(x: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the n largest entries of a 1-D tensor, lower position
    first among equals (``lax.top_k``'s order)."""
    return torch.sort(x, descending=True, stable=True).indices[:n]


def _rows_per_block(C: int) -> int:
    return max(1024, _BLOCK_ELEMS // max(C, 1))


def _assign(vecs: torch.Tensor, cents: torch.Tensor,
            metric: str) -> torch.Tensor:
    """i64[N]: nearest centroid of every row (first one among equals),
    over blocks of rows so the [N, C] affinity never exists whole."""
    N = vecs.shape[0]
    out = torch.empty(N, dtype=torch.int64, device=vecs.device)
    step = _rows_per_block(cents.shape[0])
    for s in range(0, N, step):
        out[s:s + step] = torch.argmax(
            _quantizer_affinity(vecs[s:s + step], cents, metric), dim=1)
    return out


def _cluster_sums(vecs: torch.Tensor, assign: torch.Tensor, C: int):
    """(f32[C, dims] sums, i64[C] counts) of the rows per cluster, the
    sums as one-hot [C, rows] @ [rows, dims] products over blocks of rows
    in order: deterministic, unlike float atomics."""
    counts = torch.bincount(assign, minlength=C)
    sums = torch.zeros(C, vecs.shape[1], dtype=torch.float32,
                       device=vecs.device)
    labels = torch.arange(C, device=vecs.device)[:, None]
    step = _rows_per_block(C)
    for s in range(0, vecs.shape[0], step):
        onehot = (assign[None, s:s + step] == labels).to(torch.float32)
        sums = sums + onehot @ vecs[s:s + step]
    return sums, counts


def kmeans(vecs: torch.Tensor, C: int, iters: int = 8,
           metric: str = "cosine"):
    """Train C centroids over vecs f32[N, dims] on their device.

    Deterministic: the initial centroids are an evenly strided sample of
    the rows; a cluster that goes empty keeps its old centroid. Returns
    (centroids f32[C, dims], assign i64[N]), ``assign`` being one final
    pass against the final centroids, so the lists agree with the
    quantizer probed at query time."""
    vecs = vecs.to(torch.float32).contiguous()
    N = vecs.shape[0]
    C = min(C, N)
    stride = max(N // C, 1)
    cents = vecs[::stride][:C].clone()
    for _ in range(iters):
        assign = _assign(vecs, cents, metric)
        sums, counts = _cluster_sums(vecs, assign, C)
        new = sums / torch.clamp(counts, min=1).to(torch.float32)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents, _assign(vecs, cents, metric)


@dataclass
class IvfIndex:
    centroids: Any  # f32[C, dims]
    lists: Any  # i32[C, Lmax] doc ids, padded with `sentinel`
    list_lens: Any  # i32[C]
    C: int
    Lmax: int
    sentinel: int  # = max_docs of the owning segment
    avg_len: float
    metric: str = "cosine"  # quantizer metric (follows the field similarity)

    @property
    def ntotal(self) -> int:
        """Indexed vector count (avg_len is n / C at build time)."""
        return max(int(round(self.avg_len * self.C)), 1)

    def nprobe_for(self, num_candidates: int) -> int:
        """nprobe such that the probed lists cover about num_candidates
        vectors, num_candidates clamped to [1, ntotal] first; in [1, C]."""
        nc = min(max(int(num_candidates), 1), self.ntotal)
        n = int(np.ceil(nc / max(self.avg_len, 1.0)))
        return max(1, min(n, self.C))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.centroids, self.lists, self.list_lens))


def build_ivf(vecs: torch.Tensor, exists: torch.Tensor, max_docs: int,
              C: Optional[int] = None, metric: str = "cosine",
              place=None) -> Optional[IvfIndex]:
    """An IVF index over the live vectors of one segment slab, built on
    the slab's device; ``place`` (a tensor -> tensor placement, default
    none) puts its three tensors where they live. None below 64 live
    vectors, where brute force is better."""
    ids = torch.nonzero(exists).flatten()
    n = int(ids.numel())
    if n < 64:
        return None
    if C is None:
        C = int(max(8, min(4 * np.sqrt(n), n // 8)))
    cents, assign = kmeans(vecs[ids], C, metric=metric)
    C = int(cents.shape[0])
    counts = torch.bincount(assign, minlength=C)
    Lmax = pow2_bucket(int(counts.max()))
    # ids ascend, so a stable sort by cluster keeps each list in id order
    order = torch.sort(assign, stable=True).indices
    grouped = assign[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=ids.device) - starts[grouped]
    lists = torch.full((C, Lmax), max_docs, dtype=torch.int32,
                       device=ids.device)
    lists[grouped, pos] = ids[order].to(torch.int32)
    put = place if place is not None else (lambda t: t)
    return IvfIndex(centroids=put(cents), lists=put(lists),
                    list_lens=put(counts.to(torch.int32)), C=C, Lmax=Lmax,
                    sentinel=max_docs, avg_len=float(n) / C, metric=metric)


def _scatter(D: int, ids: torch.Tensor, scores: torch.Tensor,
             valid: torch.Tensor):
    """(f32[D] scores, -inf elsewhere; bool[D] mask) from candidate
    (id, score) pairs. The reference drops invalid pairs, whose ids may
    be the out-of-range sentinel, by ``mode="drop"``; ``scatter_reduce_``
    would raise on them, so they go to doc 0 as (-inf, False), which
    leaves doc 0 as it is under the max."""
    dev = scores.device
    tgt = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    out = torch.full((D,), float("-inf"), dtype=torch.float32, device=dev)
    out.scatter_reduce_(0, tgt, torch.where(
        valid, scores, torch.full_like(scores, float("-inf"))), reduce="amax")
    mask = torch.zeros(D, dtype=torch.float32, device=dev).scatter_reduce_(
        0, tgt, valid.to(torch.float32), reduce="amax") > 0
    return out, mask


def _probe(index: IvfIndex, query: torch.Tensor, nprobe: int):
    """cand i32[nprobe * Lmax]: the nprobe closest lists under the
    quantizer's metric, padded with the sentinel."""
    csim = _quantizer_affinity(query[None, :], index.centroids,
                               index.metric)[0]
    return index.lists[top_positions(csim, nprobe)].reshape(-1)


def _admitted(cand: torch.Tensor, D: int):
    """(valid bool, safe i64 ids: padding at 0) of probed candidates."""
    valid = cand < D
    return valid, torch.where(valid, cand, torch.zeros_like(cand)).to(
        torch.int64)


def ivf_search(index: IvfIndex, query: torch.Tensor, vecs: torch.Tensor,
               nprobe: int, metric: str, D: int):
    """IVF-flat: probe, then the exact f32 metric on every probed
    candidate (reference ``make_ivf_search``)."""
    cand = _probe(index, query, nprobe)
    valid, safe = _admitted(cand, D)
    cs = knn_scores(query[None, :], vecs[safe], metric=metric)[0]
    return _scatter(D, cand, cs, valid)


def ivf_pq_search(index: IvfIndex, query: torch.Tensor, vecs: torch.Tensor,
                  nprobe: int, metric: str, D: int, pq=None,
                  fine_k: int = 64, filter_words=None):
    """Coarse -> fine IVF (reference ``make_ivf_pq_search``): probe; drop
    candidates the packed pre-filter rejects; rank the rest by ADC over
    their PQ codes (kernel B3, which reads the probed candidates' codes
    out of the whole code table and gives padding and filtered slots
    -inf itself); re-score the top ``fine_k`` exactly in f32. Without
    ``pq`` every admitted candidate is scored exactly."""
    cand = _probe(index, query, nprobe)
    if pq is not None:
        from elasticsearch_tpu_torch.ops.pq import adc_lut

        lut = adc_lut(query, pq.codebooks, pq.metric)
        # the codes hold one row per doc of the segment: ids >= D are pads
        coarse = adc_scores(pq.codes_dev()[:D], lut, cand=cand,
                            filter_words=filter_words)
        fpos = top_positions(coarse, fine_k)
        fv = coarse[fpos]
        fids = cand[fpos]
        fvalid = fv > float("-inf")
        fsafe = torch.where(fvalid, fids, torch.zeros_like(fids))
        fscores = knn_scores(query[None, :], vecs[fsafe.to(torch.int64)],
                             metric=metric)[0]
    else:
        valid, safe = _admitted(cand, D)
        if filter_words is not None:
            valid = valid & test_bits(filter_words, safe)
        fids, fvalid = cand, valid
        fscores = knn_scores(query[None, :], vecs[safe], metric=metric)[0]
    return _scatter(D, fids, fscores, fvalid)


def ivf_candidate_scores(index: IvfIndex, vecs: torch.Tensor, query,
                         num_candidates: int, metric: str, D: int,
                         pq=None, fine_k: Optional[int] = None,
                         filter_words=None):
    """Whole-segment (f32[D] scores, -inf elsewhere; bool[D] mask) of the
    IVF candidates of one query, the contract every query node keeps.

    Without ``pq`` and filter: IVF-flat. Otherwise the coarse -> fine
    pipeline with ``fine_k`` survivors (default 64) and the optional
    packed pre-filter ``filter_words`` (``ops/bitvec.pack_mask``).

    The dispatch is in flight (monitor/programs.py) until the card has
    finished it: the result has no copy back of its own (the query node
    reads it later), so the bracket ends waiting on the stream."""
    nprobe = index.nprobe_for(num_candidates)
    q = torch.as_tensor(np.asarray(query, np.float32), device=vecs.device)
    if pq is None and filter_words is None:
        with REGISTRY.timed("ivf_search", static_sig(
                C=index.C, Lmax=index.Lmax, D=D, nprobe=nprobe)):
            out = ivf_search(index, q, vecs, nprobe, metric, D)
            _settle(vecs.device)
        return out
    W = nprobe * index.Lmax
    fk = max(1, min(int(fine_k or 64), W, D))
    with REGISTRY.timed(
            "ivf_pq_search" if pq is not None else "ivf_search",
            static_sig(C=index.C, Lmax=index.Lmax, D=D, nprobe=nprobe,
                       fk=fk, filtered=filter_words is not None)):
        out = ivf_pq_search(index, q, vecs, nprobe, metric, D, pq=pq,
                            fine_k=fk, filter_words=filter_words)
        _settle(vecs.device)
    return out


def _settle(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
