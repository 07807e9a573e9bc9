"""BM25, mask and top-k primitives of the slice, on tensors.

Port of the parts of elasticsearch_tpu/ops/scoring.py the single-query
host path calls. The reference's forms that exist only to suit XLA:TPU
(the scatter-free ``*_lookup`` tails, ``bm25_hybrid_candidates_topk``,
blocked ``exact_topk``, the packed single-pull result) are not ported:
on the card a scatter is an ``index_add_``.

The ``*_slots`` forms serve the mesh path (``parallel/``): the same
arithmetic over S slots at once, postings ``[S, NNZ]`` and chunk tables
``[S, T]``, each slot's scatter going to its own ``D + 1`` row of one
flat buffer, one ``index_add_`` per chunk position for all slots. A
doc's sum runs in the same chunk order as the per-segment form, so the
two agree bit for bit.

Postings windows: a query term's run is a ``(start, len)`` chunk of the
segment's padded CSR; ``P`` is the window width (>= every chunk length)
and ``D`` the segment's ``max_docs``. Scatters go into a ``D + 1`` buffer
whose last slot swallows padding and invalid window entries, then are
sliced back to ``D``. Each chunk is one ``index_add_`` (a doc occurs at
most once in a chunk), so a doc's sum runs in chunk order, deterministic
on the card as on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

NEG_INF = float("-inf")

DENSE_ROW_PAD = 8  # kernel sublane multiple; pack_dense_rows pads R to it


def _windows(doc_ids, starts, lens, P: int, D: int):
    """(docs i64[T, P], pos i64[T, P], valid bool[T, P]) for the postings
    windows; invalid entries point at doc D."""
    dev = doc_ids.device
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    lens = torch.as_tensor(lens, dtype=torch.int64, device=dev)
    ar = torch.arange(P, dtype=torch.int64, device=dev)
    valid = ar[None, :] < lens[:, None]
    pos = torch.clamp(starts[:, None] + ar[None, :], max=doc_ids.shape[0] - 1)
    docs = torch.where(valid, doc_ids[pos].to(torch.int64),
                       torch.full_like(pos, D))
    return docs, pos, valid


def _scatter_sum(docs, contrib, D: int):
    out = torch.zeros(D + 1, dtype=contrib.dtype, device=contrib.device)
    for t in range(docs.shape[0]):
        out.index_add_(0, docs[t], contrib[t])
    return out[:D]


def bm25_score_segment(doc_ids, tfnorm, starts, lens, weights, *, P: int,
                       D: int):
    """f32[D] BM25 scores: sum over chunks of tfnorm * weight at each
    posting (0 for non-matching docs)."""
    docs, pos, valid = _windows(doc_ids, starts, lens, P, D)
    w = torch.as_tensor(weights, dtype=torch.float32, device=doc_ids.device)
    contrib = torch.where(valid, tfnorm[pos] * w[:, None],
                          torch.zeros((), device=doc_ids.device))
    return _scatter_sum(docs, contrib, D)


def match_count_segment(doc_ids, starts, lens, *, P: int, D: int):
    """i32[D] count of matching query terms per doc (a doc occurs at most
    once in a term's run, so split chunks still count it once)."""
    docs, _, valid = _windows(doc_ids, starts, lens, P, D)
    return _scatter_sum(docs, valid.to(torch.int32), D)


def term_mask(doc_ids, starts, lens, *, P: int, D: int):
    """bool[D]: docs containing ANY of the chunks."""
    return match_count_segment(doc_ids, starts, lens, P=P, D=D) > 0


def _windows_slots(doc_ids, starts, lens, P: int, D: int):
    """(flat i64[S, T, P], pos i64[S, T, P], valid bool[S, T, P]):
    ``_windows`` per slot, with slot s's doc d at flat index
    s * (D + 1) + d and invalid entries at s * (D + 1) + D."""
    S, nnz = doc_ids.shape
    dev = doc_ids.device
    ar = torch.arange(P, dtype=torch.int64, device=dev)
    valid = ar < lens.to(torch.int64).unsqueeze(2)
    pos = torch.clamp(starts.to(torch.int64).unsqueeze(2) + ar, max=nnz - 1)
    docs = torch.gather(doc_ids, 1, pos.view(S, -1)).view(pos.shape)
    base = torch.arange(0, S * (D + 1), D + 1, dtype=torch.int64,
                        device=dev).view(S, 1, 1)
    return torch.where(valid, docs + base, base + D), pos, valid


def _scatter_sum_slots(flat, contrib, D: int):
    """Chunk position t of every slot in one ``index_add_``, t in order."""
    S, T = flat.shape[:2]
    out = torch.zeros(S * (D + 1), dtype=contrib.dtype, device=contrib.device)
    for f, c in zip(flat.transpose(0, 1).reshape(T, -1).unbind(0),
                    contrib.transpose(0, 1).reshape(T, -1).unbind(0)):
        out.index_add_(0, f, c)
    return out.view(S, D + 1)[:, :D]


def bm25_score_slots(doc_ids, tfnorm, starts, lens, weights, *, P: int,
                     D: int):
    """f32[S, D]: ``bm25_score_segment`` of each slot."""
    flat, pos, valid = _windows_slots(doc_ids, starts, lens, P, D)
    tf = torch.gather(tfnorm, 1, pos.view(pos.shape[0], -1)).view(pos.shape)
    contrib = torch.where(valid, tf * weights.unsqueeze(2),
                          torch.zeros((), device=doc_ids.device))
    return _scatter_sum_slots(flat, contrib, D)


def match_count_slots(doc_ids, starts, lens, *, P: int, D: int):
    """i32[S, D]: ``match_count_segment`` of each slot."""
    flat, _, valid = _windows_slots(doc_ids, starts, lens, P, D)
    return _scatter_sum_slots(flat, valid.to(torch.int32), D)


def term_mask_slots(doc_ids, starts, lens, *, P: int, D: int):
    """bool[S, D]: ``term_mask`` of each slot."""
    return match_count_slots(doc_ids, starts, lens, P=P, D=D) > 0


def pack_dense_rows(row_w: dict):
    """(qrows i32[R], qrw f32[R]) from {dense_row: weight}: sorted rows,
    -1/0 padding, R = pow2(len) >= DENSE_ROW_PAD (host numpy)."""
    R = pow2_bucket(max(len(row_w), 1), minimum=DENSE_ROW_PAD)
    qrows = np.full(R, -1, np.int32)
    qrw = np.zeros(R, np.float32)
    for i, (row, w) in enumerate(sorted(row_w.items())):
        qrows[i] = row
        qrw[i] = w
    return qrows, qrw


def _rows(dense_impact, qrows):
    idx = torch.clamp(torch.as_tensor(qrows, dtype=torch.int64,
                                      device=dense_impact.device), min=0)
    return dense_impact.index_select(0, idx)


def gather_impact_rows(dense_impact, qrows):
    """(impact[qrows] [R, D], valid f32[R]): padding rows (-1) clamp to
    row 0 and carry validity 0."""
    q = torch.as_tensor(qrows, dtype=torch.int64, device=dense_impact.device)
    return _rows(dense_impact, q), (q >= 0).to(torch.float32)


def bm25_score_hybrid_gather(dense_impact, qrows, qrw, doc_ids, tfnorm,
                             starts, lens, weights, *, P: int, D: int):
    """f32[D] hybrid BM25 reading only the query's dense rows: an f32
    sum over the R gathered rows (in row order) plus the CSR tail."""
    rows = _rows(dense_impact, qrows)
    w = torch.as_tensor(qrw, dtype=torch.float32, device=rows.device)
    dense = torch.zeros(D, dtype=torch.float32, device=rows.device)
    for r in range(rows.shape[0]):
        dense = dense + w[r] * rows[r]
    return dense + bm25_score_segment(doc_ids, tfnorm, starts, lens, weights,
                                      P=P, D=D)


def _dense_present(dense_impact, qrows):
    q = torch.as_tensor(qrows, dtype=torch.int64, device=dense_impact.device)
    return (_rows(dense_impact, q) != 0) & (q >= 0)[:, None]  # [R, D]


def match_count_hybrid_gather(dense_impact, qrows, doc_ids, starts, lens,
                              *, P: int, D: int):
    """i32[D] matched-term counts: gathered dense presence + CSR tail."""
    dcount = _dense_present(dense_impact, qrows).sum(0, dtype=torch.int32)
    return dcount + match_count_segment(doc_ids, starts, lens, P=P, D=D)


def term_mask_hybrid_gather(dense_impact, qrows, doc_ids, starts, lens, *,
                            P: int, D: int):
    """bool[D] any-term mask: gathered dense presence | CSR tail."""
    return (_dense_present(dense_impact, qrows).any(0)
            | term_mask(doc_ids, starts, lens, P=P, D=D))


def dense_presence_count(impact, qind, live) -> int:
    """Exact hit count of a pure-dense term group: docs where ANY row with
    indicator qind[0, r] > 0 has a non-zero impact, ANDed with live."""
    sel = qind[0] > 0
    present = ((impact != 0) & sel[:, None]).any(0) & live
    return int(present.sum())


def range_mask_f32(values, exists, lo: float, hi: float, include_lo: bool,
                   include_hi: bool):
    """Range filter over an f32 column (lo/hi +-inf when open)."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=values.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=values.device)
    ge = values >= lo_t if include_lo else values > lo_t
    le = values <= hi_t if include_hi else values < hi_t
    return ge & le & exists


def range_mask_i64pair(hi_col, lo_col, exists, lo_hi: int, lo_lo: int,
                       hi_hi: int, hi_lo: int, include_lo: bool,
                       include_hi: bool):
    """Exact 64-bit range over (hi, lo) int32 pair columns."""
    def ge(ah, al, bh, bl):
        return (ah > bh) | ((ah == bh) & (al >= bl))

    def gt(ah, al, bh, bl):
        return (ah > bh) | ((ah == bh) & (al > bl))

    lower = (ge if include_lo else gt)(hi_col, lo_col, lo_hi, lo_lo)
    upper = (ge if include_hi else gt)(hi_hi, hi_lo, hi_col, lo_col)
    return lower & upper & exists


def topk_with_mask(scores, mask, *, k: int):
    """(values f32[k], indices i32[k]) of the top-k masked scores, ordered
    by (-value, index) like ``lax.top_k``; masked-out docs get -inf."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def count_mask(mask) -> int:
    return int(mask.sum())
