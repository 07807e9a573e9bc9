"""BM25, mask and top-k primitives of the slice, on tensors.

Port of the parts of elasticsearch_tpu/ops/scoring.py the single-query
host path calls. The reference's forms that exist only to suit XLA:TPU
(the scatter-free ``*_lookup`` tails, ``bm25_hybrid_candidates_topk``,
blocked ``exact_topk``, the packed single-pull result) are not ported:
on the card a scatter is an ``index_add_``.

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
