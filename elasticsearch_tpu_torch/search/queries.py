"""Query DSL: parse and run per segment on tensors.

Port of elasticsearch_tpu/search/queries.py: ``match`` (operator,
minimum_should_match, analyzer, fuzziness, ``type: phrase`` /
``phrase_prefix``), ``term``, ``terms``, ``bool``, ``match_all``,
``match_none``, ``range``, ``ids``, ``exists``, ``missing``,
``constant_score``, ``filtered``; the full-text types ``match_phrase``
(the positional program, ops/positional.py), ``match_phrase_prefix``,
``multi_match``, ``common``, ``query_string`` and
``simple_query_string``; the term expansions ``prefix``, ``wildcard``,
``regexp`` and ``fuzzy`` (a scan of the segment's term dict, capped at
``max_expansions``, where Lucene walks an FST); ``dis_max``,
``boosting``, ``indices``, ``more_like_this`` (``rewrite_mlt_in_body``
resolves its liked ids over the whole index first), ``template`` and
``wrapper``; ``knn`` over a dense_vector field (brute force, MaxSim, IVF,
IVF-PQ) and ``hybrid`` (search/hybrid.py); plus the fused dense-impact
top-k fast path and its two batched tiers for ``_msearch``
(``fused_bm25_topk_batch``, ``hybrid_bm25_topk_batch``). The types of
ROADMAP A9b (function_score, script, the span queries, the joins and the
geo queries) raise a typed QueryParsingException naming it.

A node's ``execute(ctx)`` returns a whole-segment pair

    (scores: f32[D] | None, mask: bool[D])

— scores is None for pure filters. Composition is dense tensor algebra.
"""
from __future__ import annotations

import base64
import fnmatch
import json
import re
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.ops.bitvec import pack_mask, popcount
from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk, unpack_topk
from elasticsearch_tpu_torch.ops.ivf import ivf_candidate_scores
from elasticsearch_tpu_torch.ops.knn import knn_topk
from elasticsearch_tpu_torch.ops.positional import phrase_freq, phrase_score
from elasticsearch_tpu_torch.ops.scoring import (
    bm25_hybrid_topk_batch,
    bm25_score_hybrid_gather,
    bm25_score_segment,
    f32_matmul_exact,
    match_count_hybrid_gather,
    match_count_segment,
    range_mask_f32,
    range_mask_i64pair,
    term_mask,
    term_mask_hybrid_gather,
)
from elasticsearch_tpu_torch.search.context import SegmentContext
from elasticsearch_tpu_torch.utils.dates import parse_date
from elasticsearch_tpu_torch.utils.errors import QueryParsingException
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

ExecResult = Tuple[Optional[Any], Any]  # (scores f32[D] | None, mask bool[D])

#: fused-path executions (kernel or plain twin) — shows a run took it
FUSED_CALLS = 0


def _zeros(ctx, dtype):
    return torch.zeros(ctx.D, dtype=dtype, device=ctx.device)


def _doc_range(ctx):
    """bool[D]: slots holding a document (below num_docs)."""
    return torch.arange(ctx.D, device=ctx.device) < ctx.segment.num_docs


class Query:
    boost: float = 1.0

    def execute(self, ctx: SegmentContext) -> ExecResult:
        raise NotImplementedError

    def score_or_mask(self, ctx: SegmentContext):
        """scores with filter-as-1.0 semantics (for scoring positions)."""
        scores, mask = self.execute(ctx)
        if scores is None:
            scores = mask.to(torch.float32) * self.boost
        return scores, mask


def _empty(ctx: SegmentContext) -> ExecResult:
    return None, _zeros(ctx, torch.bool)


def _dedupe_terms(terms, boost, idf_fn):
    """Merge duplicate query terms by summing their weights."""
    merged: Dict[str, float] = {}
    for t in terms:
        merged[t] = merged.get(t, 0.0) + idf_fn(t) * boost
    return list(merged.keys()), list(merged.values())


def _score_term_group(ctx, field, terms, boost=1.0, with_counts=False):
    """(scores f32[D], matched, n_present) for a group of terms on one
    field. ``matched`` is i32[D] distinct-matched-term counts when
    with_counts, else a bool[D] mask (scores > 0 when every weight is
    positive)."""
    inv = ctx.inv(field)
    if inv is None or not terms:
        matched = (_zeros(ctx, torch.int32) if with_counts
                   else _zeros(ctx, torch.bool))
        return _zeros(ctx, torch.float32), matched, 0
    terms, weights = _dedupe_terms(terms, boost, lambda t: ctx.idf(field, t))
    all_positive = all(w > 0 for w in weights)
    hyb = ctx.hybrid_slices(inv, terms, weights, need_qw=False)
    kernels.record("bm25_hybrid" if hyb is not None else "bm25_scatter")
    if hyb is not None:
        impact, _qw, _qind, starts, lens, ws, _P, n_present, qrows, qrw = hyb
        scores = bm25_score_hybrid_gather(
            impact, qrows, qrw, inv.doc_ids, inv.tfnorm, starts, lens, ws,
            D=ctx.D)
        if with_counts:
            matched = match_count_hybrid_gather(
                impact, qrows, inv.doc_ids, starts, lens, D=ctx.D)
        elif all_positive:
            matched = scores > 0
        else:
            matched = term_mask_hybrid_gather(
                impact, qrows, inv.doc_ids, starts, lens, D=ctx.D)
        return scores, matched, n_present
    starts, lens, ws, _P, n_present = ctx.chunked_slices(inv, terms,
                                                          weights)
    scores = bm25_score_segment(inv.doc_ids, inv.tfnorm, starts, lens, ws,
                                D=ctx.D)
    if with_counts:
        matched = match_count_segment(inv.doc_ids, starts, lens, D=ctx.D)
    elif all_positive:
        matched = scores > 0
    else:
        matched = term_mask(inv.doc_ids, starts, lens, D=ctx.D)
    return scores, matched, n_present


def fused_bm25_topk(ctx, query, k: int):
    """Fused dense-impact BM25 top-k fast path (kernel B1, no [D] score
    row). Eligible when ``query`` is a pure disjunctive term group whose
    present terms ALL have dense impact rows: the kernel reads only the
    query's rows out of the whole dense block, and counts the hits in the
    same pass. Returns (vals np.f32[k], ids np.i32[k], total int), or None
    to fall through to the generic score/mask path. Non-matches carry
    score <= 0 or -inf."""
    e = _fused_eligible_terms(ctx, query)
    if e is None:
        return None
    field, (tlist, wlist) = e
    inv = ctx.inv(field)
    if inv is None:
        return None
    hyb = ctx.hybrid_slices(inv, tlist, wlist, need_qw=False)
    if hyb is None:
        return None  # no dense block / no dense query term
    impact, _qw, _qind, _starts, lens, _ws, _P, n_present, qrows, qrw = hyb
    if n_present == 0 or int(np.sum(lens)) > 0:
        return None  # tail terms present — not a pure-dense group
    real = qrows >= 0
    R = int(real.sum())
    # the real rows only, weights and rows in one host-to-device copy
    arg = torch.as_tensor(np.concatenate([qrw[real].view(np.int32),
                                          qrows[real]]), device=impact.device)
    kk = min(k, ctx.D)
    buf = bm25_dense_topk(arg[:R].view(torch.float32).view(1, R), impact,
                          ctx.segment.live, k=kk, rows=arg[R:], count=True,
                          packed=True)
    vals, ids, total = unpack_topk(buf.cpu().numpy(), kk)  # one copy back
    global FUSED_CALLS
    FUSED_CALLS += 1
    kernels.record("bm25_fused_topk")
    return vals[0], ids[0], int(total[0])


def _fused_eligible_terms(ctx, query, idf: bool = True):
    """(field, deduped (terms, weights)) when ``query`` is a pure
    disjunctive term group — match operator:or without fuzziness / term
    on a text field, positive boost — else None. The gate of the fused single and batched
    top-k paths.

    ``idf=False`` keeps the weights idf-free (duplicate terms still merge
    additively): the mesh's batched round folds each segment's own idf
    into its chunk tables (``parallel/executor.py::_chunk_table``)."""
    if isinstance(query, MatchQuery):
        if query.operator != "or" or query.msm is not None \
                or query.fuzziness is not None:
            return None
        field, boost = query.field, query.boost
        terms = query._analyze(ctx)
    elif isinstance(query, TermQuery):
        fm = ctx.mappings.get(query.field)
        if fm is not None and fm.is_numeric:
            return None
        field, boost = query.field, query.boost
        terms = [query._term_str(ctx)]
    else:
        return None
    if boost <= 0 or not terms:
        return None
    idf_fn = (lambda t: ctx.idf(field, t)) if idf else (lambda t: 1.0)
    return field, _dedupe_terms(terms, boost, idf_fn)


def _batch_terms(ctx, queries, idf: bool = True):
    """(field, [(terms, weights)] per query) when every query is a
    fused-eligible term group on one field (one dense block or postings
    field per batch), else None. The rule of every batched BM25 tier;
    ``idf`` as in ``_fused_eligible_terms``."""
    field, rows = None, []
    for q in queries:
        e = _fused_eligible_terms(ctx, q, idf=idf)
        if e is None:
            return None
        f, tw = e
        if field is None:
            field = f
        elif f != field:
            return None
        rows.append(tw)
    return None if field is None else (field, rows)


def _batch_field(ctx, queries):
    """(inv, rows) of ``_batch_terms`` on this segment, or None."""
    got = _batch_terms(ctx, queries)
    inv = None if got is None else ctx.inv(got[0])
    return None if inv is None else (inv, got[1])


def fused_bm25_topk_batch(ctx, queries: List[Query], k: int):
    """Tier 1 of a batched ``_msearch`` over one segment: every query a
    pure-dense term group on one field, so the whole batch is one launch
    of kernel B1's batched form, ``qw[Q, F]`` over all F rows of the
    dense block with the hit count, and one copy back. Every weight is
    idf * boost > 0, so the kernel's count (docs where a row with a
    non-zero weight has a non-zero impact) is the reference's
    ``dense_presence_count_batch`` over the rows' 1.0 indicators.

    Returns (vals f32[Q, k], ids i32[Q, k], totals i64[Q]) as numpy, or
    None when a query does not batch (the caller falls back to the next
    tier or to per-query execution). Non-matches score <= 0 or -inf."""
    got = _batch_field(ctx, queries)
    if got is None:
        return None
    inv, rows = got
    qw = None
    impact = None
    for qi, (tlist, wlist) in enumerate(rows):
        hyb = ctx.hybrid_slices(inv, tlist, wlist)
        if hyb is None:
            return None  # no dense block / no dense query term
        impact, row_qw, _qind, _st, lens, _ws, _P, n_present, *_ = hyb
        if n_present == 0 or int(np.sum(lens)) > 0:
            return None  # a tail term or an empty group: not tier 1
        if qw is None:
            qw = np.zeros((len(rows), row_qw.shape[0]), np.float32)
        qw[qi] = row_qw
    kk = min(k, ctx.D)
    buf = bm25_dense_topk(torch.from_numpy(qw).to(impact.device), impact,
                          ctx.segment.live, k=kk, count=True, packed=True)
    vals, ids, totals = unpack_topk(buf.cpu().numpy(), kk)  # one copy back
    global FUSED_CALLS
    FUSED_CALLS += 1
    kernels.record("bm25_fused_topk", len(rows))
    return vals, ids, totals


#: queries of one tier-2 chunk: bounds the transient [chunk, D] scores
#: (64 x 2^20 f32 = 256 MB) and the sort behind them
HYBRID_CHUNK_Q = 64


def hybrid_bm25_topk_batch(ctx, queries: List[Query], k: int,
                           chunk_q: int = HYBRID_CHUNK_Q):
    """Tier 2 of a batched ``_msearch`` over one segment: term groups on
    one field whose rare terms have scatter tails. Each chunk of
    ``chunk_q`` queries is one f32 product ``qw[chunk, F] @ impact[F, D]``
    for the dense rows, the tails' ``index_add_`` scatters, and a stable
    top-k per query (``ops/scoring.py::bm25_hybrid_topk_batch``). A query
    with no dense term (all rare, or absent) rides with a zero row and
    its whole group in the tail.

    Returns (vals [Q, k], ids [Q, k], totals [Q]) as numpy, or None when
    a query does not batch, the field has no dense block, or an f32
    product would run in TF32 (then the caller's per-query path serves
    the batch exactly)."""
    got = _batch_field(ctx, queries)
    if got is None:
        return None
    inv, rows = got
    block = inv.dense_block()
    if block is None:
        return None
    impact = block[1]
    if not f32_matmul_exact(impact.device):
        kernels.record("bm25_hybrid_tf32_refused")
        return None
    Q, F = len(rows), int(impact.shape[0])
    qw = np.zeros((Q, F), np.float32)
    tails = []
    for qi, (tlist, wlist) in enumerate(rows):
        h = ctx.hybrid_slices(inv, tlist, wlist)
        if h is None:  # no dense term: the whole group is tail
            st, ln, w, _P, _n = ctx.chunked_slices(inv, tlist, wlist)
        else:
            _imp, qw[qi], _qind, st, ln, w, *_ = h
        tails.append((st, ln, w))
    T = max(t[0].shape[0] for t in tails)
    starts = np.zeros((Q, T), np.int32)
    lens = np.zeros((Q, T), np.int32)
    ws = np.zeros((Q, T), np.float32)
    for qi, (st, ln, w) in enumerate(tails):
        starts[qi, : st.shape[0]] = st
        lens[qi, : ln.shape[0]] = ln
        ws[qi, : w.shape[0]] = w
    kk = min(k, ctx.D)
    live = ctx.segment.live
    out = []
    for q0 in range(0, Q, chunk_q):
        q1 = min(q0 + chunk_q, Q)
        vals, ids, tot = bm25_hybrid_topk_batch(
            impact, torch.from_numpy(qw[q0:q1]).to(impact.device),
            inv.doc_ids, inv.tfnorm, starts[q0:q1], lens[q0:q1],
            ws[q0:q1], live, D=ctx.D, k=kk)
        out.append(torch.cat([vals.view(torch.int32), ids,
                              tot.view(-1, 1).view(torch.int32)], dim=1))
    vals, ids, totals = unpack_topk(torch.cat(out).cpu().numpy(), kk)
    kernels.record("bm25_hybrid", Q)
    return vals, ids, totals


def _terms_filter_mask(ctx, field, terms):
    inv = ctx.inv(field)
    if inv is None or not terms:
        return _zeros(ctx, torch.bool)
    terms = list(dict.fromkeys(terms))  # dedupe, order-preserving
    hyb = ctx.hybrid_slices(inv, terms, [1.0] * len(terms), need_qw=False)
    if hyb is not None:
        impact, _, _qind, starts, lens, _, _P, n_present, qrows, _qrw = hyb
        if n_present == 0:
            return _zeros(ctx, torch.bool)
        return term_mask_hybrid_gather(impact, qrows, inv.doc_ids, starts,
                                       lens, D=ctx.D)
    starts, lens, _, _P, n_present = ctx.chunked_slices(
        inv, terms, [1.0] * len(terms))
    if n_present == 0:
        return _zeros(ctx, torch.bool)
    return term_mask(inv.doc_ids, starts, lens, D=ctx.D)


def _min_should_match(msm, n_clauses: int) -> int:
    """Parse minimum_should_match: int, "2", "75%", "-25%"."""
    if msm is None:
        return 1
    if isinstance(msm, int):
        v = msm
    else:
        s = str(msm).strip()
        if s.endswith("%"):
            pct = float(s[:-1])
            if pct < 0:
                v = n_clauses - int(-pct * n_clauses / 100.0)
            else:
                v = int(pct * n_clauses / 100.0)
        else:
            v = int(s)
    return max(0, min(v, n_clauses))


def _sorted_terms(inv):
    """(sorted terms, their term ids), built once per field."""
    cached = inv._sorted_terms
    if cached is None:
        pairs = sorted((t, i) for i, t in enumerate(inv.terms))
        cached = ([t for t, _ in pairs], [i for _, i in pairs])
        inv._sorted_terms = cached
    return cached


def _expand_prefix(inv, prefix: str, max_expansions: int = 1024) -> List[str]:
    terms, _ = _sorted_terms(inv)
    i = bisect_left(terms, prefix)
    out = []
    while i < len(terms) and terms[i].startswith(prefix) \
            and len(out) < max_expansions:
        out.append(terms[i])
        i += 1
    return out


def _edit_distance_le(a: str, b: str, k: int) -> bool:
    """Levenshtein distance <= k, a banded DP with an early exit."""
    if abs(len(a) - len(b)) > k:
        return False
    if a == b:
        return True
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        lo = max(1, i - k)
        hi = min(len(b), i + k)
        if lo > 1:
            cur[lo - 1] = k + 1
        for j in range(lo, hi + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        for j in range(hi + 1, len(b) + 1):
            cur[j] = k + 1
        prev = cur
        if min(prev) > k:
            return False
    return prev[len(b)] <= k


def _fuzziness_to_edits(fuzziness, term: str) -> int:
    if fuzziness in (None, "AUTO", "auto"):
        n = len(term)
        return 0 if n <= 2 else (1 if n <= 5 else 2)
    return int(fuzziness)


def fuzzy_terms(inv, value: str, fuzziness, max_expansions: int) -> List[str]:
    """The field's terms within ``fuzziness`` edits of ``value``, in term
    id order, capped."""
    k = _fuzziness_to_edits(fuzziness, value)
    return [c for c in inv.terms
            if _edit_distance_le(value, c, k)][:max_expansions]


# ---------------------------------------------------------------------------
# leaf queries
# ---------------------------------------------------------------------------

class MatchAllQuery(Query):
    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        mask = _doc_range(ctx)
        return mask.to(torch.float32) * self.boost, mask


class MatchNoneQuery(Query):
    def execute(self, ctx) -> ExecResult:
        return _empty(ctx)


class TermQuery(Query):
    """Exact term, no analysis."""

    def __init__(self, field: str, value: Any, boost: float = 1.0):
        self.field = field
        self.value = value
        self.boost = boost

    def _term_str(self, ctx) -> str:
        fm = ctx.mappings.get(self.field)
        v = self.value
        if isinstance(v, bool):
            return "1" if v else "0"
        if fm is not None and fm.type == "boolean":
            return "1" if v in (True, "true", 1, "1") else "0"
        return str(v)

    def execute(self, ctx) -> ExecResult:
        fm = ctx.mappings.get(self.field)
        if fm is not None and fm.is_numeric:
            # term query on a numeric field = exact-value range
            return RangeQuery(self.field, gte=self.value, lte=self.value,
                              boost=self.boost).execute(ctx)
        scores, matched, n = _score_term_group(
            ctx, self.field, [self._term_str(ctx)], self.boost)
        if n == 0:
            return _empty(ctx)
        return scores, matched


class TermsQuery(Query):
    """OR of exact terms, filter semantics."""

    def __init__(self, field: str, values: List[Any], boost: float = 1.0):
        self.field = field
        self.values = values
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        fm = ctx.mappings.get(self.field)
        if fm is not None and fm.is_numeric:
            mask = _zeros(ctx, torch.bool)
            for v in self.values:
                _, m = RangeQuery(self.field, gte=v, lte=v).execute(ctx)
                mask = mask | m
            return None, mask
        return None, _terms_filter_mask(ctx, self.field,
                                        [str(v) for v in self.values])


class MatchQuery(Query):
    """Analyzed full-text query. With ``fuzziness`` each analyzed term
    expands to an OR group of the field's terms within its edits (up to
    ``max_expansions``; a term of the dict stays itself), and the
    operator and minimum_should_match count groups, not terms (the
    FuzzyQuery rewrite)."""

    def __init__(self, field: str, text: Any, operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0,
                 analyzer: Optional[str] = None, fuzziness=None,
                 max_expansions: int = 50):
        self.field = field
        self.text = text
        self.operator = operator.lower()
        self.msm = minimum_should_match
        self.boost = boost
        self.analyzer = analyzer
        self.fuzziness = fuzziness
        self.max_expansions = max_expansions

    def _analyze(self, ctx) -> List[str]:
        an = (ctx.analysis.get(self.analyzer) if self.analyzer
              else ctx.search_analyzer(self.field))
        if an is None:
            return [str(self.text)]
        return [t for t, _ in an.analyze(str(self.text))]

    def execute(self, ctx) -> ExecResult:
        terms = self._analyze(ctx)
        if not terms:
            return _empty(ctx)
        inv = ctx.inv(self.field)
        if inv is None:
            return _empty(ctx)
        if self.fuzziness is not None:
            # a term of the dict, or one allowed no edit, stays itself
            groups = [[t] if t in inv.vocab
                      or _fuzziness_to_edits(self.fuzziness, t) == 0
                      else fuzzy_terms(inv, t, self.fuzziness,
                                       self.max_expansions) or [t]
                      for t in terms]
            scores, _, _ = _score_term_group(
                ctx, self.field, [t for g in groups for t in g], self.boost)
            counts = _zeros(ctx, torch.int32)
            for g in groups:
                _, gmask, _ = _score_term_group(ctx, self.field, g, 1.0)
                counts = counts + gmask.to(torch.int32)
            n_terms = len(groups)
            need_counts = True
        else:
            # conjunctions need distinct-matched-term counts; a plain OR
            # only needs the match mask (scores > 0)
            need_counts = self.operator == "and" or self.msm is not None
            scores, counts, _ = _score_term_group(
                ctx, self.field, terms, self.boost, with_counts=need_counts)
            n_terms = len(set(terms))
        if self.operator == "and":
            mask = counts >= n_terms  # absent terms can never match
        elif need_counts:
            mask = counts >= max(_min_should_match(self.msm, n_terms), 1)
        else:
            mask = counts
        return scores, mask


def _analyzed(ctx, field: str, text) -> List[str]:
    an = ctx.search_analyzer(field)
    return [t for t, _ in an.analyze(str(text))] if an else [str(text)]


class CommonTermsQuery(Query):
    """Terms split by doc freq at ``cutoff_frequency`` (a fraction of the
    field's docs, or an absolute count from 1 on): the low-freq terms
    select, scored as a match under ``low_freq_operator`` /
    ``minimum_should_match``; the high-freq ones add their score to the
    docs the low group matched and never select alone, unless every term
    is high-freq (then they select under ``high_freq_operator``)."""

    def __init__(self, field: str, text: Any, cutoff_frequency: float = 0.01,
                 low_freq_operator: str = "or", high_freq_operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0):
        self.field = field
        self.text = text
        self.cutoff = float(cutoff_frequency)
        self.low_op = low_freq_operator.lower()
        self.high_op = high_freq_operator.lower()
        self.msm = minimum_should_match
        self.boost = boost

    def _msm_for(self, group: str):
        if isinstance(self.msm, dict):
            return self.msm.get(group)
        return self.msm if group == "low_freq" else None

    def _group_mask(self, ctx, terms, op, msm):
        need_counts = op == "and" or msm is not None
        scores, matched, _ = _score_term_group(
            ctx, self.field, terms, self.boost, with_counts=need_counts)
        n_terms = len(set(terms))
        if op == "and":
            return scores, matched >= n_terms
        if msm is not None:
            return scores, matched >= max(_min_should_match(msm, n_terms), 1)
        return scores, matched

    def execute(self, ctx) -> ExecResult:
        terms = _analyzed(ctx, self.field, self.text)
        inv = ctx.inv(self.field)
        if not terms or inv is None:
            return _empty(ctx)
        maxdoc = max(inv.num_docs, 1)
        abs_cutoff = self.cutoff if self.cutoff >= 1.0 \
            else self.cutoff * maxdoc
        low, high = [], []
        for t in dict.fromkeys(terms):
            tid = inv.term_id(t)
            df = int(inv.df[tid]) if tid >= 0 else 0
            (high if df > abs_cutoff else low).append(t)
        if low:
            scores, mask = self._group_mask(ctx, low, self.low_op,
                                            self._msm_for("low_freq"))
            if high:
                s_high, _, _ = _score_term_group(ctx, self.field, high,
                                                 self.boost)
                scores = scores + torch.where(mask, s_high, 0.0)
            return scores, mask
        return self._group_mask(ctx, high, self.high_op,
                                self._msm_for("high_freq"))


class MultiMatchQuery(Query):
    """A match over several fields (``field^boost``): ``most_fields`` sums
    the fields' scores; every other type is ``best_fields``, the best
    field's score plus ``tie_breaker`` times the others'."""

    def __init__(self, fields: List[str], text: Any,
                 type_: str = "best_fields", operator: str = "or",
                 tie_breaker: float = 0.0, boost: float = 1.0):
        self.fields = fields
        self.text = text
        self.type = type_
        self.operator = operator
        self.tie_breaker = tie_breaker
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        parts = []
        for f in self.fields:
            fboost = 1.0
            if "^" in f:
                f, _, b = f.partition("^")
                fboost = float(b)
            parts.append(MatchQuery(f, self.text, operator=self.operator,
                                    boost=fboost * self.boost).execute(ctx))
        if not parts:
            return _empty(ctx)
        mask = parts[0][1]
        for _, m in parts[1:]:
            mask = mask | m
        stacked = torch.stack([s if s is not None else m.to(torch.float32)
                               for s, m in parts])
        if self.type == "most_fields":
            return stacked.sum(0), mask
        best = stacked.amax(0)
        if self.tie_breaker > 0:
            best = best + self.tie_breaker * (stacked.sum(0) - best)
        return best, mask


class MatchPhraseQuery(Query):
    """match type=phrase: the positional program (ops/positional.py)
    gives each doc's phrase frequency over the field's positional CSR on
    the card, scored as Lucene scores a phrase: idf_sum *
    tfNorm(phraseFreq), one pseudo-term through BM25. The idf comes from
    ``ctx.idf``, so dfs statistics reach it. A one-term phrase is a
    term query."""

    def __init__(self, field: str, text: str, slop: int = 0,
                 boost: float = 1.0):
        self.field = field
        self.text = text
        self.slop = slop
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        an = ctx.search_analyzer(self.field)
        toks = an.analyze(str(self.text)) if an else [(str(self.text), 0)]
        if not toks:
            return _empty(ctx)
        inv = ctx.inv(self.field)
        if inv is None or inv.positions is None:
            return _empty(ctx)
        if any(t not in inv.vocab for t, _ in toks):
            return _empty(ctx)
        if len(toks) == 1:
            scores, matched, n = _score_term_group(
                ctx, self.field, [toks[0][0]], self.boost)
            return (scores, matched) if n else _empty(ctx)
        freq = phrase_freq(inv, toks, ctx.D, self.slop)
        if freq is None:
            return _empty(ctx)
        kernels.record("phrase_program")
        idf_sum = sum(ctx.idf(self.field, t)
                      for t in dict.fromkeys(t for t, _ in toks))
        lengths = ctx.segment.field_lengths.get(self.field)
        if lengths is None:
            lengths = _zeros(ctx, torch.float32)
        scores = phrase_score(freq, lengths, inv.avg_len,
                              idf_sum) * self.boost
        return scores, freq > 0


class MatchPhrasePrefixQuery(Query):
    """A phrase whose last term is a prefix: each of its first
    ``max_expansions`` completions runs as a phrase, a doc keeping its
    best."""

    def __init__(self, field: str, text: str, max_expansions: int = 50,
                 boost: float = 1.0):
        self.field = field
        self.text = text
        self.max_expansions = max_expansions
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        toks = _analyzed(ctx, self.field, self.text)
        if not toks:
            return _empty(ctx)
        inv = ctx.inv(self.field)
        if inv is None:
            return _empty(ctx)
        expansions = _expand_prefix(inv, toks[-1], self.max_expansions)
        if not expansions:
            return _empty(ctx)
        out_s, out_m = None, _zeros(ctx, torch.bool)
        for e in expansions:
            s, m = MatchPhraseQuery(self.field, " ".join(toks[:-1] + [e]),
                                    boost=self.boost).execute(ctx)
            out_m = out_m | m
            if s is None:  # no phrase match: nothing to add
                continue
            out_s = s if out_s is None else torch.maximum(out_s, s)
        if out_s is None:
            return _empty(ctx)
        return out_s, out_m


class RangeQuery(Query):
    """Numeric/date/keyword ranges."""

    def __init__(self, field: str, gt=None, gte=None, lt=None, lte=None,
                 fmt: Optional[str] = None, boost: float = 1.0):
        self.field = field
        self.gt, self.gte, self.lt, self.lte = gt, gte, lt, lte
        self.fmt = fmt
        self.boost = boost

    def _bounds(self, ctx):
        lo, include_lo = (self.gte, True) if self.gte is not None else (self.gt, False)
        hi, include_hi = (self.lte, True) if self.lte is not None else (self.lt, False)
        fm = ctx.mappings.get(self.field)
        if fm is not None and fm.type == "date":
            fmt = self.fmt or fm.fmt
            lo = parse_date(lo, fmt) if lo is not None else None
            hi = parse_date(hi, fmt) if hi is not None else None
        return lo, include_lo, hi, include_hi

    def execute(self, ctx) -> ExecResult:
        col = ctx.col(self.field)
        lo, ilo, hi, ihi = self._bounds(ctx)
        if col is None:
            # keyword range: host expansion over the sorted term dict
            inv = ctx.inv(self.field)
            if inv is None:
                return _empty(ctx)
            terms, _ = _sorted_terms(inv)
            i0 = bisect_left(terms, str(lo)) if lo is not None else 0
            if lo is not None and not ilo and i0 < len(terms) and terms[i0] == str(lo):
                i0 += 1
            i1 = bisect_left(terms, str(hi)) if hi is not None else len(terms)
            if hi is not None and ihi and i1 < len(terms) and terms[i1] == str(hi):
                i1 += 1
            return None, _terms_filter_mask(ctx, self.field, terms[i0:i1])

        def _as_exact_int(v):
            if v is None:
                return None
            try:
                f = float(v)
            except (TypeError, ValueError):
                return None
            i = int(f)
            return i if f == i else None

        lo_i, hi_i = _as_exact_int(lo), _as_exact_int(hi)
        inc_lo = ilo if lo is not None else True
        inc_hi = ihi if hi is not None else True
        if col.has_pair and (lo is None or lo_i is not None) \
                and (hi is None or hi_i is not None):
            from elasticsearch_tpu_torch.index.segment import split_i64

            lo_v = lo_i if lo_i is not None else -(2**63)
            hi_v = hi_i if hi_i is not None else 2**63 - 1
            (lhi,), (llo,) = split_i64(np.array([lo_v]))
            (hhi,), (hlo,) = split_i64(np.array([hi_v]))
            return None, range_mask_i64pair(
                col.hi, col.lo, col.exists, int(lhi), int(llo), int(hhi),
                int(hlo), inc_lo, inc_hi)
        lo_f = float(lo) - col.offset if lo is not None else float("-inf")
        hi_f = float(hi) - col.offset if hi is not None else float("inf")
        return None, range_mask_f32(col.values, col.exists, lo_f, hi_f,
                                    inc_lo, inc_hi)


class ExistsQuery(Query):
    def __init__(self, field: str, boost: float = 1.0):
        self.field = field
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        seg = ctx.segment
        if self.field in seg.numerics:
            return None, seg.numerics[self.field].exists
        if self.field in seg.keywords:
            return None, seg.keywords[self.field].exists
        if self.field in seg.vectors:
            return None, seg.vectors[self.field].exists
        if self.field in seg.field_lengths:
            return None, seg.field_lengths[self.field] > 0
        return _empty(ctx)


class IdsQuery(Query):
    def __init__(self, values: List[str], boost: float = 1.0):
        self.values = values
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        m = np.zeros(ctx.D, dtype=bool)
        for doc_id in self.values:
            loc = ctx.segment.id_map.get(str(doc_id))
            if loc is not None:
                m[loc] = True
        return None, torch.from_numpy(m).to(ctx.device)


class _ExpansionQuery(Query):
    """A term-dict expansion on one field, run as a terms filter (its
    score is the boost, as ``score_or_mask`` gives a filter)."""

    def __init__(self, field: str, value: str, boost: float = 1.0,
                 max_expansions: int = 1024):
        self.field = field
        self.value = value
        self.boost = boost
        self.max_expansions = max_expansions

    def expand(self, inv) -> List[str]:
        raise NotImplementedError

    def execute(self, ctx) -> ExecResult:
        inv = ctx.inv(self.field)
        if inv is None:
            return _empty(ctx)
        terms = self.expand(inv)
        if not terms:
            return _empty(ctx)
        return None, _terms_filter_mask(ctx, self.field, terms)


class PrefixQuery(_ExpansionQuery):
    def expand(self, inv) -> List[str]:
        return _expand_prefix(inv, str(self.value), self.max_expansions)


class WildcardQuery(_ExpansionQuery):
    """``*`` and ``?`` globs; the literal prefix narrows the scan."""

    def expand(self, inv) -> List[str]:
        pat = str(self.value)
        prefix = re.match(r"^[^*?\[\]]*", pat).group(0)
        cands = _expand_prefix(inv, prefix, 1 << 30) if prefix else inv.terms
        rx = re.compile(fnmatch.translate(pat))
        return [t for t in cands if rx.match(t)][: self.max_expansions]


class RegexpQuery(_ExpansionQuery):
    """Terms the regexp matches whole."""

    def expand(self, inv) -> List[str]:
        try:
            rx = re.compile(str(self.value))
        except re.error as e:
            raise QueryParsingException(
                f"invalid regexp [{self.value}]: {e}")
        return [t for t in inv.terms if rx.fullmatch(t)][
            : self.max_expansions]


class FuzzyQuery(Query):
    """The field's terms within ``fuzziness`` edits, scored as a term
    group."""

    def __init__(self, field: str, value: str, fuzziness="AUTO",
                 boost: float = 1.0, max_expansions: int = 50):
        self.field = field
        self.value = value
        self.fuzziness = fuzziness
        self.boost = boost
        self.max_expansions = max_expansions

    def execute(self, ctx) -> ExecResult:
        inv = ctx.inv(self.field)
        if inv is None:
            return _empty(ctx)
        terms = fuzzy_terms(inv, str(self.value), self.fuzziness,
                            self.max_expansions)
        if not terms:
            return _empty(ctx)
        scores, matched, _ = _score_term_group(ctx, self.field, terms,
                                               self.boost)
        return scores, matched


class BoolQuery(Query):
    def __init__(self, must=(), should=(), must_not=(), filter_=(),
                 minimum_should_match=None, boost: float = 1.0):
        self.must = list(must)
        self.should = list(should)
        self.must_not = list(must_not)
        self.filter = list(filter_)
        self.msm = minimum_should_match
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        if not (self.must or self.should or self.filter or self.must_not):
            return _empty(ctx)
        mask = _doc_range(ctx)
        scores = _zeros(ctx, torch.float32)
        for q in self.must:
            s, m = q.score_or_mask(ctx)
            scores = scores + s
            mask = mask & m
        for q in self.filter:
            _, m = q.execute(ctx)
            mask = mask & m
        for q in self.must_not:
            _, m = q.execute(ctx)
            mask = mask & ~m
        if self.should:
            should_count = _zeros(ctx, torch.int32)
            for q in self.should:
                s, m = q.score_or_mask(ctx)
                scores = scores + torch.where(m, s, torch.zeros_like(s))
                should_count = should_count + m.to(torch.int32)
            default_msm = 0 if (self.must or self.filter) else 1
            need = (_min_should_match(self.msm, len(self.should))
                    if self.msm is not None else default_msm)
            if need > 0:
                mask = mask & (should_count >= need)
        if self.boost != 1.0:
            scores = scores * self.boost
        return scores * mask, mask


class ConstantScoreQuery(Query):
    def __init__(self, inner: Query, boost: float = 1.0):
        self.inner = inner
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        _, mask = self.inner.execute(ctx)
        return mask.to(torch.float32) * self.boost, mask


class IndicesQuery(Query):
    """``query`` on the segments of the named indices (globs), else
    ``no_match`` (None: nothing), by the segment's owning index."""

    def __init__(self, indices: List[str], inner: Query,
                 no_match: Optional[Query]):
        self.indices = [str(i) for i in indices]
        self.inner = inner
        self.no_match = no_match

    def execute(self, ctx) -> ExecResult:
        if any(fnmatch.fnmatch(ctx.index_name, p) for p in self.indices):
            return self.inner.execute(ctx)
        if self.no_match is None:
            return _empty(ctx)
        return self.no_match.execute(ctx)


class DisMaxQuery(Query):
    """The best clause's score plus ``tie_breaker`` times the others'."""

    def __init__(self, queries: List[Query], tie_breaker: float = 0.0,
                 boost: float = 1.0):
        self.queries = queries
        self.tie_breaker = tie_breaker
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        if not self.queries:
            return _empty(ctx)
        return dis_max_scores([q.score_or_mask(ctx) for q in self.queries],
                              self.tie_breaker, self.boost)


def dis_max_scores(parts, tie_breaker: float, boost: float) -> ExecResult:
    """dis_max over its clauses' (scores, mask) pairs (a segment's, or
    the mesh's [S, D] stacks)."""
    mask = parts[0][1]
    for _, m in parts[1:]:
        mask = mask | m
    stacked = torch.stack([torch.where(m, s, 0.0) for s, m in parts])
    best = stacked.amax(0)
    if tie_breaker > 0:
        best = best + tie_breaker * (stacked.sum(0) - best)
    return best * boost * mask, mask


class BoostingQuery(Query):
    """``positive``'s matches, those ``negative`` also matches scored
    times ``negative_boost``."""

    def __init__(self, positive: Query, negative: Query,
                 negative_boost: float = 0.5, boost: float = 1.0):
        self.positive = positive
        self.negative = negative
        self.negative_boost = negative_boost
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        s, mask = self.positive.score_or_mask(ctx)
        return boosting_scores(s, mask, self.negative.execute(ctx)[1],
                               self.negative_boost, self.boost)


def boosting_scores(s, mask, neg, negative_boost: float,
                    boost: float) -> ExecResult:
    """boosting: the positive clause's scores, times ``negative_boost``
    where the negative clause matches."""
    s = torch.where(neg, s * negative_boost, s)
    return s * boost * mask, mask


class KnnQuery(Query):
    """dense_vector kNN. As a query node it scores the top num_candidates
    docs by similarity (the rest are non-matches, ES knn-query
    semantics); the generic top-k then selects. A ``filter`` folds into
    the candidate mask before selection.

    Branches, in the reference's order:
    - MaxSim: a list of query vectors (``query_vectors``, or a nested
      list under ``query_vector``): kernel B2 per token, then a
      scatter-max merge; per doc the max over tokens;
    - IVF-PQ (``index_options: {type: ivf_pq}``): probe, the filter as a
      packed pre-filter, ADC coarse rank (kernel B3), exact f32 re-rank
      of the top ``fine_k``;
    - IVF (``{type: ivf}``): probe wider (4x) under a filter and
      post-filter;
    - brute force: kernel B2 at k = num_candidates in f32.
    When a filter leaves fewer than k IVF candidates while at least k
    docs pass it, the query falls through to brute force, which selects
    from every admitted doc: query semantics, not a device fallback."""

    def __init__(self, field: str, query_vector, k: int = 10,
                 num_candidates: Optional[int] = None,
                 filter_: Optional[Query] = None, boost: float = 1.0,
                 ann: Optional[bool] = None, pq: Optional[bool] = None):
        self.field = field
        try:
            toks = np.asarray(query_vector, dtype=np.float32)
        except (ValueError, TypeError) as e:
            # ragged token lists / non-numeric entries: a typed 400
            raise QueryParsingException(f"malformed knn query vector: {e}")
        if toks.ndim == 1:
            toks = toks[None, :]
        elif toks.ndim != 2:
            raise QueryParsingException(
                "knn query_vector must be a vector or a list of vectors")
        self.tokens = toks  # [T, dims]; T > 1 = MaxSim
        self.maxsim = toks.shape[0] > 1
        self.k = k
        self.num_candidates = num_candidates or max(k * 10, 100)
        self.filter = filter_
        self.boost = boost
        # None = follow the mapping's index_options; True/False forces
        self.ann = ann
        self.pq = pq

    def _ann_type(self, ctx) -> Optional[str]:
        fm = ctx.mappings.get(self.field)
        opts = getattr(fm, "index_options", None) if fm is not None else None
        return opts.get("type") if isinstance(opts, dict) else None

    def _use_ann(self, ctx) -> bool:
        if self.ann is not None:
            return bool(self.ann)
        return self._ann_type(ctx) in ("ivf", "ivf_flat", "ivf_pq")

    def _use_pq(self, ctx) -> bool:
        if self.pq is not None:
            return bool(self.pq)
        return self._ann_type(ctx) == "ivf_pq"

    def _admitted(self, ctx, vc):
        """bool[D]: docs with a vector, live, and passing the filter."""
        lv = vc.exists & ctx.segment.live
        if self.filter is not None:
            _, fm = self.filter.execute(ctx)
            lv = lv & fm
        return lv

    def _select(self, ctx, vc, toks: torch.Tensor):
        """Kernel B2 over the admitted docs at k = num_candidates, then a
        scatter-max of the valid (score, id) pairs into the (scores,
        mask) contract. Slots at -inf are invalid and their ids unused."""
        kc = int(min(max(self.num_candidates, self.k), ctx.D))
        vals, idx = knn_topk(toks, vc.vecs, self._admitted(ctx, vc), k=kc,
                             metric=vc.similarity, precise=True)
        valid = (vals > float("-inf")).reshape(-1)
        ids = idx.reshape(-1).to(torch.int64)
        zero = torch.zeros_like(valid, dtype=torch.float32)
        vals = torch.where(valid, vals.reshape(-1) * self.boost, zero)
        scores = _zeros(ctx, torch.float32).scatter_reduce_(
            0, ids, vals, reduce="amax")
        # a scatter, not mask[ids[valid]]: no device-to-host sync
        mask = _zeros(ctx, torch.float32).scatter_reduce_(
            0, ids, valid.to(torch.float32), reduce="amax") > 0
        return scores, mask

    def execute(self, ctx) -> ExecResult:
        vc = ctx.segment.vectors.get(self.field)
        if vc is None:
            return _empty(ctx)
        if self.tokens.shape[1] != vc.dims:
            raise QueryParsingException(
                f"knn query vector has {self.tokens.shape[1]} dims but "
                f"field [{self.field}] is mapped with {vc.dims}")
        toks = torch.from_numpy(self.tokens).to(ctx.device)
        if self.maxsim:
            # per-token top-kc; the union of the per-token lists covers
            # the per-doc-max top kc
            return self._select(ctx, vc, toks)
        if self._use_ann(ctx):
            ivf = vc.get_ivf(ctx.segment.max_docs)
            pq = (vc.get_pq(ctx.segment.max_docs)
                  if ivf is not None and self._use_pq(ctx) else None)
            num_cand = self.num_candidates
            if self.filter is not None:
                num_cand *= 4  # a selective filter thins the probed lists
            if ivf is not None and pq is not None:
                # the filter and liveness pre-filter the candidates as a
                # packed bit-vector, so every ADC survivor is admissible
                words = pack_mask(self._admitted(ctx, vc))
                fine_k = min(pow2_bucket(max(8 * self.k, 128)), ctx.D)
                scores, mask = ivf_candidate_scores(
                    ivf, vc.vecs, self.tokens[0], num_cand, vc.similarity,
                    ctx.D, pq=pq, fine_k=fine_k, filter_words=words)
                if int(mask.sum()) >= min(self.k, popcount(words)):
                    return _ann_result(scores, mask, self.boost)
                # starved: brute force below selects from every admitted doc
            elif ivf is not None:
                scores, mask = ivf_candidate_scores(
                    ivf, vc.vecs, self.tokens[0], num_cand, vc.similarity,
                    ctx.D)
                mask = mask & vc.exists
                starved = False
                if self.filter is not None:
                    _, fm = self.filter.execute(ctx)
                    mask = mask & fm
                    starved = int(mask.sum()) < min(
                        self.k, int((fm & vc.exists).sum()))
                if not starved:
                    return _ann_result(scores, mask, self.boost)
        kernels.record("knn_fused_topk")
        return self._select(ctx, vc, toks)


def _ann_result(scores, mask, boost: float) -> ExecResult:
    return torch.where(mask, scores, torch.zeros_like(scores)) * boost, mask


# ---------------------------------------------------------------------------
# query_string / simple_query_string (the reference's subset grammar)
# ---------------------------------------------------------------------------

_QS_TOKEN = re.compile(r'([+\-]?)(?:([\w.]+):)?"([^"]*)"|(\S+)')


class QueryStringQuery(Query):
    """The reference's subset of QueryStringQueryBuilder: ``field:term``,
    quoted phrases, ``+``/``-`` prefixes, AND/OR/NOT connectives (no
    parentheses); a term with ``*``/``?`` is a wildcard, one ending in
    ``~`` a fuzzy query. Runs as the bool query it rewrites to."""

    def __init__(self, query: str, default_field: str = "_all",
                 fields: Optional[List[str]] = None,
                 default_operator: str = "or", boost: float = 1.0):
        self.query = query
        self.default_field = default_field
        self.fields = fields
        self.default_operator = default_operator.lower()
        self.boost = boost

    def _leaf(self, field: Optional[str], text: str, phrase: bool) -> Query:
        tgt = field or (self.fields[0] if self.fields else self.default_field)
        if self.fields and field is None and len(self.fields) > 1:
            return MultiMatchQuery(self.fields, text)
        if phrase:
            return MatchPhraseQuery(tgt, text)
        if "*" in text or "?" in text:
            return WildcardQuery(tgt, text)
        if text.endswith("~"):
            return FuzzyQuery(tgt, text[:-1])
        return MatchQuery(tgt, text)

    def rewrite(self) -> Query:
        must: List[Query] = []
        must_not: List[Query] = []
        should: List[Query] = []
        pending_op: Optional[str] = None
        negate_next = False
        for m in _QS_TOKEN.finditer(self.query):
            phrase_sign, field, phrase_text, word = m.groups()
            if word in ("AND", "&&"):
                pending_op = "and"
                # AND binds both sides: the previous should clause too
                if should:
                    must.append(should.pop())
                continue
            if word in ("OR", "||"):
                pending_op = "or"
                continue
            if word in ("NOT", "!"):
                negate_next = True
                continue
            raw = phrase_text if phrase_text is not None else word
            is_phrase = phrase_text is not None
            sign = phrase_sign or None
            if not is_phrase:
                if raw.startswith("+"):
                    sign, raw = "+", raw[1:]
                elif raw.startswith("-"):
                    sign, raw = "-", raw[1:]
                if ":" in raw:
                    field, _, raw = raw.partition(":")
                    if raw.startswith('"') and raw.endswith('"'):
                        raw = raw[1:-1]
                        is_phrase = True
            leaf = self._leaf(field, raw, is_phrase)
            if negate_next or sign == "-":
                must_not.append(leaf)
                negate_next = False
            elif sign == "+" or pending_op == "and" \
                    or self.default_operator == "and":
                must.append(leaf)
            else:
                should.append(leaf)
            pending_op = None
        return BoolQuery(must=must, should=should, must_not=must_not,
                         boost=self.boost)

    def execute(self, ctx) -> ExecResult:
        return self.rewrite().execute(ctx)


# ---------------------------------------------------------------------------
# more_like_this
# ---------------------------------------------------------------------------

class MoreLikeThisQuery(Query):
    """Significant terms of the liked texts and docs (tf * idf, at most
    ``max_query_terms`` a field, unliked terms skipped) as a should
    group; the liked docs themselves are left out unless ``include``."""

    def __init__(self, fields: List[str], like_texts=(), like_ids=(),
                 unlike_texts=(), unlike_ids=(), include: bool = False,
                 max_query_terms: int = 25, min_term_freq: int = 1,
                 min_doc_freq: int = 1, boost: float = 1.0,
                 exclude_ids=()):
        self.fields = fields or ["_all"]
        self.like_texts = list(like_texts)
        self.like_ids = list(like_ids)
        self.unlike_texts = list(unlike_texts)
        self.unlike_ids = list(unlike_ids)
        # ids whose docs rewrite_mlt_in_body resolved to texts, excluded
        # from the results as like_ids are
        self.exclude_ids = list(exclude_ids)
        self.include = include
        self.max_query_terms = max_query_terms
        self.min_term_freq = min_term_freq
        self.min_doc_freq = min_doc_freq
        self.boost = boost

    def _texts_of(self, ctx, ids, extra_texts) -> List[str]:
        texts = list(extra_texts)
        for doc_id in ids:
            loc = ctx.segment.id_map.get(str(doc_id))
            if loc is not None and ctx.segment.sources[loc]:
                src = ctx.segment.sources[loc]
                for f in self.fields:
                    if f == "_all":  # every text value, as the _all mapper
                        v = " ".join(x for x in src.values()
                                     if isinstance(x, str))
                    else:
                        v = src.get(f)
                    if isinstance(v, str):
                        texts.append(v)
        return texts

    def execute(self, ctx) -> ExecResult:
        out_s = _zeros(ctx, torch.float32)
        out_m = _zeros(ctx, torch.bool)
        texts = self._texts_of(ctx, self.like_ids, self.like_texts)
        untexts = self._texts_of(ctx, self.unlike_ids, self.unlike_texts)
        for field in self.fields:
            inv = ctx.inv(field)
            if inv is None:
                continue
            an = ctx.search_analyzer(field)

            def toks_of(text):
                return ([t for t, _ in an.analyze(text)] if an
                        else text.split())

            tf: Dict[str, int] = {}
            for text in texts:
                for t in toks_of(text):
                    tf[t] = tf.get(t, 0) + 1
            skip = {t for text in untexts for t in toks_of(text)}
            scored = []
            for t, f_ in tf.items():
                if f_ < self.min_term_freq or t in skip:
                    continue
                tid = inv.vocab.get(t, -1)
                if tid < 0 or inv.df[tid] < self.min_doc_freq:
                    continue
                scored.append((f_ * inv.idf(t), t))
            scored.sort(reverse=True)
            sel = [t for _, t in scored[: self.max_query_terms]]
            if not sel:
                continue
            s, matched, _ = _score_term_group(ctx, field, sel, self.boost)
            out_s = out_s + s
            out_m = out_m | matched
        excl = self.like_ids + self.exclude_ids
        if not self.include and excl:
            drop = np.zeros(ctx.D, dtype=bool)
            for doc_id in excl:
                loc = ctx.segment.id_map.get(str(doc_id))
                if loc is not None:
                    drop[loc] = True
            keep = torch.from_numpy(~drop).to(ctx.device)
            out_m = out_m & keep
            out_s = torch.where(keep, out_s, 0.0)
        return out_s, out_m


def _doc_path_values(src, path: str) -> list:
    """Dot-path values of a source dict, lists flattened."""
    cur = [src]
    for part in str(path).split("."):
        nxt = []
        for c in cur:
            if isinstance(c, dict) and part in c:
                v = c[part]
                nxt.extend(v if isinstance(v, list) else [v])
        cur = nxt
    return cur


def rewrite_mlt_in_body(query_dsl, lookup):
    """Resolve the documents a query names before it fans out to the
    shards, where a segment sees only its own docs:

    - more_like_this liked ids become the docs' texts (``{"doc":
      source}``), still excluded from the results through
      ``_exclude_ids`` (TransportMoreLikeThisAction gets the liked doc,
      then queries);
    - a terms lookup (``{"terms": {f: {index, type, id, path}}}``)
      becomes the term list at ``path`` (a missing doc: an empty list,
      matching nothing);
    - a geo_shape ``indexed_shape`` becomes the inline shape.

    ``lookup(doc_id, routing=None, index=None)`` honours each item's
    routing and ``_index``. Returns a rewritten copy, or the input
    unchanged."""
    if not isinstance(query_dsl, dict):
        return query_dsl

    def resolve_terms(spec):
        out = None
        for field, v in spec.items():
            if not (isinstance(v, dict) and v.get("id") is not None
                    and ("path" in v or "index" in v)):
                continue
            src = lookup(str(v["id"]), routing=v.get("routing"),
                         index=v.get("index"))
            vals = ([] if src is None
                    else [x for x in _doc_path_values(src,
                                                      v.get("path", field))
                          if not isinstance(x, (dict, list))])
            if out is None:
                out = dict(spec)
            out[field] = vals
        return out if out is not None else spec

    def resolve_shape(spec):
        for field, v in spec.items():
            ind = v.get("indexed_shape") if isinstance(v, dict) else None
            if not (isinstance(ind, dict) and ind.get("id") is not None):
                continue
            src = lookup(str(ind["id"]), routing=ind.get("routing"),
                         index=ind.get("index"))
            if src is None:
                continue  # stays indexed_shape: the geo parser raises
            got = _doc_path_values(src, ind.get("path", "shape"))
            if got and isinstance(got[0], dict):
                nv = {k: x for k, x in v.items() if k != "indexed_shape"}
                nv["shape"] = got[0]
                out = dict(spec)
                out[field] = nv
                return out
        return spec

    def fields_of(spec):
        flds = spec.get("fields") or None
        # _all has no _source key: every field's text, the whole source
        if flds and "_all" in flds:
            return None
        return flds

    def resolve(spec):
        changed = False
        out = dict(spec)
        excl = list(out.get("_exclude_ids", []))
        flds = fields_of(spec)

        def conv(entries, exclude: bool):
            nonlocal changed
            if entries is None:
                return None
            lst = entries if isinstance(entries, list) else [entries]
            new = []
            for item in lst:
                if isinstance(item, dict) and "doc" not in item \
                        and item.get("_id") is not None:
                    src = lookup(str(item["_id"]),
                                 routing=item.get("routing") or
                                 item.get("_routing"),
                                 index=item.get("_index"))
                    if src is not None:
                        doc = (src if flds is None
                               else {f: src[f] for f in flds if f in src})
                        new.append({"doc": doc})
                        if exclude:
                            excl.append(str(item["_id"]))
                        changed = True
                        continue
                new.append(item)
            return new

        for key, exclude in (("like", True), ("like_text", True),
                             ("docs", True), ("unlike", False),
                             ("ignore_like", False)):
            if key in out:
                got = conv(out[key], exclude)
                if got is not None:
                    out[key] = got
        if "ids" in out and out["ids"]:
            likes = conv([{"_id": i} for i in out["ids"]], True)
            if any("doc" in e for e in likes if isinstance(e, dict)):
                out["ids"] = [i for i, e in zip(out["ids"], likes)
                              if not (isinstance(e, dict) and "doc" in e)]
                if "like" not in out and "like_text" in out:
                    # a new ``like`` would shadow like_text in the
                    # parser's like-or-like_text fallback: fold it in
                    lt = out.pop("like_text")
                    out["like"] = lt if isinstance(lt, list) else [lt]
                else:
                    out.setdefault("like", [])
                if not isinstance(out["like"], list):
                    out["like"] = [out["like"]]
                out["like"] = list(out["like"]) + [
                    e for e in likes if isinstance(e, dict) and "doc" in e]
        if not changed:
            return spec
        out["_exclude_ids"] = excl
        return out

    def walk(node):
        if isinstance(node, dict):
            out = None
            for k, v in node.items():
                if k in ("more_like_this", "mlt") and isinstance(v, dict):
                    nv = resolve(v)
                elif k == "terms" and isinstance(v, dict):
                    nv = resolve_terms(v)
                elif k == "geo_shape" and isinstance(v, dict):
                    nv = resolve_shape(v)
                else:
                    nv = walk(v)
                if nv is not v:
                    if out is None:
                        out = dict(node)
                    out[k] = nv
            return out if out is not None else node
        if isinstance(node, list):
            newl = [walk(x) for x in node]
            if any(a is not b for a, b in zip(newl, node)):
                return newl
            return node
        return node

    return walk(query_dsl)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def _parse_clauses(v) -> List[Query]:
    if isinstance(v, dict):
        return [parse_query(v)]
    return [parse_query(c) for c in v]


def _single_field(qtype, body):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingException(
            f"[{qtype}] query expects exactly one field, got {body!r}")
    (field, spec), = body.items()
    return field, spec


def parse_query(dsl: Optional[dict]) -> Query:
    """Parse an ES query DSL dict into a Query tree. A ``_name`` key (on
    the query body or a single-field spec) names the node for
    ``matched_queries`` (``collect_named``; the fetch phase reports it)."""
    name = None
    if isinstance(dsl, dict) and len(dsl) == 1:
        (qtype, qbody), = dsl.items()
        if isinstance(qbody, dict):
            body2 = dict(qbody)
            name = body2.pop("_name", None)
            if name is None and len(body2) == 1:
                (f, spec), = body2.items()
                if isinstance(spec, dict) and "_name" in spec:
                    spec = dict(spec)
                    name = spec.pop("_name")
                    body2 = {f: spec}
            if name is not None:
                dsl = {qtype: body2}
    q = _parse_query_inner(dsl)
    if name is not None:
        q._name = str(name)
    return q


def collect_named(q: Query, out: Optional[List[Tuple[str, Query]]] = None
                  ) -> List[Tuple[str, Query]]:
    """All (_name, node) pairs in a query tree (matched_queries)."""
    if out is None:
        out = []
    nm = getattr(q, "_name", None)
    if nm is not None:
        out.append((nm, q))
    for attr in ("must", "should", "must_not", "filter", "queries"):
        v = getattr(q, attr, None)
        if isinstance(v, (list, tuple)):
            for c in v:
                if isinstance(c, Query):
                    collect_named(c, out)
    for attr in ("inner", "positive", "negative", "no_match", "filter"):
        c = getattr(q, attr, None)
        if isinstance(c, Query):
            collect_named(c, out)
    return out


def _parse_query_inner(dsl: Optional[dict]) -> Query:
    if dsl is None or dsl == {}:
        return MatchAllQuery()
    if not isinstance(dsl, dict) or len(dsl) != 1:
        raise QueryParsingException(f"expected a single-key query object, got {dsl!r}")
    (qtype, body), = dsl.items()

    if qtype == "match_all":
        return MatchAllQuery(boost=float((body or {}).get("boost", 1.0)))
    if qtype == "match_none":
        return MatchNoneQuery()

    if qtype == "match":
        field, spec = _single_field(qtype, body)
        if not isinstance(spec, dict):
            return MatchQuery(field, spec)
        # ES 2.0's MatchQuery.Type: phrase and phrase_prefix run as their
        # own queries (the reference ignores ``type``; ROADMAP C6)
        mtype = str(spec.get("type", "boolean"))
        if mtype == "phrase":
            return MatchPhraseQuery(field, spec.get("query"),
                                    slop=int(spec.get("slop", 0)),
                                    boost=float(spec.get("boost", 1.0)))
        if mtype == "phrase_prefix":
            return MatchPhrasePrefixQuery(
                field, spec.get("query"),
                max_expansions=int(spec.get("max_expansions", 50)))
        return MatchQuery(
            field, spec.get("query"),
            operator=spec.get("operator", "or"),
            minimum_should_match=spec.get("minimum_should_match"),
            boost=float(spec.get("boost", 1.0)),
            analyzer=spec.get("analyzer"),
            fuzziness=spec.get("fuzziness"),
            max_expansions=int(spec.get("max_expansions", 50)))

    if qtype in ("match_phrase", "text_phrase"):
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            return MatchPhraseQuery(field, spec.get("query"),
                                    slop=int(spec.get("slop", 0)),
                                    boost=float(spec.get("boost", 1.0)))
        return MatchPhraseQuery(field, spec)

    if qtype == "match_phrase_prefix":
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            return MatchPhrasePrefixQuery(
                field, spec.get("query"),
                max_expansions=int(spec.get("max_expansions", 50)))
        return MatchPhrasePrefixQuery(field, spec)

    if qtype == "multi_match":
        return MultiMatchQuery(
            list(body.get("fields", [])), body.get("query"),
            type_=body.get("type", "best_fields"),
            operator=body.get("operator", "or"),
            tie_breaker=float(body.get("tie_breaker", 0.0)),
            boost=float(body.get("boost", 1.0)))

    if qtype == "common":
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            return CommonTermsQuery(
                field, spec.get("query"),
                cutoff_frequency=float(spec.get("cutoff_frequency", 0.01)),
                low_freq_operator=spec.get("low_freq_operator", "or"),
                high_freq_operator=spec.get("high_freq_operator", "or"),
                minimum_should_match=spec.get("minimum_should_match"),
                boost=float(spec.get("boost", 1.0)))
        return CommonTermsQuery(field, spec)

    if qtype == "term":
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            value, boost = spec.get("value", spec.get("term")), \
                float(spec.get("boost", 1.0))
        else:
            value, boost = spec, 1.0
        if field in ("_id", "_uid"):
            if field == "_uid" and isinstance(value, str) and "#" in value:
                value = value.split("#", 1)[1]
            return IdsQuery([value], boost=boost)
        return TermQuery(field, value, boost=boost)

    if qtype == "terms":
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        body.pop("minimum_should_match", None)
        body.pop("execution", None)
        field, values = _single_field(qtype, body)
        if field in ("_id", "_uid"):
            vals = [v.split("#", 1)[1] if (field == "_uid"
                    and isinstance(v, str) and "#" in v) else v
                    for v in values]
            return IdsQuery(vals, boost=boost)
        return TermsQuery(field, list(values), boost=boost)

    if qtype == "range":
        field, spec = _single_field(qtype, body)
        spec = dict(spec)
        if "from" in spec:  # ES 1.x legacy from/to
            spec.setdefault("gte" if spec.get("include_lower", True) else "gt", spec.pop("from"))
        if "to" in spec:
            spec.setdefault("lte" if spec.get("include_upper", True) else "lt", spec.pop("to"))
        return RangeQuery(field, gt=spec.get("gt"), gte=spec.get("gte"),
                          lt=spec.get("lt"), lte=spec.get("lte"),
                          fmt=spec.get("format"),
                          boost=float(spec.get("boost", 1.0)))

    if qtype == "exists":
        return ExistsQuery(body["field"])
    if qtype == "missing":  # ES 2.0's missing query: NOT exists
        return BoolQuery(must_not=[ExistsQuery(body["field"])])

    if qtype == "ids":
        return IdsQuery(list(body.get("values", [])))

    if qtype == "prefix":
        field, spec = _single_field(
            qtype, {k: v for k, v in body.items() if k != "boost"})
        value = spec.get("value", spec.get("prefix")) \
            if isinstance(spec, dict) else spec
        return PrefixQuery(field, value, boost=float(body.get("boost", 1.0)))

    if qtype == "wildcard":
        field, spec = _single_field(qtype, body)
        value = spec.get("value", spec.get("wildcard")) \
            if isinstance(spec, dict) else spec
        return WildcardQuery(field, value)

    if qtype == "regexp":
        field, spec = _single_field(qtype, body)
        return RegexpQuery(field, spec.get("value")
                           if isinstance(spec, dict) else spec)

    if qtype == "fuzzy":
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            return FuzzyQuery(field, spec.get("value"),
                              fuzziness=spec.get("fuzziness", "AUTO"),
                              boost=float(spec.get("boost", 1.0)),
                              max_expansions=int(spec.get("max_expansions",
                                                          50)))
        return FuzzyQuery(field, spec)

    if qtype == "bool":
        return BoolQuery(
            must=_parse_clauses(body.get("must", [])),
            should=_parse_clauses(body.get("should", [])),
            must_not=_parse_clauses(body.get("must_not", [])),
            filter_=_parse_clauses(body.get("filter", [])),
            minimum_should_match=body.get("minimum_should_match"),
            boost=float(body.get("boost", 1.0)))

    if qtype == "constant_score":
        inner = body.get("filter", body.get("query"))
        return ConstantScoreQuery(parse_query(inner),
                                  boost=float(body.get("boost", 1.0)))

    if qtype == "filtered":  # ES 2.0 legacy
        q = parse_query(body.get("query")) if body.get("query") \
            else MatchAllQuery()
        if not body.get("filter"):
            return q
        return BoolQuery(must=[q], filter_=[parse_query(body["filter"])])

    if qtype == "dis_max":
        return DisMaxQuery([parse_query(q) for q in body.get("queries", [])],
                           tie_breaker=float(body.get("tie_breaker", 0.0)),
                           boost=float(body.get("boost", 1.0)))

    if qtype == "boosting":
        return BoostingQuery(
            parse_query(body["positive"]), parse_query(body["negative"]),
            negative_boost=float(body.get("negative_boost", 0.5)))

    if qtype == "query_string":
        return QueryStringQuery(
            body["query"], default_field=body.get("default_field", "_all"),
            fields=body.get("fields"),
            default_operator=body.get("default_operator", "or"),
            boost=float(body.get("boost", 1.0)))

    if qtype == "simple_query_string":
        fields = body.get("fields")
        return QueryStringQuery(
            body["query"], fields=fields,
            default_field=fields[0] if fields else "_all",
            default_operator=body.get("default_operator", "or"))

    if qtype == "more_like_this":
        return _parse_mlt(body)

    if qtype == "indices":
        # applied by the owning index of each segment
        names = body.get("indices",
                         [body.get("index")] if body.get("index") else [])
        q = parse_query(body["query"])
        nm = body.get("no_match_query", "all")
        if nm == "none":
            no_match: Optional[Query] = None
        elif nm == "all":
            no_match = MatchAllQuery()
        else:
            no_match = parse_query(nm)
        return IndicesQuery(names, q, no_match)

    if qtype == "template":
        from elasticsearch_tpu_torch.search.templates import render_template

        spec = body.get("query", body.get("inline", body))
        return parse_query(render_template(spec, body.get("params")))

    if qtype == "wrapper":
        raw = body["query"]
        return parse_query(raw if isinstance(raw, dict)
                           else json.loads(base64.b64decode(raw)))

    if qtype == "knn":
        filt = parse_query(body["filter"]) if "filter" in body else None
        # query_vectors: a ColBERT-style token matrix (MaxSim); a nested
        # list under query_vector means the same
        vec = body.get("query_vectors",
                       body.get("query_vector", body.get("vector")))
        return KnnQuery(body["field"], vec, k=int(body.get("k", 10)),
                        num_candidates=body.get("num_candidates"),
                        filter_=filt, boost=float(body.get("boost", 1.0)),
                        ann=body.get("ann"), pq=body.get("pq"))

    if qtype == "hybrid":
        # lexical + vector fusion (search/hybrid.py); a local import, as
        # hybrid.py imports this module when it loads
        from elasticsearch_tpu_torch.search.hybrid import parse_hybrid

        return parse_hybrid(body)

    if qtype in A9B_QUERIES:
        raise QueryParsingException(
            f"query type [{qtype}] is not yet in the PyTorch port "
            f"(ROADMAP A9b)")
    raise QueryParsingException(f"unknown query type [{qtype}]")


#: the reference's query types that come with ROADMAP A9b
A9B_QUERIES = ("function_score", "script", "span_term", "span_first",
               "span_near", "span_not", "span_or", "span_multi",
               "field_masking_span", "nested", "has_child", "has_parent",
               "top_children", "geo_distance", "geo_bounding_box",
               "geo_polygon", "geo_shape")


def _parse_mlt(body: dict) -> MoreLikeThisQuery:
    def split(spec):
        """like/unlike/docs: strings, {_id} and {doc: {...}} artificial
        docs, as (texts, ids)."""
        if spec is None:
            return [], []
        if isinstance(spec, (str, dict)):
            spec = [spec]
        texts, ids = [], []
        for item in spec:
            if isinstance(item, dict):
                if isinstance(item.get("doc"), dict):
                    texts.extend(str(v) for v in item["doc"].values()
                                 if isinstance(v, (str, int, float)))
                elif item.get("_id") is not None:
                    ids.append(item["_id"])
            else:
                texts.append(item)
        return texts, ids

    texts, ids = split(body.get("like", body.get("like_text")))
    dtexts, dids = split(body.get("docs"))
    untexts, unids = split(body.get("unlike", body.get("ignore_like")))
    return MoreLikeThisQuery(
        body.get("fields", []), like_texts=texts + dtexts,
        like_ids=ids + dids + list(body.get("ids", [])),
        exclude_ids=list(body.get("_exclude_ids", [])),
        unlike_texts=untexts, unlike_ids=unids,
        include=bool(body.get("include", False)),
        max_query_terms=int(body.get("max_query_terms", 25)),
        min_term_freq=int(body.get("min_term_freq", 1)),
        min_doc_freq=int(body.get("min_doc_freq", 1)))
