"""Query DSL, the slice's subset: parse and run per segment on tensors.

Port of the part of elasticsearch_tpu/search/queries.py the main path
needs: ``match`` (operator, minimum_should_match, analyzer), ``term``,
``terms``, ``bool`` (must, should, must_not, filter,
minimum_should_match), ``match_all``, ``range``, ``ids``, ``exists`` and
``constant_score``, plus the fused dense-impact top-k fast path (and its
two batched tiers for ``_msearch``, ``fused_bm25_topk_batch`` and
``hybrid_bm25_topk_batch``), and
``knn`` over a dense_vector field (brute force, MaxSim, IVF, IVF-PQ), and
``hybrid`` (search/hybrid.py). Any other query type raises a typed
QueryParsingException.

A node's ``execute(ctx)`` returns a whole-segment pair

    (scores: f32[D] | None, mask: bool[D])

— scores is None for pure filters. Composition is dense tensor algebra.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.ops.bitvec import pack_mask, popcount
from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk, unpack_topk
from elasticsearch_tpu_torch.ops.ivf import ivf_candidate_scores
from elasticsearch_tpu_torch.ops.knn import knn_topk
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
    disjunctive term group — match operator:or / term on a text field,
    positive boost — else None. The gate of the fused single and batched
    top-k paths.

    ``idf=False`` keeps the weights idf-free (duplicate terms still merge
    additively): the mesh's batched round folds each segment's own idf
    into its chunk tables (``parallel/executor.py::_chunk_table``)."""
    if isinstance(query, MatchQuery):
        if query.operator != "or" or query.msm is not None:
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


# ---------------------------------------------------------------------------
# leaf queries
# ---------------------------------------------------------------------------

class MatchAllQuery(Query):
    def __init__(self, boost: float = 1.0):
        self.boost = boost

    def execute(self, ctx) -> ExecResult:
        mask = _doc_range(ctx)
        return mask.to(torch.float32) * self.boost, mask


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
    """Analyzed full-text query."""

    def __init__(self, field: str, text: Any, operator: str = "or",
                 minimum_should_match=None, boost: float = 1.0,
                 analyzer: Optional[str] = None):
        self.field = field
        self.text = text
        self.operator = operator.lower()
        self.msm = minimum_should_match
        self.boost = boost
        self.analyzer = analyzer

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
        if ctx.inv(self.field) is None:
            return _empty(ctx)
        # conjunctions need distinct-matched-term counts; a plain OR only
        # needs the match mask (scores > 0)
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
            terms = sorted(inv.terms)
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

    if qtype == "match":
        field, spec = _single_field(qtype, body)
        if isinstance(spec, dict):
            if spec.get("fuzziness") is not None:
                raise QueryParsingException(
                    "[match] fuzziness is not yet in the PyTorch port")
            return MatchQuery(
                field, spec.get("query"),
                operator=spec.get("operator", "or"),
                minimum_should_match=spec.get("minimum_should_match"),
                boost=float(spec.get("boost", 1.0)),
                analyzer=spec.get("analyzer"))
        return MatchQuery(field, spec)

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

    if qtype == "ids":
        return IdsQuery(list(body.get("values", [])))

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

    raise QueryParsingException(
        f"query type [{qtype}] is not yet in the PyTorch port")
