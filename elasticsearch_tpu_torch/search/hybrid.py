"""Hybrid retrieval: lexical + vector fusion, then an optional MaxSim
stage-2 re-rank of the merged window.

Port of elasticsearch_tpu/search/hybrid.py. Per segment, stage 1 runs
both engines through the generic (scores, mask) contract and fuses them:

    linear    w_lex * lex + w_vec * vec over each engine's matches
    rrf       w_e / (rank_constant + 1 + rank_e), rank_e the 0-based
              position of a match in (-score, doc id) order

then the service's masked top-k and exact total, as for any query. The
lexical side is the generic f32 BM25 score (never kernel B1's bf16
scores, which rank fusion would expose); the vector side is the port's
``KnnQuery`` (kernel B2 for brute force, B3 under an ``ivf_pq`` mapping),
with its scores times the knn boost. A rank is one stable sort of the
masked scores and a scatter of ``arange`` that inverts the permutation.

The reference also has a one-program fast path (``hybrid_fused_topk``
with its gather and scatter forms, a batched tier, trace counters). It
exists to make one jitted XLA program and one packed host pull per
segment, both TPU concerns; its own tests require it to return what the
composable path returns. The port keeps only the composable path.

Stage 2 (``apply_hybrid_rerank``) re-scores the top ``window_size``
merged candidates by MaxSim over a token matrix: exactly from the slab,
or, over a built PQ tier, from the codes through kernel B4
(``ops/maxsim_adc.py``), whose scores are ranking proxies. Its cost is
charged to the owning Node's ``request`` breaker first; a denial keeps
every stage-1 score and answers with a typed "declined" status, never an
error. ``RERANK_DECISIONS`` counts admissions and denials, and so does
the process-shared ``estpu_hybrid_rerank_total`` family.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor.metrics import SHARED
from elasticsearch_tpu_torch.ops.bitvec import pack_mask, test_bits
from elasticsearch_tpu_torch.ops.maxsim_adc import maxsim_adc
from elasticsearch_tpu_torch.ops.pq import adc_luts
from elasticsearch_tpu_torch.ops.scoring import NEG_INF
from elasticsearch_tpu_torch.search.queries import (KnnQuery, Query,
                                                    parse_query)
from elasticsearch_tpu_torch.utils.errors import (CircuitBreakingException,
                                                  QueryParsingException)

#: stage-2 admission decisions by the request breaker: "admit", "decline"
RERANK_DECISIONS: "Counter[str]" = Counter()


def _rerank_family():
    """The decision counter, registered at the first decision (as the
    reference does: a process that never re-ranks exposes no family)."""
    return SHARED.counter(
        "estpu_hybrid_rerank_total",
        "Stage-2 MaxSim re-rank admission decisions by the request "
        "breaker", ("decision",))


def _f32(x: float) -> float:
    """``x`` rounded to f32: the reference's weights ride as f32 operands."""
    return float(np.float32(x))


def _ranks(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int64[D]: each doc's 0-based position in (-score, doc id) order,
    non-matches at -inf sinking last (a match's rank counts matches only)."""
    key = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-key, stable=True).indices
    pos = torch.arange(order.shape[0], device=order.device)
    return torch.empty_like(order).scatter_(0, order, pos)


def _rrf_contrib(scores, mask, rank_constant: float) -> torch.Tensor:
    """1 / (rank_constant + 1 + rank) over the engine's matches, 0 off."""
    c = _f32(np.float32(rank_constant) + np.float32(1.0))
    contrib = torch.reciprocal(c + _ranks(scores, mask).to(torch.float32))
    return torch.where(mask, contrib, torch.zeros_like(contrib))


def _fuse_math(lex_s, lex_m, vec_s, vec_m, weights: Tuple[float, float],
               rank_constant: float, *, method: str):
    """(fused f32[D], mask bool[D]) from the two engines' score rows."""
    wl, wv = _f32(weights[0]), _f32(weights[1])
    if method == "linear":
        fused = (wl * torch.where(lex_m, lex_s, torch.zeros_like(lex_s))
                 + wv * torch.where(vec_m, vec_s, torch.zeros_like(vec_s)))
    elif method == "rrf":
        fused = (wl * _rrf_contrib(lex_s, lex_m, rank_constant)
                 + wv * _rrf_contrib(vec_s, vec_m, rank_constant))
    else:  # parse_hybrid validates; unreachable from the DSL
        raise ValueError(f"unknown fusion method [{method}]")
    return fused, lex_m | vec_m


class HybridQuery(Query):
    """``hybrid`` query: a lexical sub-query, a kNN side and a fusion spec.

    Body shape (``parse_hybrid``)::

        {"hybrid": {
            "query":  {...any lexical DSL subtree...},
            "knn":    {"field": f, "query_vector": [...],
                       "num_candidates": n, "boost": b},
            "fusion": {"method": "rrf"|"linear", "weights": [wl, wv],
                       "rank_constant": 60},
            "rerank": {"query_vectors": [[...], ...], "window_size": w,
                       "pq": true|false}        # optional stage 2
        }}
    """

    def __init__(self, lexical: Query, knn: KnnQuery, method: str = "rrf",
                 weights: Tuple[float, float] = (1.0, 1.0),
                 rank_constant: float = 60.0,
                 rerank: Optional[dict] = None):
        self.lexical = lexical
        self.knn = knn
        self.method = method
        self.weights = (float(weights[0]), float(weights[1]))
        self.rank_constant = float(rank_constant)
        self.rerank = rerank

    def execute(self, ctx):
        """(fused scores f32[D], mask bool[D]). Liveness folds into both
        masks before fusion, so ranks ignore deleted docs."""
        live = ctx.segment.live
        lex_s, lex_m = self.lexical.score_or_mask(ctx)
        vec_s, vec_m = self.knn.score_or_mask(ctx)
        return _fuse_math(lex_s, lex_m & live, vec_s, vec_m & live,
                          self.weights, self.rank_constant,
                          method=self.method)


def parse_hybrid(body: dict) -> HybridQuery:
    """Parse a ``hybrid`` body; a malformed spec raises the typed 400."""
    if not isinstance(body, dict):
        raise QueryParsingException("hybrid query body must be an object")
    lex_body = body.get("query", body.get("lexical"))
    knn_body = body.get("knn", body.get("vector"))
    if lex_body is None or knn_body is None:
        raise QueryParsingException(
            "hybrid query requires both [query] (lexical) and [knn] "
            "(vector) clauses")
    lexical = parse_query(lex_body)
    if not isinstance(knn_body, dict) or "field" not in knn_body:
        raise QueryParsingException("hybrid [knn] clause requires [field]")
    vec = knn_body.get("query_vector", knn_body.get("vector"))
    if vec is None:
        raise QueryParsingException(
            "hybrid [knn] clause requires [query_vector]")
    filt = (parse_query(knn_body["filter"])
            if knn_body.get("filter") is not None else None)
    knn = KnnQuery(
        knn_body["field"], vec, k=int(knn_body.get("k", 10)),
        num_candidates=knn_body.get("num_candidates"),
        filter_=filt, boost=float(knn_body.get("boost", 1.0)),
        ann=knn_body.get("ann"), pq=knn_body.get("pq"))
    if knn.maxsim:
        raise QueryParsingException(
            "hybrid [knn] clause takes a single query_vector; put the "
            "token matrix in [rerank.query_vectors] (stage-2 MaxSim)")
    fusion = body.get("fusion") or {}
    method = str(fusion.get("method", "rrf")).lower()
    if method not in ("rrf", "linear"):
        raise QueryParsingException(
            f"unknown hybrid fusion method [{method}] "
            f"(expected rrf or linear)")
    weights = fusion.get("weights", (1.0, 1.0))
    try:
        wl, wv = (float(weights[0]), float(weights[1]))
    except (TypeError, ValueError, IndexError):
        raise QueryParsingException(
            f"hybrid fusion weights must be [w_lexical, w_vector], "
            f"got {weights!r}")
    if wl < 0 or wv < 0:
        raise QueryParsingException("hybrid fusion weights must be >= 0")
    rank_constant = float(fusion.get("rank_constant",
                                     fusion.get("rrf_k", 60.0)))
    rerank = body.get("rerank")
    if rerank is not None:
        if not isinstance(rerank, dict):
            raise QueryParsingException("hybrid [rerank] must be an object")
        toks = rerank.get("query_vectors", rerank.get("query_vector"))
        if toks is None:
            raise QueryParsingException(
                "hybrid [rerank] requires [query_vectors]")
        try:
            tm = np.asarray(toks, np.float32)
        except (TypeError, ValueError) as e:
            raise QueryParsingException(
                f"malformed hybrid rerank query_vectors: {e}")
        if tm.ndim == 1:
            tm = tm[None, :]
        if tm.ndim != 2:
            raise QueryParsingException(
                "hybrid rerank query_vectors must be a vector or a "
                "list of vectors")
        rerank = {
            "tokens": tm,
            "window_size": int(rerank.get("window_size", 32)),
            "field": rerank.get("field", knn.field),
            "pq": rerank.get("pq"),
        }
        if rerank["window_size"] < 1:
            raise QueryParsingException(
                "hybrid rerank window_size must be >= 1")
    return HybridQuery(lexical, knn, method=method, weights=(wl, wv),
                       rank_constant=rank_constant, rerank=rerank)


# ---------------------------------------------------------------------------
# stage 2: MaxSim window re-rank
# ---------------------------------------------------------------------------

def _rerank_cost_bytes(n: int, T: int, dims: int, pq) -> int:
    """Stage-2 device working set: candidate gather + [T, n] interaction
    (exact form) or code gather + [T, M, K] tables (ADC form), with 2x
    transient headroom."""
    if pq is not None:
        return 2 * (n * pq.M * 4 + T * pq.M * pq.K * 4 + n * T * 4)
    return 2 * (n * dims * 4 + T * n * 4 + T * dims * 4)


def _maxsim_window_exact(toks: torch.Tensor, cand: torch.Tensor,
                         metric: str) -> torch.Tensor:
    """f32[n]: per candidate row, the max over tokens of its similarity:
    (1 + s) / 2 for cosine and dot, 1 / (1 + |q - c|^2) for l2 (the
    direct difference, not the norm expansion). f32 products."""
    if metric == "cosine":
        qn = toks / torch.clamp(torch.linalg.vector_norm(
            toks, dim=-1, keepdim=True), min=1e-12)
        cn = cand / torch.clamp(torch.linalg.vector_norm(
            cand, dim=-1, keepdim=True), min=1e-12)
        s = (1.0 + qn @ cn.T) * 0.5
    elif metric in ("dot_product", "dot"):
        s = (1.0 + toks @ cand.T) * 0.5
    elif metric in ("l2_norm", "l2"):
        d2 = torch.sum((toks[:, None, :] - cand[None, :, :]) ** 2, dim=-1)
        s = 1.0 / (1.0 + d2)
    else:
        raise ValueError(f"unknown knn metric [{metric}]")
    return torch.amax(s, dim=0)


def maxsim_window_scores(ctx, vc, tokens, local_ids, *,
                         use_pq: Optional[bool] = None,
                         label: str = "hybrid_rerank") -> np.ndarray:
    """MaxSim scores f32[n] for ``local_ids`` of one segment: gather the
    window, score every (token, candidate) pair, max over tokens.
    Candidates without a vector, or deleted, come back -inf (a packed
    bit-vector test, as the PQ pre-filter does).

    The cost is charged to the segment's Node's ``request`` breaker
    first; a denial counts a "decline" and re-raises the typed
    CircuitBreakingException for the caller to keep its stage-1 scores.
    With a PQ tier (``use_pq`` True, or None under an ``ivf_pq``
    mapping) the scores are kernel B4's ADC proxies."""
    ids = np.asarray(local_ids, np.int64)
    n = int(ids.size)
    if n == 0:
        return np.empty(0, np.float32)
    toks = np.asarray(tokens, np.float32)
    if toks.ndim == 1:
        toks = toks[None, :]
    if toks.shape[1] != vc.dims:
        raise QueryParsingException(
            f"rerank query vectors have {toks.shape[1]} dims but field "
            f"[{vc.name}] is mapped with {vc.dims}")
    want_pq = use_pq
    if want_pq is None:
        # follow the mapping: a get_pq probe on an unmapped field would
        # train a codebook
        fm = ctx.mappings.get(vc.name)
        opts = getattr(fm, "index_options", None) if fm is not None else None
        want_pq = bool(opts) and opts.get("type") == "ivf_pq"
    pq = vc.get_pq(ctx.segment.max_docs) if want_pq else None
    breaker = ctx.segment.residency.breakers.breaker("request")
    est = _rerank_cost_bytes(n, toks.shape[0], vc.dims, pq)
    try:
        breaker.break_or_reserve(est, label)
    except CircuitBreakingException:
        RERANK_DECISIONS["decline"] += 1
        _rerank_family().labels("decline").inc()
        raise
    try:
        RERANK_DECISIONS["admit"] += 1
        _rerank_family().labels("admit").inc()
        dev = ctx.device
        ids_dev = torch.from_numpy(ids).to(dev)
        toks_dev = torch.from_numpy(toks).to(dev)
        if pq is not None:
            luts = adc_luts(toks_dev, pq.codebooks, vc.similarity)
            scores = maxsim_adc(pq.codes_dev()[ids_dev].contiguous(), luts)
        else:
            scores = _maxsim_window_exact(toks_dev, vc.vecs[ids_dev],
                                          vc.similarity)
        ok = test_bits(pack_mask(vc.exists & ctx.segment.live), ids_dev)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        return scores.cpu().numpy()
    finally:
        breaker.release(est)


def apply_hybrid_rerank(docs, query: HybridQuery, mappings, analysis) -> dict:
    """Stage 2 over the merged stage-1 candidates: re-score the first
    ``window_size`` by MaxSim and re-order the window by (-score, seg_id,
    local_id). Returns the typed status for the response's ``hybrid``
    section. A breaker denial leaves every stage-1 score as it was."""
    from elasticsearch_tpu_torch.search.context import SegmentContext

    spec = query.rerank
    window = docs[: min(spec["window_size"], len(docs))]
    if not window:
        return {"rerank": "applied", "window": 0}
    by_seg: Dict[int, list] = {}
    for d in window:
        by_seg.setdefault(id(d.seg), []).append(d)
    new_scores: Dict[int, float] = {}
    try:
        for seg_docs in by_seg.values():
            seg = seg_docs[0].seg
            vc = seg.vectors.get(spec["field"])
            if vc is None:
                continue  # no vectors in this segment: keep stage-1 order
            ctx = SegmentContext(seg, mappings, analysis)
            scores = maxsim_window_scores(
                ctx, vc, spec["tokens"], [d.local_id for d in seg_docs],
                use_pq=spec.get("pq"))
            for d, s in zip(seg_docs, scores):
                if np.isfinite(s):
                    new_scores[id(d)] = float(s)
    except CircuitBreakingException as e:
        return {"rerank": "declined", "degraded_to": "stage1",
                "reason": {"type": e.error_type, "reason": str(e)}}
    for d in window:
        if id(d) in new_scores:
            d.score = new_scores[id(d)]
    window.sort(key=lambda d: (-d.score, d.seg.seg_id, d.local_id))
    docs[: len(window)] = window
    return {"rerank": "applied", "window": len(window)}
