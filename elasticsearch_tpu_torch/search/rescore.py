"""Rescore: re-rank the top window of the query phase's results.

Port of elasticsearch_tpu/search/rescore.py (ES RescorePhase +
QueryRescorer): after the query phase collects ``window_size`` top docs,
the rescore query runs over them and the final score combines the
original and rescore scores by ``score_mode`` (total, multiply, avg, max,
min), weighted by ``query_weight`` and ``rescore_query_weight``.

A query rescore runs the rescore query per segment through the generic
(scores, mask) contract and reads the window docs' entries. A ``knn``
rescore query without a filter takes the stage-2 window path instead
(``search/hybrid.py::maxsim_window_scores``): only the window's
candidates are scored, every admissible one counts as matched, and a
``request``-breaker denial keeps the whole window on its original scores.

A query rescore's joins (``has_child`` and the like) prepare over the
shard's segments first (``joins.prepare_tree``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from elasticsearch_tpu_torch.search.context import SegmentContext
from elasticsearch_tpu_torch.search.joins import prepare_tree
from elasticsearch_tpu_torch.search.queries import KnnQuery, parse_query
from elasticsearch_tpu_torch.utils.errors import (CircuitBreakingException,
                                                  SearchParseException)


def parse_rescore(spec) -> List[dict]:
    """Normalise the rescore body: a dict or a list of
    {"window_size": N, "query": {"rescore_query": {...}, ...}}."""
    if spec is None:
        return []
    specs = spec if isinstance(spec, list) else [spec]
    out = []
    for s in specs:
        q = s.get("query")
        if not isinstance(q, dict) or "rescore_query" not in q:
            raise SearchParseException(
                "rescore requires [query][rescore_query]")
        out.append({
            "window_size": int(s.get("window_size", 10)),
            "rescore_query": q["rescore_query"],
            "query_weight": float(q.get("query_weight", 1.0)),
            "rescore_query_weight": float(q.get("rescore_query_weight", 1.0)),
            "score_mode": q.get("score_mode", "total"),
        })
    return out


def _combine(orig: float, resc: float, matched: bool, spec: dict) -> float:
    qw, rw = spec["query_weight"], spec["rescore_query_weight"]
    if not matched:
        # a doc the rescore query misses keeps its weighted original score
        return orig * qw
    mode = spec["score_mode"]
    a, b = orig * qw, resc * rw
    if mode == "total":
        return a + b
    if mode == "multiply":
        return a * b
    if mode == "avg":
        return (a + b) / 2.0
    if mode == "max":
        return max(a, b)
    if mode == "min":
        return min(a, b)
    raise SearchParseException(f"rescore score_mode [{mode}] invalid")


def _by_segment(window) -> Dict[int, list]:
    by_seg: Dict[int, list] = {}
    for d in window:
        by_seg.setdefault(d.seg.seg_id, []).append(d)
    return by_seg


def apply_rescore(docs, rescore_specs: List[dict], mappings,
                  analysis, segments=None) -> None:
    """Re-rank the top window of ``docs`` (ShardDocs in query-phase
    order) in place, once per spec, in turn; ``segments``: the shard's,
    over which a rescore query's joins prepare."""
    for spec in rescore_specs:
        window = docs[: spec["window_size"]]
        if not window:
            continue
        q = parse_query(spec["rescore_query"])
        if isinstance(q, KnnQuery) and q.filter is None:
            _rescore_knn_window(window, q, spec, mappings, analysis)
        else:
            if segments is not None:
                prepare_tree(q, segments, mappings, analysis)
            for seg_docs in _by_segment(window).values():
                ctx = SegmentContext(seg_docs[0].seg, mappings, analysis)
                scores, mask = q.score_or_mask(ctx)
                sc = scores.cpu().numpy()
                mk = mask.cpu().numpy()
                for d in seg_docs:
                    d.score = _combine(d.score, float(sc[d.local_id]),
                                       bool(mk[d.local_id]), spec)
        window.sort(key=lambda d: (-d.score, d.seg.seg_id, d.local_id))
        docs[: spec["window_size"]] = window


def _rescore_knn_window(window, q: KnnQuery, spec: dict, mappings,
                        analysis) -> None:
    """knn/MaxSim rescore through the stage-2 window path. All or
    nothing: scores apply only once every segment's window has scored,
    so a denial midway leaves the whole window on its original scores."""
    from elasticsearch_tpu_torch.search.hybrid import maxsim_window_scores

    combined = []
    try:
        for seg_docs in _by_segment(window).values():
            seg = seg_docs[0].seg
            vc = seg.vectors.get(q.field)
            if vc is None:
                # no vectors in this segment: the rescore query matches none
                combined += [(d, _combine(d.score, 0.0, False, spec))
                             for d in seg_docs]
                continue
            ctx = SegmentContext(seg, mappings, analysis)
            scores = maxsim_window_scores(
                ctx, vc, q.tokens, [d.local_id for d in seg_docs],
                use_pq=q.pq, label="knn_rescore")
            for d, s in zip(seg_docs, scores):
                matched = bool(np.isfinite(s))
                combined.append((d, _combine(
                    d.score, float(s) * q.boost if matched else 0.0,
                    matched, spec)))
    except CircuitBreakingException:
        return  # typed degrade: the query phase's order stands
    for d, s in combined:
        d.score = s
