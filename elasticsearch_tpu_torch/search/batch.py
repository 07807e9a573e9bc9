"""Batched ``_msearch`` execution: one device pass per segment for a
whole batch of searches.

Port of elasticsearch_tpu/search/batch.py. ES executes msearch items as
independent searches on the search thread pool; here the eligible
subset of a batch (simple bodies whose queries are same-field BM25 term
groups, or brute-force/MaxSim ``knn`` queries, on one index) shares one
device pass per segment:

- tier 1, every query a pure-dense term group: one launch of kernel B1's
  batched form (``queries.fused_bm25_topk_batch``);
- tier 2, term groups with scatter tails: an f32 product plus the tails'
  scatters, in chunks of 64 queries (``queries.hybrid_bm25_topk_batch``);
- on a multi-shard index, the term groups go to the mesh first
  (``parallel/mesh_service.py::try_mesh_msearch``: one postings round
  over every shard);
- ``knn`` (brute force or MaxSim): one launch of kernel B2 over every
  request's tokens, then a per-request dedup-by-max merge
  (``knn_topk_fused_batch``).

The product path behind ``Node.msearch`` and the serving coalescer's
flush (``serving/coalescer.py``). Eligibility is per item: an ineligible
item runs on its own, and a malformed query becomes an ES-shaped item
failure. ``hybrid`` bodies never batch in the port (they run in
sequence; the reference's one-program hybrid tier is left out with
``hybrid_fused_topk``), nor do filtered or IVF ``knn`` bodies. An index
with a segment of nested docs serves every item on its own (the tiers
score every doc, and a search counts roots only), as the reference does.

A batch reads one copy of each shard, picked once for the whole batch
(``ReplicationGroup.reader``: ``preference``, else the next copy in
turn), and counts each shard's queries and fetches as its sequential
searches would (``SearchStats``). The reference's power-of-two batch
padding, which bounded recompiles on the TPU, is not ported.
"""
from __future__ import annotations

import operator
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.monitor.programs import REGISTRY, static_sig
from elasticsearch_tpu_torch.ops.knn import knn_topk, merge_candidate_topk
from elasticsearch_tpu_torch.parallel.mesh_service import try_mesh_msearch
from elasticsearch_tpu_torch.search.context import SegmentContext
from elasticsearch_tpu_torch.search.queries import (KnnQuery,
                                                    _fused_eligible_terms,
                                                    fused_bm25_topk_batch,
                                                    hybrid_bm25_topk_batch,
                                                    parse_query)
from elasticsearch_tpu_torch.search.service import ShardDoc
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

#: an item with any other key (``aggs`` among them) runs sequentially
_ALLOWED_KEYS = {"query", "size", "from", "_source"}

#: 2.0 msearch reports error entries as strings like
#: "IndexMissingException[no such index]" — legacy class-name mapping
_LEGACY_ERROR_NAMES = {"index_not_found_exception": "IndexMissingException"}


def msearch_error_entry(e: ElasticsearchTpuException) -> dict:
    """ES-shaped (2.0-style) msearch item failure for a typed error."""
    name = _LEGACY_ERROR_NAMES.get(e.error_type, e.error_type)
    return {"error": f"{name}[{e}]", "status": e.status}


def split_batchable(bodies: List[dict]) -> Tuple[
        List[int], Dict[int, object], Dict[int, ElasticsearchTpuException]]:
    """Per-item batch eligibility over an msearch body list.

    Returns ``(eligible, parsed, errors)``: positions whose bodies may
    batch (simple key set, parseable query, sane result window) with
    their parsed query trees, and positions whose queries raised a typed
    parse error, which become per-item failures. Anything else is left
    to the sequential path, whose behaviour is the reference."""
    eligible: List[int] = []
    parsed: Dict[int, object] = {}
    errors: Dict[int, ElasticsearchTpuException] = {}
    for i, b in enumerate(bodies):
        if not isinstance(b, dict) or set(b) - _ALLOWED_KEYS:
            continue
        try:
            q = parse_query(b.get("query"))
        except ElasticsearchTpuException as e:
            errors[i] = e
            continue
        except Exception:
            continue  # unexpected: the sequential path decides
        try:
            frm, size = int(b.get("from", 0)), int(b.get("size", 10))
        except (TypeError, ValueError):
            continue
        if not 1 <= frm + size <= 10_000:
            continue
        eligible.append(i)
        parsed[i] = q
    return eligible, parsed, errors


def _probe_segment(svc):
    """A segment of any copy (bucketing reads only its mappings and
    fields), or None when no copy has one."""
    for g in svc.groups:
        for sh in g.copies:
            if sh.segments:
                return sh.segments[0]
    return None


def _batch_bucket(svc, ctx, query) -> Optional[str]:
    """The micro-batch bucket key for ``query`` (None = sequential).

    BM25 same-field term groups bucket on their field (one dense block a
    launch). kNN queries, single-vector and MaxSim, bucket on (field,
    num_candidates, k): a bucket's token matrices stack into one B2
    launch. Filtered and IVF single-vector queries stay sequential (the
    batch is exact brute force), and so do ``hybrid`` bodies."""
    if isinstance(query, KnnQuery):
        vc = ctx.segment.vectors.get(query.field)
        if vc is None or query.filter is not None:
            return None
        if query.tokens.shape[1] != vc.dims:
            return None  # the sequential path raises the typed error
        if not query.maxsim and query._use_ann(ctx):
            return None
        return (f"__knn__:{query.field}:nc{query.num_candidates}"
                f":k{query.k}")
    # the field alone decides: the weights (and their idf) are not needed
    e = _fused_eligible_terms(ctx, query, idf=False)
    return None if e is None else e[0]


def batch_field(svc, query) -> Optional[str]:
    """The micro-batch bucket ``query`` would coalesce into (None = not
    batchable), probed on the index's first segment; a tier may still
    refuse at execution time, and the caller then runs per request."""
    probe = _probe_segment(svc)
    if probe is None or probe.has_nested:
        return None
    try:
        ctx = SegmentContext(probe, svc.mappings, svc.analysis,
                             index_name=svc.name)
        return _batch_bucket(svc, ctx, query)
    except Exception:
        return None


def knn_topk_fused_batch(ctx, queries, k: int):
    """Batched brute-force kNN / MaxSim over one segment: every request's
    tokens stacked into one [Q * T, dims] block (shorter token lists
    repeat-padded: a duplicated token never changes a max), one launch of
    kernel B2 in f32 (``precise``) at kc = min(max(num_candidates, k),
    D) per token, then a dedup-by-max merge per request
    (``ops/knn.py::merge_candidate_topk``). Returns (vals [Q, k'], ids
    [Q, k'], totals [Q]) as numpy, k' = min(k, kc), or None when the
    batch is not uniform (mixed fields, num_candidates or knn k, a
    filter, a dims mismatch).

    The sequential path runs the same B2 rows and keeps the per-doc max
    over its tokens' candidates, so the two agree. ``k`` of kc is the
    knn's own, as the sequential path's ``KnnQuery._select`` takes it
    (the reference's batch widens kc to the page size instead)."""
    if not queries or not all(isinstance(q, KnnQuery) for q in queries):
        return None
    q0 = queries[0]
    if any(q.field != q0.field or q.filter is not None
           or q.num_candidates != q0.num_candidates or q.k != q0.k
           for q in queries):
        return None
    vc = ctx.segment.vectors.get(q0.field)
    if vc is None or any(q.tokens.shape[1] != vc.dims for q in queries):
        return None
    Q = len(queries)
    T = max(q.tokens.shape[0] for q in queries)
    toks = np.empty((Q, T, vc.dims), np.float32)
    for i, q in enumerate(queries):
        t = q.tokens
        toks[i] = np.tile(t, (-(-T // t.shape[0]), 1))[:T]
    lv = vc.exists & ctx.segment.live
    kc = int(min(max(q0.num_candidates, q0.k), ctx.D))
    # the reference's batched kNN tier program, open to the copy back
    with REGISTRY.timed("batch_knn_fused", static_sig(
            QT=pow2_bucket(Q * T, 1), D=pow2_bucket(ctx.D), kc=kc),
            field=q0.field):
        flat = torch.from_numpy(toks.reshape(Q * T, vc.dims)).to(ctx.device)
        vals, idx = knn_topk(flat, vc.vecs, lv, k=kc, metric=vc.similarity,
                             precise=True)
        best_v, best_i, n_unique = merge_candidate_topk(
            vals.reshape(Q, T * kc), idx.reshape(Q, T * kc), k=min(k, kc))
        boosts = torch.tensor([q.boost for q in queries],
                              dtype=torch.float32, device=ctx.device)
        out = torch.cat(
            [(best_v * boosts[:, None]).view(torch.int32), best_i,
             n_unique.to(torch.int64).view(-1, 1).view(torch.int32)],
            dim=1).cpu().numpy()  # one copy back
    kernels.record("knn_fused_batch", Q)
    kb = best_v.shape[1]
    return (out[:, :kb].view(np.float32), out[:, kb: 2 * kb],
            out[:, 2 * kb:].view(np.int64)[:, 0])


def execute_batch(svc, bodies: List[dict], queries: Optional[list] = None,
                  preference: Optional[str] = None
                  ) -> Optional[List[dict]]:
    """Batched execution of uniform single-search bodies over one index:
    one device pass per segment (or one mesh round over every shard),
    per-request responses in order, or None when the tiers refuse (the
    sequential path is always correct)."""
    t0 = time.perf_counter()
    if queries is None:
        try:
            queries = [parse_query(b.get("query")) for b in bodies]
        except ElasticsearchTpuException:
            return None  # the caller's sequential path reports the error
    sizes = [(int(b.get("from", 0)), int(b.get("size", 10)))
             for b in bodies]
    k = max(frm + size for frm, size in sizes)
    if not 1 <= k <= 10_000:
        return None
    Q = len(bodies)
    searchers = [g.reader(preference).searcher for g in svc.groups]
    # per query its candidates (-score, shard, seg_id, local, segment)
    cands: List[list] = [[] for _ in range(Q)]
    totals = np.zeros(Q, np.int64)
    all_knn = all(isinstance(q, KnnQuery) for q in queries)
    mesh_served = False
    if not all_knn and len(searchers) > 1 and svc._mesh_enabled():
        # the whole batch's query phase over every shard in one round a
        # segment row; a refusal falls through to the per-segment tiers
        mout = try_mesh_msearch(svc, searchers, queries, k)
        if mout is not None:
            cands, mtotals = mout
            totals += np.asarray(mtotals, np.int64)
            mesh_served = True
    if not mesh_served:
        for pos, s in enumerate(searchers):
            for seg in s.segments:
                if seg.has_nested:
                    return None  # roots only: the sequential path
                ctx = SegmentContext(seg, svc.mappings, svc.analysis,
                                     index_name=svc.name)
                kb = min(k, seg.max_docs)
                if all_knn:
                    out = knn_topk_fused_batch(ctx, queries, kb)
                else:
                    out = fused_bm25_topk_batch(ctx, queries, kb)
                    if out is None:
                        out = hybrid_bm25_topk_batch(ctx, queries, kb)
                if out is None:
                    return None
                vals, ids, tot = out
                totals += tot
                # a match scores > 0: B1's non-matches score <= 0, the
                # other tiers' -inf
                keep = (np.isfinite(vals) & (vals > 0)).tolist()
                sid = seg.seg_id
                for qi, (vr, ir, kr) in enumerate(zip(
                        vals.tolist(), ids.tolist(), keep)):
                    cands[qi] += [(-x, pos, sid, i, seg)
                                  for x, i, ok in zip(vr, ir, kr) if ok]
    q_ms = (time.perf_counter() - t0) * 1000
    for s in searchers:
        # counted as Q sequential requests would be
        s.stats.on_query(q_ms / len(searchers), n=Q)

    by_seg = operator.itemgetter(0, 2, 3)  # (-score, seg_id, local)
    by_shard = operator.itemgetter(0, 1, 3)  # (-score, shard, local)
    responses = []
    for qi, body in enumerate(bodies):
        t_resp = time.perf_counter()
        frm, size = sizes[qi]
        k_q = frm + size
        # the sequential path's order: per shard (-score, seg_id, local)
        # cut at k (query_phase), then (-score, shard, local) globally
        # (search_shards)
        per_shard: Dict[int, list] = {}
        for t in cands[qi]:
            per_shard.setdefault(t[1], []).append(t)
        lst: list = []
        for pos in sorted(per_shard):
            lst += sorted(per_shard[pos], key=by_seg)[:k_q]
        lst.sort(key=by_shard)
        page = [ShardDoc(pos, seg, local, -neg)
                for neg, pos, _sid, local, seg in lst[frm: frm + size]]
        hits: List[Optional[dict]] = [None] * len(page)
        at: Dict[int, List[int]] = {}
        for n, d in enumerate(page):
            at.setdefault(d.shard_ord, []).append(n)
        for pos, ns in at.items():
            tf = time.perf_counter()
            for n, h in zip(ns, searchers[pos].fetch_phase(
                    [page[n] for n in ns], body, svc.name)):
                hits[n] = h
            searchers[pos].stats.on_fetch((time.perf_counter() - tf) * 1e3)
        responses.append({
            # this request's cost: the shared query phase + its own fetch
            "took": int(q_ms + (time.perf_counter() - t_resp) * 1000),
            "timed_out": False,
            "_shards": {"total": len(searchers),
                        "successful": len(searchers), "failed": 0},
            "hits": {
                "total": int(totals[qi]),
                "max_score": -lst[0][0] if lst else None,
                "hits": hits,
            },
        })
    return responses


def try_batched_msearch(svc, bodies: List[dict], min_batch: int = 2,
                        preference: Optional[str] = None
                        ) -> Optional[List[Optional[dict]]]:
    """Partial batch execution over one index.

    Returns None when nothing amortizes (the caller runs every item on
    its own), else a per-item list aligned with ``bodies``: a response
    for items the batch served, an msearch error entry for typed
    malformed-query items, and None for the remainder the caller runs
    itself (ineligible bodies, other buckets, tier refusals)."""
    eligible, parsed, errors = split_batchable(bodies)
    out: List[Optional[dict]] = [None] * len(bodies)
    for i, e in errors.items():
        out[i] = msearch_error_entry(e)
    # one batch per call: the largest bucket; stragglers run on their own
    probe = _probe_segment(svc)
    groups: Dict[str, List[int]] = {}
    if probe is not None and not probe.has_nested:
        ctx = SegmentContext(probe, svc.mappings, svc.analysis,
                             index_name=svc.name)
        for i in eligible:
            try:
                bucket = _batch_bucket(svc, ctx, parsed[i])
            except Exception:
                continue  # the sequential path decides
            if bucket is not None:
                groups.setdefault(bucket, []).append(i)
    batch_idx = max(groups.values(), key=len, default=[])
    if len(batch_idx) < min_batch:
        return out if errors else None
    responses = execute_batch(svc, [bodies[i] for i in batch_idx],
                              queries=[parsed[i] for i in batch_idx],
                              preference=preference)
    if responses is None:
        return out if errors else None
    for i, r in zip(batch_idx, responses):
        out[i] = r
    return out
