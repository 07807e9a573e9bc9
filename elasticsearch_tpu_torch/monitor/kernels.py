"""Kernel-dispatch counters: which device route served each query.

Copy of elasticsearch_tpu/monitor/kernels.py (the port keeps its own;
the ``agg_*`` names are the port's).
Dispatch decisions happen in host code (query execution, prim build,
mesh_service routing), so each ``record()`` call site marks one served
request component.

Names the port records:
  bm25_scatter        pure scatter-add postings scoring (host or mesh)
  bm25_hybrid         dense-impact row gather + scatter tail
  bm25_fused_topk     kernel B1's fused dense top-k (no [D] score row); a
                      batched _msearch tier 1 records its query count
  bm25_hybrid_tf32_refused
                      a batched tier 2 refused: TF32 was on for the f32
                      product (its batch then runs query by query)
  knn_fused_topk      kernel B2's fused scores + mask + top-k, brute force
  knn_fused_batch     queries served by a batched kNN/MaxSim B2 launch
  mesh_search         request served by the mesh product path
  mesh_fallback_total request fell back to the host per-shard loop
  mesh_msearch        a batch's query phase served by the mesh's round
  mesh_msearch_fallback
                      a batch the mesh declined (the host tiers served it)
  mesh_host_by_design request routed to the host loop ON PURPOSE (IVF
                      probing, MaxSim, hybrid) — not a fallback
  executor_prep_hit   a search round reused a prepared-query memo entry
                      (its device inputs: no build, no copy in)
  executor_prep_miss  a memoizable round built its inputs fresh
  executor_data_hit   a segment round's stacked device data was reused
  executor_data_miss  a segment round's stacked device data was built
  agg_terms_device    a mesh request's aggs (keyword terms, no subs)
                      were counted in its rounds on the card
  agg_mask            a mesh request's aggs ran the host-side collectors
                      over its rounds' match masks
  span_device         a span query ran as a program on the card over a
                      segment (near, not, first, term unions)
  span_host_walk      a span query's deeper tree took the host interval
                      walk over a segment
  span_clause_truncated
                      the host walk cut a clause at MAX_SPANS_PER_CLAUSE
                      spans in a doc (search/spans.py)
  ivf_cache_hit       an IVF quantizer loaded from the content-addressed
                      blob cache instead of a k-means (index/ivf_cache.py)
  pq_cache_hit        a PQ tier loaded from the blob cache
  ivf_build           an IVF quantizer built by k-means (then stored)
  pq_build            a PQ tier trained and encoded (then stored)
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = defaultdict(int)


def record(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def launches() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process: the count
    its wrapper keeps where it launches it on the card (a CPU tensor's
    plain twin counts nothing). ``Node.nodes_stats`` serves it under
    ``indices.search.launches``."""
    from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk, \
        maxsim_adc

    return {"bm25_dense_topk": bm25_topk.LAUNCHES,
            "knn_topk": knn_topk.LAUNCHES, "adc_scores": adc.LAUNCHES,
            "maxsim_adc": maxsim_adc.LAUNCHES}


def reset() -> None:
    """Test isolation only."""
    with _LOCK:
        _COUNTS.clear()
