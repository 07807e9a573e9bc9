"""Search service: query-then-fetch over a shard's segments.

Port of the host loop of elasticsearch_tpu/search/service.py for the
request shape of the slice: a query with ``from``/``size``, ``_source``
on, off or filtered, ``version``, ``rescore`` and ``aggs`` /
``aggregations`` (``search/aggregations/``). Sort, search_after,
min_score, scroll, highlight, profile, terminate_after, timeout and the
other request keys come with ROADMAP A6b and raise a typed
SearchParseException.

Per segment the query runs the fused dense-impact top-k (kernel B1) when
the query is a pure-dense term group and nothing rescores or aggregates,
else the generic score/mask tensors followed by a masked top-k; the
aggregations collect each segment's partial over the same mask that
counts ``hits.total``, and ``search_shards`` reduces the partials of
every shard in shard and segment order. Candidates merge
per shard by ``(-score, seg_id, local_id)``; a ``hybrid`` query's stage-2
re-rank and then the rescorers re-order the merged window; shards merge
by ``(-score, shard_ord, local_id)``, the reference's orders.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.ops.scoring import count_mask, topk_with_mask
from elasticsearch_tpu_torch.search.aggregations import (parse_aggs,
                                                         reduce_aggs,
                                                         run_aggs)
from elasticsearch_tpu_torch.search.context import GlobalStats, SegmentContext
from elasticsearch_tpu_torch.search.hybrid import (HybridQuery,
                                                   apply_hybrid_rerank)
from elasticsearch_tpu_torch.search.queries import fused_bm25_topk, parse_query
from elasticsearch_tpu_torch.search.rescore import apply_rescore, parse_rescore
from elasticsearch_tpu_torch.utils.errors import SearchParseException

#: request keys the port serves; any other key raises
_SUPPORTED_KEYS = frozenset({"query", "size", "from", "_source", "version",
                             "rescore", "aggs", "aggregations"})


def check_body(body: dict) -> None:
    unsupported = sorted(set(body) - _SUPPORTED_KEYS)
    if unsupported:
        raise SearchParseException(
            f"search request keys {unsupported} are not yet in the PyTorch "
            f"port")


@dataclass
class ShardDoc:
    """One candidate doc from the query phase (pre-fetch)."""

    shard_ord: int
    seg: Any  # TpuSegment
    local_id: int
    score: float


@dataclass
class QueryPhaseResult:
    docs: List[ShardDoc]
    total_hits: int
    max_score: float
    # a hybrid query's stage-2 status: {"rerank": "applied"|"declined", ...}
    hybrid: Optional[dict] = None
    # {"_list": [per-segment partials], "_aggs": the parsed agg tree}
    agg_partials: Optional[dict] = None


class ShardSearcher:
    """Executes search phases against one shard (list of segments).
    ``version_of(doc_id)`` answers ``version: true`` requests."""

    def __init__(self, segments, mappings, analysis, shard_ord: int = 0,
                 index_name: str = "",
                 version_of: Optional[Callable[[str], Optional[int]]] = None):
        self.segments = segments
        self.mappings = mappings
        self.analysis = analysis
        self.shard_ord = shard_ord
        self.index_name = index_name
        self.version_of = version_of

    def query_phase(self, body: dict,
                    global_stats: Optional[GlobalStats] = None
                    ) -> QueryPhaseResult:
        check_body(body)
        query = parse_query(body.get("query"))
        aggs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0))
        if frm + size > 10_000:
            # explicit, like ES's index.max_result_window — never a silent cap
            raise SearchParseException(
                f"Result window is too large, from + size must be less than "
                f"or equal to: [10000] but was [{frm + size}]. Use scroll or "
                f"search_after for deep pagination.")
        k = min(max(size + frm, 1), 10_000)
        rescore_specs = parse_rescore(body.get("rescore") or None)
        if rescore_specs:
            # the candidates must cover the largest rescore window
            k = min(max([k] + [s["window_size"] for s in rescore_specs]),
                    10_000)
        docs: List[ShardDoc] = []
        total = 0
        max_score = float("-inf")
        agg_partials: List[dict] = []
        for seg in self.segments:
            ctx = SegmentContext(seg, self.mappings, self.analysis,
                                 global_stats, index_name=self.index_name)
            kk = min(k, seg.max_docs)
            # a rescore re-reads scores (B1's bf16 scores would show) and
            # the aggregations read the mask, which B1 does not make
            fused = None if rescore_specs or aggs \
                else fused_bm25_topk(ctx, query, kk)
            if fused is not None:
                vals, ids, seg_total = fused
                total += seg_total
                for v, i in zip(vals, ids):
                    # matches score strictly > 0; the live mask maps
                    # non-matches to -inf or a 0.0 dense row
                    if np.isfinite(v) and v > 0:
                        max_score = max(max_score, float(v))
                        docs.append(ShardDoc(self.shard_ord, seg, int(i),
                                             float(v)))
                continue
            scores, mask = query.score_or_mask(ctx)
            mask = mask & seg.live
            if aggs:
                agg_partials.append(run_aggs(aggs, ctx, mask))
            vals, idx = topk_with_mask(scores, mask, k=kk)
            total += count_mask(mask)
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy()
            for v, i in zip(vals, idx):
                if np.isfinite(v):
                    max_score = max(max_score, float(v))
                    docs.append(ShardDoc(self.shard_ord, seg, int(i),
                                         float(v)))
        docs.sort(key=lambda d: (-d.score, d.seg.seg_id, d.local_id))
        docs = docs[:k]
        hybrid = None
        if isinstance(query, HybridQuery) and query.rerank is not None:
            # stage 2 over the merged window; a breaker denial comes back
            # as the typed "declined" status with stage-1 scores untouched
            hybrid = apply_hybrid_rerank(docs, query, self.mappings,
                                         self.analysis)
            max_score = max((d.score for d in docs if np.isfinite(d.score)),
                            default=float("-inf"))
        if rescore_specs:
            apply_rescore(docs, rescore_specs, self.mappings, self.analysis)
            docs = docs[: min(max(size + frm, 1), 10_000)]
            max_score = max((d.score for d in docs), default=float("-inf"))
        return QueryPhaseResult(
            docs=docs, total_hits=total,
            max_score=max_score if docs and max_score != float("-inf")
            else float("nan"), hybrid=hybrid,
            agg_partials={"_list": agg_partials, "_aggs": aggs}
            if aggs else None)

    def fetch_phase(self, docs: List[ShardDoc], body: dict,
                    index_name: str = "") -> List[dict]:
        src_filter = body.get("_source", True)
        want_version = bool(body.get("version", False))
        hits = []
        for d in docs:
            tcol = d.seg.keywords.get("_type")
            tvals = tcol.host_values[d.local_id] if tcol is not None else None
            doc_id = d.seg.ids[d.local_id]
            hit: Dict[str, Any] = {
                "_index": self.index_name or index_name,
                "_type": tvals[0] if tvals else "_doc",
                "_id": doc_id,
                "_score": d.score,
            }
            if want_version and self.version_of is not None:
                hit["_version"] = self.version_of(doc_id)
            filtered = _filter_source(d.seg.sources[d.local_id], src_filter)
            if filtered is not None:
                hit["_source"] = filtered
            hits.append(hit)
        return hits


def search_shards(searchers: List[ShardSearcher], body: dict,
                  index_name: str = "",
                  global_stats: Optional[GlobalStats] = None) -> dict:
    """Query-then-fetch across shards, ES response shape."""
    t0 = time.perf_counter()
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    results = []
    for pos, s in enumerate(searchers):
        r = s.query_phase(body, global_stats)
        # fetch resolves searchers positionally in THIS list
        for d in r.docs:
            d.shard_ord = pos
        results.append(r)
    all_docs: List[ShardDoc] = []
    total = 0
    max_score = float("-inf")
    for r in results:
        all_docs.extend(r.docs)
        total += r.total_hits
        if r.docs and not np.isnan(r.max_score):
            max_score = max(max_score, r.max_score)
    all_docs.sort(key=lambda d: (-d.score, d.shard_ord, d.local_id))
    page = all_docs[frm: frm + size]

    by_shard: Dict[int, List[ShardDoc]] = {}
    for d in page:
        by_shard.setdefault(d.shard_ord, []).append(d)
    fetched: Dict[Tuple[int, int, int], dict] = {}
    for shard_ord, docs in by_shard.items():
        for d, h in zip(docs, searchers[shard_ord].fetch_phase(
                docs, body, index_name)):
            fetched[(d.shard_ord, id(d.seg), d.local_id)] = h
    hits = [fetched[(d.shard_ord, id(d.seg), d.local_id)] for d in page]
    response: Dict[str, Any] = {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": len(searchers), "successful": len(searchers),
                    "failed": 0},
        "hits": {
            "total": total,
            "max_score": None if max_score == float("-inf") else max_score,
            "hits": hits,
        },
    }
    # stage-2 status: a denial on any shard marks the whole response as
    # degraded to stage 1, with per-shard counts
    statuses = [r.hybrid for r in results if r.hybrid is not None]
    if statuses:
        declined = [h for h in statuses if h.get("rerank") == "declined"]
        if declined:
            response["hybrid"] = dict(
                declined[0], shards_declined=len(declined),
                shards_applied=len(statuses) - len(declined))
        else:
            response["hybrid"] = {
                "rerank": "applied",
                "window": sum(int(h.get("window", 0)) for h in statuses)}
    present = [r.agg_partials for r in results if r.agg_partials]
    if present:
        response["aggregations"] = reduce_aggs(
            present[0]["_aggs"], [p for r in present for p in r["_list"]])
    return response


# ---------------------------------------------------------------------------
# source filtering (fetch/source/FetchSourceSubPhase semantics)
# ---------------------------------------------------------------------------

def _filter_source(src: Optional[dict], spec) -> Optional[dict]:
    import fnmatch

    if src is None or spec is False:
        return None
    if spec is True or spec is None:
        return src
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        includes, excludes = spec, []
    else:
        includes = spec.get("includes", spec.get("include", []))
        excludes = spec.get("excludes", spec.get("exclude", []))
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]

    def _could_descend(path: str, pat: str) -> bool:
        """True when `pat` could match somewhere strictly below `path`."""
        psegs, segs = path.split("."), pat.split(".")
        if len(psegs) >= len(segs):
            return False
        return all(fnmatch.fnmatch(ps, sg) for ps, sg in zip(psegs, segs))

    def _walk(obj, prefix: str, in_included: bool = False):
        if not isinstance(obj, dict):
            return obj
        out = {}
        for k, v in obj.items():
            path = f"{prefix}{k}"
            if excludes and any(fnmatch.fnmatch(path, pat)
                                for pat in excludes):
                continue
            inc = (in_included or not includes
                   or any(fnmatch.fnmatch(path, pat) for pat in includes))
            if inc:
                out[k] = (_walk(v, f"{path}.", True)
                          if isinstance(v, dict) and excludes else v)
            elif isinstance(v, dict) and any(_could_descend(path, pat)
                                             for pat in includes):
                sub = _walk(v, f"{path}.")
                if sub:
                    out[k] = sub
        return out

    return _walk(src, "")
