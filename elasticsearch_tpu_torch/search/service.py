"""Search service: query-then-fetch over a shard's segments.

Port of the host loop of elasticsearch_tpu/search/service.py. A request
may carry ``query``, ``from``/``size``, ``_source``, ``version``,
``rescore``, ``aggs`` / ``aggregations`` (``search/aggregations/``),
``sort`` and ``search_after``, ``min_score``, ``scroll`` (with
``search_type: scan``), ``highlight`` (``search/highlight.py``),
``profile`` (``tracing/profiler.py``), ``terminate_after``,
``timeout``, ``fields`` / ``stored_fields``, ``script_fields`` (one
run of each script a segment, ``_script_field``), ``indices_boost`` (applied
in ``search_shards`` before the global merge), ``_query_cache`` (read by
``IndexService``), ``search_type: dfs_query_then_fetch`` (the
caller's ``GlobalStats``) and ``stats`` (the groups each shard's
``SearchStats`` counts the query and fetch phases under); any other key
raises a typed SearchParseException that names the ROADMAP item
bringing it (``check_body``). A ``_name`` in the query adds ``matched_queries`` to
each hit in the fetch phase, a nested query with ``inner_hits`` its
matching children (``_attach_inner_hits``).

A request's has_child and has_parent run their shard-wide pass first
(``joins.prepare_tree``). On a segment holding nested docs the top-level
mask is ``live & roots``, for hits, totals, aggs, sorts, scrolls,
``terminate_after`` and ``min_score`` alike, and B1's fused route is not
taken (it scores every doc).

Per segment the query runs the fused dense-impact top-k (kernel B1) when
the query is a pure-dense term group and nothing else reads the scores
or the mask (``fused_ok``, the reference's condition), else the generic
score/mask tensors followed by a masked top-k; the aggregations collect
each segment's partial over the same mask that counts ``hits.total``.
Candidates merge per shard by ``(-score, seg_id, local_id)``; a
``hybrid`` query's stage-2 re-rank and then the rescorers re-order the
merged window; shards merge by ``(-score, shard_ord, local_id)``, the
reference's orders.

Field sort is exact. Every sort key becomes int64 lanes in an
order-preserving key space on the card (``ops/scoring.py``: a long's
value, a double's f64 order bits, a keyword's rank among the segment's
sorted terms, the f32 score's bits; a missing value below or above every
value as ``missing`` says), and ``sort_topk`` selects each segment's top
k by the full tuple, then the local id; ``search_after`` is a strict
"after" mask in the same space. The reference preselects on the primary
key alone, in f32, and drops the docs missing it (ROADMAP C, "Reference
fault, field sort"); wherever that preselect is right the two agree.
Segments then merge by the value tuple (``_sort_key``) in segment order
and shards in shard order: ``(tuple, shard, segment, local)``. A
``_geo_distance`` key is the f64 haversine of the exact coordinates on
the card (``TpuSegment.geo_f64``) in the same key space, a doc without a
point last; a hit reports the f64 numpy distance, as the reference does.

A scroll snapshots its whole match set when it opens (point in time: the
snapshot holds the segments and their doc lists, so later writes and
deletes leave its pages as they were); a score-ordered one as compact
arrays, ordered on the card by one stable sort a segment; a sorted one
as its complete merged candidate list. ``scroll_next`` and
``clear_scroll`` page and drop it.
"""
from __future__ import annotations

import fnmatch
import time
import uuid
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mappings import _parse_geo_point
from elasticsearch_tpu_torch.monitor.programs import REGISTRY, static_sig
from elasticsearch_tpu_torch.monitor.stats import SearchStats
from elasticsearch_tpu_torch.ops import scoring as S
from elasticsearch_tpu_torch.ops.scoring import count_mask, topk_with_mask
from elasticsearch_tpu_torch.search.aggregations import (parse_aggs,
                                                         reduce_aggs,
                                                         run_aggs)
from elasticsearch_tpu_torch.search.context import GlobalStats, SegmentContext
from elasticsearch_tpu_torch.search.function_score import doc_resolver
from elasticsearch_tpu_torch.search.geo import (_UNIT_M, haversine_f64,
                                                haversine_np)
from elasticsearch_tpu_torch.search.highlight import (extract_query_terms,
                                                      highlight_field)
from elasticsearch_tpu_torch.search.hybrid import (HybridQuery,
                                                   apply_hybrid_rerank)
from elasticsearch_tpu_torch.search.joins import (collect_nested_inner_hits,
                                                  prepare_tree)
from elasticsearch_tpu_torch.search.queries import (collect_named,
                                                    fused_bm25_topk,
                                                    parse_query)
from elasticsearch_tpu_torch.search.rescore import apply_rescore, parse_rescore
from elasticsearch_tpu_torch.search.scripting import (compile_script,
                                                      script_params,
                                                      script_source)
from elasticsearch_tpu_torch.tracing import profiler
from elasticsearch_tpu_torch.tracing.tasks import check_cancelled
from elasticsearch_tpu_torch.utils.errors import (
    CircuitBreakingException, SearchContextMissingException,
    SearchParseException)
from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

#: request keys the port serves
_SUPPORTED_KEYS = frozenset({
    "query", "size", "from", "_source", "version", "rescore", "aggs",
    "aggregations", "sort", "search_after", "min_score", "scroll",
    "search_type", "highlight", "profile", "terminate_after", "timeout",
    "fields", "stored_fields", "indices_boost", "_query_cache",
    "script_fields", "suggest", "stats"})
#: the search types the port serves
_SEARCH_TYPES = ("query_then_fetch", "dfs_query_then_fetch", "scan")

#: the clock of ``timeout`` (checked between segments)
_clock = time.perf_counter


def check_body(body: dict) -> None:
    """Raise the typed refusal of a request the port does not serve,
    naming the ROADMAP item that brings it."""
    unsupported = sorted(set(body) - _SUPPORTED_KEYS)
    if unsupported:
        raise SearchParseException(
            f"search request keys {unsupported} are not yet in the PyTorch "
            f"port (ROADMAP A6c)")
    st = body.get("search_type")
    if st is not None and st not in _SEARCH_TYPES:
        raise SearchParseException(
            f"search_type [{st}] is not yet in the PyTorch port (ROADMAP "
            f"A6c)")
    if st == "scan" and not body.get("scroll"):
        raise SearchParseException("search_type [scan] requires [scroll]")


def stats_groups(body: dict) -> List[str]:
    """The search-stats groups a body's ``stats`` key names (a list, or
    one name)."""
    g = body.get("stats") or ()
    return [g] if isinstance(g, str) else [str(x) for x in g]


def _parse_timeout(v) -> Optional[float]:
    """Request timeout → seconds ("10ms", "1s", "2m", or numeric millis)."""
    if v in (None, -1, "-1"):
        return None
    s = str(v).strip().lower()
    for suf, mul in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suf) and s[: -len(suf)].replace(".", "", 1).isdigit():
            return float(s[: -len(suf)]) * mul
    try:
        return float(s) * 1e-3  # bare number = millis (ES convention)
    except ValueError:
        raise SearchParseException(f"failed to parse timeout value [{v}]")


# in-memory scroll registry: scroll_id -> snapshot state
_SCROLLS: Dict[str, dict] = {}


@dataclass
class ShardDoc:
    """One candidate doc from the query phase (pre-fetch)."""

    shard_ord: int
    seg: Any  # TpuSegment
    local_id: int
    score: float
    sort_values: Tuple = ()


@dataclass
class QueryPhaseResult:
    docs: List[ShardDoc]
    total_hits: int
    max_score: float
    # a hybrid query's stage-2 status: {"rerank": "applied"|"declined", ...}
    hybrid: Optional[dict] = None
    # {"_list": [per-segment partials], "_aggs": the parsed agg tree}
    agg_partials: Optional[dict] = None
    # score-ordered scroll snapshot: per segment (segment, i32 local ids
    # of every match in order, f32 scores in the same order)
    full: Optional[List[Tuple[Any, np.ndarray, np.ndarray]]] = None
    terminated_early: bool = False
    timed_out: bool = False
    # profile: true — the shard's phase breakdown (tracing/profiler.py)
    profile: Optional[dict] = None


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
        # the shard's query, fetch, suggest and scroll counters
        self.stats = SearchStats()

    def query_phase(self, body: dict,
                    global_stats: Optional[GlobalStats] = None,
                    collect_full: bool = False) -> QueryPhaseResult:
        """One shard's query phase. ``collect_full`` (a scroll) keeps
        every match: a score-ordered snapshot (``full``) or, sorted, the
        complete candidate list."""
        check_body(body)
        # a scroll snapshot profiles nothing: its cost is the snapshot
        prof = profiler.PhaseTimer() if body.get("profile") \
            and not collect_full else None

        def _p(name: str):
            return prof.phase(name) if prof is not None else nullcontext()

        def _dc(fn, bucket: Optional[str] = None):
            return prof.device_call(fn, bucket) if prof is not None \
                else fn()

        with _p("rewrite"):
            query = parse_query(body.get("query"))
            # has_child / has_parent: their shard-wide pass
            prepare_tree(query, self.segments, self.mappings, self.analysis,
                         global_stats)
        aggs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0))
        if not collect_full and frm + size > 10_000:
            # explicit, like ES's index.max_result_window — never a silent cap
            raise SearchParseException(
                f"Result window is too large, from + size must be less than "
                f"or equal to: [10000] but was [{frm + size}]. Use scroll or "
                f"search_after for deep pagination.")
        k = min(max(size + frm, 1), 10_000)
        min_score = body.get("min_score")
        scan = collect_full and body.get("search_type") == "scan"
        # scan ignores sort entirely (ScanContext)
        sort_spec = [] if scan else _parse_sort(body.get("sort"))
        search_after = body.get("search_after")
        if search_after is not None and not sort_spec:
            raise SearchParseException(
                "Sort must contain at least one field when using "
                "[search_after]")
        if search_after is not None and (
                not isinstance(search_after, list)
                or len(search_after) != len(sort_spec)):
            n = len(search_after) if isinstance(search_after, list) else 1
            raise SearchParseException(
                f"search_after has {n} value(s) but sort has "
                f"{len(sort_spec)}")
        if body.get("rescore") and sort_spec:
            raise SearchParseException(
                "cannot use [rescore] in combination with [sort]")
        if body.get("rescore") and collect_full:
            raise SearchParseException(
                "cannot use [rescore] in combination with [scroll]")
        rescore_specs = parse_rescore(body.get("rescore") or None)
        if rescore_specs:
            # the candidates must cover the largest rescore window
            k = min(max([k] + [s["window_size"] for s in rescore_specs]),
                    10_000)
        docs: List[ShardDoc] = []
        total = 0
        max_score = float("-inf")
        agg_partials: List[dict] = []
        # a score-ordered scroll snapshots every match (no 10k cap); a
        # sorted one keeps its complete candidate list
        full_snap = [] if collect_full and not sort_spec else None
        # terminate_after caps the shard's collected count; timeout stops
        # between segments (a segment's launches are not interruptible)
        terminate_after = body.get("terminate_after")
        terminate_after = int(terminate_after) if terminate_after else None
        timeout_s = _parse_timeout(body.get("timeout"))
        t_begin = _clock()
        terminated_early = timed_out = False
        # B1 makes no score row and no mask: only a plain score top-k
        fused_ok = not (aggs or sort_spec or min_score is not None
                        or search_after is not None or rescore_specs
                        or collect_full)
        with profiler.attached(prof):
            for seg in self.segments:
                if timeout_s is not None and _clock() - t_begin > timeout_s:
                    timed_out = True
                    break
                if terminate_after is not None and total >= terminate_after:
                    terminated_early = True
                    break
                with _p("executor_build"):
                    ctx = SegmentContext(seg, self.mappings, self.analysis,
                                         global_stats,
                                         index_name=self.index_name,
                                         all_segments=self.segments)
                if prof is not None:
                    prof.segments += 1
                kk = min(k, seg.max_docs)
                # B1 scores every doc: a segment with nested docs takes
                # the generic route and its roots-only mask
                if fused_ok and not seg.has_nested:
                    fused = _dc(lambda: fused_bm25_topk(ctx, query, kk),
                                "topk")
                    if fused is not None:
                        vals, ids, seg_total = fused
                        total += seg_total
                        for v, i in zip(vals, ids):
                            # matches score strictly > 0; the live mask
                            # maps non-matches to -inf or a 0.0 dense row
                            if np.isfinite(v) and v > 0:
                                max_score = max(max_score, float(v))
                                docs.append(ShardDoc(self.shard_ord, seg,
                                                     int(i), float(v)))
                        continue
                # the host loop's program: in flight, and filed as a
                # compile or an execute, up to its copy back
                with REGISTRY.timed("host_dsl", static_sig(
                        D=pow2_bucket(seg.max_docs), k=kk)):
                    scores, mask = _dc(lambda: query.score_or_mask(ctx))
                    mask = mask & seg.live
                    if seg.has_nested:
                        # top-level hits, totals, aggs and sorts see roots
                        # only: nested docs are reached through nested
                        # queries and aggs (Lucene's block join)
                        mask = mask & seg.roots_dev
                    if min_score is not None:
                        mask = mask & (scores >= float(min_score))
                    if aggs:
                        with _p("aggs"):
                            agg_partials.append(run_aggs(aggs, ctx, mask))
                    if sort_spec:
                        with _p("topk"):
                            seg_docs, seg_total = self._sorted_candidates(
                                seg, scores, mask, sort_spec,
                                seg.max_docs if collect_full else kk,
                                search_after)
                        total += seg_total
                    elif full_snap is not None:
                        order, sc = _snapshot_segment(scores, mask, scan)
                        total += int(order.size)
                        full_snap.append((seg, order, sc))
                        seg_docs = [] if scan else [
                            ShardDoc(self.shard_ord, seg, int(i), float(v))
                            for i, v in zip(order[:k].tolist(),
                                            sc[:k].tolist())]
                    else:
                        vals, idx = _dc(lambda: topk_with_mask(scores, mask,
                                                               k=kk), "topk")
                        with _p("host_sync"):
                            total += count_mask(mask)
                            vals = vals.cpu().numpy()
                            idx = idx.cpu().numpy()
                        seg_docs = [ShardDoc(self.shard_ord, seg, int(i),
                                             float(v))
                                    for v, i in zip(vals, idx)
                                    if np.isfinite(v)]
                for d in seg_docs:
                    if np.isfinite(d.score):
                        max_score = max(max_score, d.score)
                docs.extend(seg_docs)

        # merge segment candidates
        if sort_spec:
            docs.sort(key=lambda d: _sort_key(d.sort_values, sort_spec))
        else:
            docs.sort(key=lambda d: (-d.score, d.seg.seg_id, d.local_id))
        if not (collect_full and sort_spec):
            docs = docs[:k]
        hybrid = None
        if isinstance(query, HybridQuery) and query.rerank is not None \
                and not sort_spec and not collect_full:
            # stage 2 over the merged window; a breaker denial comes back
            # as the typed "declined" status with stage-1 scores untouched
            with _p("rerank"):
                hybrid = apply_hybrid_rerank(docs, query, self.mappings,
                                             self.analysis)
            max_score = max((d.score for d in docs if np.isfinite(d.score)),
                            default=float("-inf"))
        if rescore_specs:
            apply_rescore(docs, rescore_specs, self.mappings, self.analysis,
                          self.segments)
            docs = docs[: min(max(size + frm, 1), 10_000)]
            max_score = max((d.score for d in docs), default=float("-inf"))
        if terminate_after is not None and total >= terminate_after:
            terminated_early = True
            total = min(total, terminate_after)
        return QueryPhaseResult(
            docs=docs, total_hits=total,
            max_score=max_score if docs and max_score != float("-inf")
            else float("nan"), hybrid=hybrid,
            agg_partials={"_list": agg_partials, "_aggs": aggs}
            if aggs else None,
            full=full_snap, terminated_early=terminated_early,
            timed_out=timed_out,
            profile=prof.to_json() if prof is not None else None)

    def _sorted_candidates(self, seg, scores, mask, sort_spec, k: int,
                           search_after) -> Tuple[List[ShardDoc], int]:
        """(the segment's top ``k`` matches by the full sort tuple, then
        local id, each with its sort values; the segment's match count):
        ``sort_topk`` over the keys' lanes on the card, the strict
        ``search_after`` mask in the same key space, one copy back."""
        lanes: list = []
        cursor: list = []  # a (position, exact) pair a lane
        for i, s in enumerate(sort_spec):
            ln, cur = _key_lanes(seg, s, scores, search_after[i]
                                 if search_after is not None else _NO_CURSOR)
            lanes += ln
            cursor += cur or []
        sel = mask if search_after is None \
            else mask & S.after_mask(lanes, cursor)
        ids = S.sort_topk(lanes, sel, k)
        kk = int(ids.numel())
        out = torch.cat([ids.to(torch.int32),
                         scores.gather(0, ids).view(torch.int32),
                         torch.stack([sel.sum(), mask.sum()]).to(torch.int32)
                         ]).cpu().numpy()
        n = min(kk, int(out[-2]))
        docs = []
        for local, score in zip(out[:n].tolist(),
                                out[kk: kk + n].view(np.float32).tolist()):
            sv = tuple(_sort_value(seg, s, local, score) for s in sort_spec)
            docs.append(ShardDoc(self.shard_ord, seg, local, score, sv))
        return docs, int(out[-1])

    # -- fetch phase -----------------------------------------------------------

    def count(self, body: dict) -> int:
        """The shard's live top-level docs matching ``body``'s query (ES
        2.0's count API): one mask a segment, summed on the card, one
        copy back."""
        query = parse_query(body.get("query"))
        prepare_tree(query, self.segments, self.mappings, self.analysis)
        counts = []
        for seg in self.segments:
            ctx = SegmentContext(seg, self.mappings, self.analysis,
                                 index_name=self.index_name,
                                 all_segments=self.segments)
            _, mask = query.execute(ctx)
            mask = mask & seg.live
            if seg.has_nested:
                mask = mask & seg.roots_dev
            counts.append(mask.sum())
        return int(torch.stack(counts).sum()) if counts else 0

    def fetch_phase(self, docs: List[ShardDoc], body: dict,
                    index_name: str = "") -> List[dict]:
        src_filter = body.get("_source", True)
        want_version = bool(body.get("version", False))
        hl = body.get("highlight")
        query = parse_query(body.get("query"))
        stored_fields = body.get("stored_fields", body.get("fields"))
        script_fields = body.get("script_fields")
        sf_cache: Dict[Tuple[int, str], Any] = {}  # (seg_id, field) → values
        hits = []
        for d in docs:
            tcol = d.seg.keywords.get("_type")
            tvals = tcol.host_values[d.local_id] if tcol is not None else None
            doc_id = d.seg.ids[d.local_id]
            hit: Dict[str, Any] = {
                "_index": self.index_name or index_name,
                "_type": tvals[0] if tvals else "_doc",
                "_id": doc_id,
                "_score": None if d.sort_values else d.score,
            }
            if d.sort_values:
                hit["sort"] = list(d.sort_values)
            if want_version and self.version_of is not None:
                hit["_version"] = self.version_of(doc_id)
            src = d.seg.sources[d.local_id]
            filtered = _filter_source(src, src_filter)
            if filtered is not None:
                hit["_source"] = filtered
            if stored_fields:
                _attach_fields(hit, d.seg.stored[d.local_id], src,
                               stored_fields, body)
            if script_fields:
                hit.setdefault("fields", {})
                for fname, spec in script_fields.items():
                    hit["fields"][fname] = [
                        self._script_field(d, spec, fname, sf_cache)]
            if hl:
                ctx = SegmentContext(d.seg, self.mappings, self.analysis)
                hit["highlight"] = self._highlight(ctx, query, src, hl)
            hits.append(hit)
        self._attach_matched_queries(query, docs, hits)
        self._attach_inner_hits(query, docs, hits, index_name)
        return hits

    def _attach_inner_hits(self, query, docs: List[ShardDoc],
                           hits: List[dict], index_name: str) -> None:
        """``inner_hits`` of nested queries: per root hit its matching
        children of the path, best first, each with its object from the
        root's ``_source``. One selection a (query, segment), copied back
        once."""
        nq_list = collect_nested_inner_hits(query)
        if not nq_list:
            return
        sel_cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for nq_i, nq in enumerate(nq_list):
            name = nq.inner_hits.get("name", nq.path)
            ih_size = int(nq.inner_hits.get("size", 3))
            ih_from = int(nq.inner_hits.get("from", 0))
            for d, hit in zip(docs, hits):
                seg = d.seg
                if not seg.has_nested or nq.path not in seg.nested_paths:
                    continue
                key = (nq_i, seg.seg_id)
                if key not in sel_cache:
                    ctx = SegmentContext(seg, self.mappings, self.analysis)
                    sel, child_scores = nq.child_selection(ctx)
                    sel_cache[key] = (sel.cpu().numpy(),
                                      child_scores.cpu().numpy())
                sel_np, scores_np = sel_cache[key]
                n = seg.num_docs
                kids = np.nonzero(sel_np[:n] & (seg.root_id_host[:n]
                                                == d.local_id))[0]
                if kids.size == 0:
                    continue
                order = kids[np.argsort(-scores_np[kids], kind="stable")]
                root_src = seg.sources[d.local_id] or {}
                child_hits = []
                for kid in order[ih_from: ih_from + ih_size]:
                    ordn = int(seg.nested_ord_host[kid])
                    child_hits.append({
                        "_index": self.index_name or index_name,
                        "_id": hit["_id"],
                        "_nested": {"field": nq.path, "offset": ordn},
                        "_score": float(scores_np[kid]),
                        "_source": _nested_sub_source(root_src, nq.path,
                                                      ordn),
                    })
                hit.setdefault("inner_hits", {})[name] = {"hits": {
                    "total": int(kids.size),
                    "max_score": float(scores_np[order[0]]),
                    "hits": child_hits}}

    def _script_field(self, d: ShardDoc, spec, fname: str, cache: dict):
        """A script field's value for one hit. The script runs once a
        (segment, field) over the whole segment and its column comes to
        the host in one copy, kept for the other hits of the fetch."""
        key = (d.seg.seg_id, fname)
        vals = cache.get(key)
        if vals is None:
            s = spec.get("script", spec) if isinstance(spec, dict) else spec
            ctx = SegmentContext(d.seg, self.mappings, self.analysis)
            vals = compile_script(script_source(s)).run(
                doc_resolver(ctx), params=script_params(s),
                device=ctx.device)
            if isinstance(vals, torch.Tensor):
                vals = vals.cpu().numpy()
            cache[key] = vals
        if isinstance(vals, np.ndarray) and vals.shape != ():
            return float(vals[d.local_id])
        if isinstance(vals, (np.ndarray, int, float)):
            return float(vals)
        return vals

    def _attach_matched_queries(self, query, docs: List[ShardDoc],
                                hits: List[dict]) -> None:
        """``matched_queries``: for each ``_name``d node of the query tree,
        the page hits its mask matches; one mask a (segment, name), copied
        back once, never one a doc."""
        named = collect_named(query)
        if not named:
            return
        masks: Dict[tuple, np.ndarray] = {}
        for d, hit in zip(docs, hits):
            names = []
            for nm, node in named:
                key = (nm, id(d.seg))
                mk = masks.get(key)
                if mk is None:
                    ctx = SegmentContext(d.seg, self.mappings, self.analysis)
                    mk = masks[key] = node.execute(ctx)[1].cpu().numpy()
                if mk[d.local_id]:
                    names.append(nm)
            if names:
                hit["matched_queries"] = names

    def _highlight(self, ctx, query, src, hl_spec) -> Dict[str, List[str]]:
        out = {}
        pre = (hl_spec.get("pre_tags") or ["<em>"])[0]
        post = (hl_spec.get("post_tags") or ["</em>"])[0]
        for fname, fspec in hl_spec.get("fields", {}).items():
            fm = self.mappings.get(fname)
            if fm is None or src is None:
                continue
            raw = src.get(fname)
            if not isinstance(raw, str):
                continue
            terms = extract_query_terms(query, fname, ctx)
            analyzer = ctx.search_analyzer(fname)
            frags = highlight_field(
                raw, terms, analyzer,
                pre_tag=pre, post_tag=post,
                fragment_size=int(fspec.get("fragment_size", 100)),
                number_of_fragments=int(fspec.get("number_of_fragments", 5)),
            )
            if frags:
                out[fname] = frags
        return out


def _snapshot_segment(scores, mask, scan: bool):
    """(i32 local ids, f32 scores) of every match of a segment: in index
    order for a scan, else by (-score, local id), one stable sort on the
    card (-0.0 ranks as 0.0, as the reference's numpy sort compares)."""
    if scan:
        order = torch.nonzero(mask).view(-1)
    else:
        eff = torch.where(mask, scores + 0.0, float("-inf"))
        order = torch.sort(eff, descending=True, stable=True).indices[
            : count_mask(mask)]
    return (order.to(torch.int32).cpu().numpy(),
            scores.gather(0, order).cpu().numpy())


# ---------------------------------------------------------------------------
# coordinating search across shards (single node)
# ---------------------------------------------------------------------------

def search_shards(searchers: List[ShardSearcher], body: dict,
                  index_name: str = "",
                  global_stats: Optional[GlobalStats] = None) -> dict:
    """Query-then-fetch across shards, ES response shape.

    A shard whose query phase trips a breaker becomes an ES
    ``_shards.failures[]`` entry (status 429) and the other shards
    answer (reference: ShardSearchFailure); only a
    CircuitBreakingException degrades so, every other error fails the
    request. When every shard failed, the reference's "all shards
    failed" CircuitBreakingException is raised."""
    t0 = time.perf_counter()
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    scroll = bool(body.get("scroll"))
    scan = scroll and body.get("search_type") == "scan"
    sort_spec = [] if scan else _parse_sort(body.get("sort"))
    profile = bool(body.get("profile"))
    shard_profiles: List[dict] = []
    results = []
    shard_failures: List[dict] = []
    groups = stats_groups(body)
    for pos, s in enumerate(searchers):
        tq = time.perf_counter()
        try:
            r = s.query_phase(body, global_stats, collect_full=scroll)
        except CircuitBreakingException as e:
            shard_failures.append({
                "shard": pos, "index": s.index_name or index_name,
                "node": None, "status": e.status,
                "reason": {"type": e.error_type, "reason": str(e)}})
            r = QueryPhaseResult(docs=[], total_hits=0,
                                 max_score=float("nan"))
        # fetch resolves searchers positionally in THIS list
        for d in r.docs:
            d.shard_ord = pos
        results.append(r)
        q_s = time.perf_counter() - tq
        s.stats.on_query(q_s * 1e3, groups=groups)
        if profile:
            shard_profiles.append(profiler.shard_profile_entry(
                f"[{s.index_name or index_name or 'shard'}][{pos}]",
                int(q_s * 1e9), r.profile))
    if shard_failures and len(shard_failures) == len(searchers):
        raise CircuitBreakingException(
            "all shards failed: "
            + "; ".join(f["reason"]["reason"] for f in shard_failures))
    if body.get("indices_boost"):
        _apply_indices_boost(body["indices_boost"], searchers, results)
    all_docs: List[ShardDoc] = []
    total = 0
    max_score = float("-inf")
    for r in results:
        all_docs.extend(r.docs)
        total += r.total_hits
        if r.docs and not np.isnan(r.max_score):
            max_score = max(max_score, r.max_score)
    if sort_spec:
        all_docs.sort(key=lambda d: _sort_key(d.sort_values, sort_spec))
    else:
        all_docs.sort(key=lambda d: (-d.score, d.shard_ord, d.local_id))

    # a score-ordered scroll: one global snapshot in compact arrays; page
    # 1 is served from it, so its ties order as every later page's
    snapshot = None
    if scroll and not sort_spec:
        snapshot = _global_snapshot(results, scan)
        # scan's first response carries no hits, only the scroll id
        page = [] if scan else _snapshot_page(snapshot, frm, size)
    else:
        page = all_docs[frm: frm + size]

    by_shard: Dict[int, List[ShardDoc]] = {}
    for d in page:
        by_shard.setdefault(d.shard_ord, []).append(d)
    fetched: Dict[Tuple[int, int, int], dict] = {}
    for shard_ord, docs in by_shard.items():
        tf = time.perf_counter()
        for d, h in zip(docs, searchers[shard_ord].fetch_phase(
                docs, body, index_name)):
            fetched[(d.shard_ord, id(d.seg), d.local_id)] = h
        f_s = time.perf_counter() - tf
        searchers[shard_ord].stats.on_fetch(f_s * 1e3, groups=groups)
        if profile:
            shard_profiles[shard_ord]["fetch"] = {
                "time_in_nanos": int(f_s * 1e9)}
    hits = [fetched[(d.shard_ord, id(d.seg), d.local_id)] for d in page]
    response: Dict[str, Any] = {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": any(r.timed_out for r in results),
        "_shards": {"total": len(searchers),
                    "successful": len(searchers) - len(shard_failures),
                    "failed": len(shard_failures)},
        "hits": {
            "total": total,
            "max_score": None if max_score == float("-inf") or sort_spec
            else max_score,
            "hits": hits,
        },
    }
    if shard_failures:
        response["_shards"]["failures"] = shard_failures
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
    if any(r.terminated_early for r in results):
        response["terminated_early"] = True
    present = [r.agg_partials for r in results if r.agg_partials]
    if present:
        response["aggregations"] = reduce_aggs(
            present[0]["_aggs"], [p for r in present for p in r["_list"]])
    if profile:
        response["profile"] = {"shards": shard_profiles}
    if scroll:
        # one scroll context a shard (ES counts contexts, not pages)
        for s in searchers:
            s.stats.on_scroll()
        scroll_id = uuid.uuid4().hex
        state: Dict[str, Any] = {
            # scan serves every doc by scrolling: page 1 consumed nothing
            "pos": 0 if scan else frm + size,
            "body": body, "searchers": searchers, "index_name": index_name,
            "total": total,
        }
        if snapshot is not None:
            state.update(mode="arrays", **snapshot)
        else:
            # a sorted scroll: the complete merged candidate list
            state.update(mode="docs", docs=all_docs)
        _SCROLLS[scroll_id] = state
        response["_scroll_id"] = scroll_id
    return response


def _apply_indices_boost(spec, searchers, results) -> None:
    """``indices_boost``: each shard's scores times the boost of the
    first pattern its index matches, before the global merge (a dict, or
    ES 2.0's list of one-key dicts)."""
    items = (spec.items() if isinstance(spec, dict)
             else [(k, v) for d in spec for k, v in d.items()])
    boosts = [(pat, float(v)) for pat, v in items]
    for s, r in zip(searchers, results):
        b = next((v for pat, v in boosts
                  if fnmatch.fnmatch(s.index_name, pat)), None)
        if b is None or b == 1.0:
            continue
        for d in r.docs:
            if np.isfinite(d.score):
                d.score *= b
        if not np.isnan(r.max_score):
            r.max_score *= b
        if r.full:
            r.full = [(seg, order, sc * b) for seg, order, sc in r.full]


def _global_snapshot(results, scan: bool) -> dict:
    """Every shard's per-segment snapshot in one order: (shard, segment,
    local) for a scan, else (-score, shard, local, segment), the
    reference's."""
    segs: List[Tuple[int, Any]] = []
    seg_of, shard_of, local, score = [], [], [], []
    for pos, r in enumerate(results):
        for seg, order, sc in (r.full or []):
            seg_of.append(np.full(order.size, len(segs), np.int32))
            segs.append((pos, seg))
            shard_of.append(np.full(order.size, pos, np.int32))
            local.append(order)
            score.append(sc.astype(np.float32))
    if not segs:
        return {"segs": [], "seg_of": np.empty(0, np.int32),
                "local": np.empty(0, np.int32),
                "score": np.empty(0, np.float32)}
    seg_of, shard_of, local, score = (np.concatenate(a) for a in
                                      (seg_of, shard_of, local, score))
    glob = np.lexsort((local, seg_of, shard_of)) if scan \
        else np.lexsort((seg_of, local, shard_of, -score))
    return {"segs": segs, "seg_of": seg_of[glob], "local": local[glob],
            "score": score[glob]}


def _snapshot_page(snap: dict, lo: int, size: int) -> List[ShardDoc]:
    segs = snap["segs"]
    return [ShardDoc(segs[si][0], segs[si][1], li, sc)
            for si, li, sc in zip(snap["seg_of"][lo: lo + size].tolist(),
                                  snap["local"][lo: lo + size].tolist(),
                                  snap["score"][lo: lo + size].tolist())]


def register_scroll_hits(body: dict, hits: List[dict], total: int,
                         consumed: Optional[int] = None) -> str:
    """Register a materialized scroll: the whole hit list is already
    fetched, and pages serve straight from it. ``consumed`` is how many
    hits the first response already delivered (0 for
    ``search_type=scan``, whose first response carries none); by default
    the body's ``size``. The caller is the cluster's scroll
    (cluster/search_action.py), whose per-owner fetch contexts are
    one-shot."""
    scroll_id = uuid.uuid4().hex
    _SCROLLS[scroll_id] = {
        "mode": "hits", "hits": hits, "total": total,
        "pos": (int(body.get("size", 10)) if consumed is None
                else consumed),
        "body": body,
    }
    return scroll_id


def scroll_next(scroll_id: str, size: Optional[int] = None) -> dict:
    """The next page of an open scroll (empty past its end). A scroll
    drained under a task (the REST layer registers one per context)
    stops at this checkpoint once the task is cancelled."""
    check_cancelled()
    state = _SCROLLS.get(scroll_id)
    if state is None:
        raise SearchContextMissingException(
            f"No search context found for id [{scroll_id}]")
    body = state["body"]
    sz = size or int(body.get("size", 10))
    lo = state["pos"]
    state["pos"] += sz
    if state["mode"] == "hits":
        return {
            "took": 0, "timed_out": False, "_scroll_id": scroll_id,
            "hits": {"total": state["total"], "max_score": None,
                     "hits": state["hits"][lo: lo + sz]},
        }
    if state["mode"] == "arrays":
        page = _snapshot_page(state, lo, sz)
    else:
        page = state["docs"][lo: lo + sz]
    by_shard: Dict[int, List[ShardDoc]] = {}
    for d in page:
        by_shard.setdefault(d.shard_ord, []).append(d)
    fetched: Dict[Tuple[int, int, int], dict] = {}
    for shard_ord, docs in by_shard.items():
        for d, h in zip(docs, state["searchers"][shard_ord].fetch_phase(
                docs, body, state["index_name"])):
            fetched[(d.shard_ord, id(d.seg), d.local_id)] = h
    return {
        "took": 0, "timed_out": False, "_scroll_id": scroll_id,
        "hits": {"total": state["total"], "max_score": None,
                 "hits": [fetched[(d.shard_ord, id(d.seg), d.local_id)]
                          for d in page]},
    }


def scroll_state(scroll_id: str) -> Optional[dict]:
    """The live scroll context for ``scroll_id`` (None when unknown)."""
    return _SCROLLS.get(scroll_id)


def clear_scroll(scroll_id: str) -> bool:
    return _SCROLLS.pop(scroll_id, None) is not None


# ---------------------------------------------------------------------------
# sort helpers
# ---------------------------------------------------------------------------

def _parse_sort(spec) -> List[dict]:
    if not spec:
        return []
    if isinstance(spec, (str, dict)):
        spec = [spec]
    out = []
    for item in spec:
        if isinstance(item, str):
            if item == "_score":
                out.append({"field": "_score", "order": "desc"})
            else:
                out.append({"field": item, "order": "asc"})
        else:
            (fieldname, cfg), = item.items()
            if fieldname == "_geo_distance":
                # {"_geo_distance": {"<field>": <point>, "order", "unit"}}
                cfg = dict(cfg)
                order = cfg.pop("order", "asc")
                unit = cfg.pop("unit", "m")
                cfg.pop("distance_type", None)
                cfg.pop("mode", None)
                (geo_field, point), = cfg.items()
                out.append({"field": "_geo_distance", "order": order,
                            "geo_field": geo_field,
                            "origin": _parse_geo_point(point),
                            "unit_m": _UNIT_M.get(unit, 1.0)})
            elif isinstance(cfg, str):
                out.append({"field": fieldname, "order": cfg})
            else:
                out.append({
                    "field": fieldname,
                    "order": cfg.get("order", "desc" if fieldname == "_score"
                                     else "asc"),
                    "missing": cfg.get("missing", "_last"),
                })
    # drop trailing pure-score sort into score path
    if len(out) == 1 and out[0]["field"] == "_score" \
            and out[0]["order"] == "desc":
        return []
    return out


def _missing_first(s: dict) -> bool:
    """Where a doc missing the key sorts: ``_first``, else last (a custom
    ``missing`` value sorts last, as the reference treats it)."""
    return str(s.get("missing", "_last")) == "_first"


#: ``_key_lanes``' marker of a request without search_after
_NO_CURSOR = object()


def _key_lanes(seg, s: dict, scores, after) -> Tuple[list, Optional[list]]:
    """(the i64 lanes of sort key ``s`` on ``seg``, its search_after
    cursor over them, or None for ``_NO_CURSOR``)."""
    desc = s["order"] == "desc"
    first = _missing_first(s)
    kind, safe, terms = None, True, None
    if s["field"] == "_score":
        kind = "f32"
        key = S.f32_order_keys(scores)
        lanes = [torch.bitwise_not(key) if desc else key]
    elif s["field"] == "_geo_distance":
        # the f64 distance on the card, in its order-key space: exact,
        # where the reference preselects on an f32 distance
        geo = seg.geo_f64(s["geo_field"])
        if geo is None:  # no points here: every doc misses the key
            lanes = _missing_lane(seg, first)
        else:
            kind = "f64"
            lat, lon, exists = geo
            d = torch.div(haversine_f64(lat, lon, *s["origin"]),
                          torch.tensor(s["unit_m"], dtype=torch.float64,
                                       device=seg.device))
            key = S.f64_order_keys_dev(torch.where(exists, d, 0.0))
            lanes = S.sort_lanes(key, exists, desc, first, True)
    else:
        m = seg.sort_keys(s["field"])
        if m is None:  # no doc values here: every doc misses the key
            lanes = _missing_lane(seg, first)
        else:
            kind, terms = m.kind, m.terms
            safe = S.lanes_safe(m.lo, m.hi, desc)
            lanes = S.sort_lanes(m.key, m.exists, desc, first, safe)
    if after is _NO_CURSOR:
        return lanes, None
    c = _cursor_value(after, kind, s["field"])
    if kind is None and c is not None:
        # a present cursor against docs that all miss the key: decided
        # by the missing sentinel alone
        return lanes, [(0, False)]
    return lanes, S.lane_cursor(c, kind, desc, first, safe, terms)


def _missing_lane(seg, first: bool) -> list:
    """The one lane of a key every doc of ``seg`` misses."""
    return [torch.full((seg.max_docs,), S.MISSING_FIRST if first
                       else S.MISSING_LAST, dtype=torch.int64,
                       device=seg.device)]


def _cursor_value(c, kind: Optional[str], field: str):
    """A search_after value in the key's own type: a keyword compares as
    a string (the reference's rule); a number key takes a number, a
    string parsed as one."""
    if c is None or kind is None:
        return c
    if kind == "rank":
        return c if isinstance(c, str) else str(c)
    if isinstance(c, bool):
        return int(c)
    if isinstance(c, str):
        for conv in (int, float):
            try:
                c = conv(c)
                break
            except ValueError:
                continue
    if not isinstance(c, (int, float)) or c != c:
        raise SearchParseException(
            f"search_after value [{c}] does not parse as a number for "
            f"sort field [{field}]")
    return c


def _sort_value(seg, s: dict, local: int, score):
    """The value a hit reports for sort key ``s`` (None when missing):
    the score, a column's exact value, or a keyword's first value."""
    if s["field"] == "_score":
        return float(score)
    if s["field"] == "_geo_distance":
        lat = seg.numerics.get(f"{s['geo_field']}.lat")
        lon = seg.numerics.get(f"{s['geo_field']}.lon")
        if lat is None or lon is None or not bool(lat.exists_host[local]):
            return None
        return float(haversine_np(float(lat.exact[local]),
                                  float(lon.exact[local]),
                                  *s["origin"]) / s["unit_m"])
    col = seg.numerics.get(s["field"])
    if col is not None:
        if not bool(col.exists_host[local]):
            return None
        ex = col.exact[local]
        return int(ex) if col.exact.dtype.kind == "i" else float(ex)
    kw = seg.keywords.get(s["field"])
    if kw is not None and kw.host_values[local]:
        return kw.host_values[local][0]
    return None


def _sort_key(sort_values: Tuple, sort_spec: List[dict]):
    key = []
    for v, s in zip(sort_values, sort_spec):
        desc = s["order"] == "desc"
        if v is None:
            key.append((0 if _missing_first(s) else 2, 0))
        elif isinstance(v, str):
            key.append((1, _StrKey(v, desc)))
        else:
            key.append((1, -v if desc else v))
    return tuple(key)


class _StrKey:
    __slots__ = ("v", "desc")

    def __init__(self, v, desc):
        self.v = v
        self.desc = desc

    def __lt__(self, other):
        return (self.v > other.v) if self.desc else (self.v < other.v)

    def __eq__(self, other):
        return self.v == other.v


# ---------------------------------------------------------------------------
# fetch-phase fields and source filtering (FetchSourceSubPhase semantics)
# ---------------------------------------------------------------------------

def _attach_fields(hit: dict, stored: Optional[dict], src: Optional[dict],
                   stored_fields, body: dict) -> None:
    """``fields`` / ``stored_fields``: each named field's stored values,
    else its value at the dotted path in ``_source`` (a list as it is, a
    scalar as a one-value list). A fields list drops ``_source`` unless it
    names ``_source`` or the body asks for ``_source`` itself."""
    names = ([stored_fields] if isinstance(stored_fields, str)
             else list(stored_fields))
    flds = {}
    for f in names:
        if f == "_source":
            continue
        sv = stored.get(f) if stored else None
        if sv is None and src:
            cur = source_path(src, f)
            if cur is not None:
                sv = cur if isinstance(cur, list) else [cur]
        if sv is not None:
            flds[f] = sv
    if flds:
        hit["fields"] = flds
    if "_source" not in names and "_source" not in body:
        hit.pop("_source", None)


def _nested_sub_source(root_src: dict, path: str, ordn: int):
    """The ``ordn``-th object under a (dotted) nested path of the root's
    ``_source``."""
    cur: Any = root_src
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, list):
        return cur[ordn] if 0 <= ordn < len(cur) else None
    return cur if ordn == 0 else None


def source_path(src, path: str):
    """Walk a dotted path into a source dict; None when any hop misses."""
    cur = src
    for part in str(path).split("."):
        cur = cur.get(part) if isinstance(cur, dict) else None
    return cur


def _filter_source(src: Optional[dict], spec) -> Optional[dict]:
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
