"""The product search path over the shard mesh.

Port of elasticsearch_tpu/parallel/mesh_service.py's ``try_mesh_search``.
``IndexService.search`` lands here first: the parsed query compiles
(``parallel/compiler.py``) into one sequence of launches per segment
round over every shard (``parallel/executor.py``), and only the fetch
phase stays per shard on the host. Anything the compiler can't express
returns None and the caller takes the host per-shard loop in
``search/service.py`` (the same result, shard after shard). The response
is assembled as the host loop assembles it, so the two are identical
apart from ``took`` and the scores' last bits.

``try_mesh_msearch`` is the batched query phase of an ``_msearch``
batch (``search/batch.py``): every query of the batch on every shard in
one postings round a segment row (``executor.search_terms``).

Aggregations: a body whose aggs are all keyword ``terms`` without
sub-aggregations has each segment's term counts made in the round on the
card (``agg_terms_device``); any other agg tree runs the host-side
collectors over the round's match mask, which stays on the card
(``agg_mask``). The partials reach ``reduce_aggs`` in (shard, segment)
order, the host loop's, so a response is byte-identical to the host
loop's. On a mesh of several devices the integer lanes of the partials
merge across shards on the devices first (``_psum_merge_partials``, the
reference's ``mesh_psum``): terms doc counts and ``sum_other_doc_count``,
``value_count``, and the doc counts of ``avg``, ``stats`` and
``extended_stats`` sum exactly in int64 (``executor.psum_partials``),
while their float lanes keep the host's f64 fold in partial order, so
the response is byte-identical to the host reduce's; a mesh of one
device reduces on the host alone, as before. A failure on the way
raises: nothing falls back to the host loop on the card.

Field sort: each slot's round selects its segment's exact top k by the
sort keys on the card (``executor.search_dsl`` with ``sort_spec``), and
the candidates merge here by their value tuples (a keyword's by its
string, from ``host_values``) in ``(tuple, shard, segment, local)``
order, the host loop's, so the two routes answer byte for byte. The keys
in ``_UNSUPPORTED_KEYS`` (scroll, search_after, min_score, profile,
terminate_after, timeout, ...) keep a request on the host loop, as in
the reference; highlight, ``fields`` and ``_name``'s
``matched_queries`` are fetch-phase keys and ride either route.
``dfs_query_then_fetch`` runs here too: the round's contexts take the
index-wide statistics, and such a round never reads or fills the
prepared-query memo. A shard holding a segment with nested docs keeps
every request on the host loop (the round has no roots-only mask), as do
the join and geo queries (the compiler declines them).
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.parallel.compiler import MeshCompileError
from elasticsearch_tpu_torch.search.context import SegmentContext
from elasticsearch_tpu_torch.search.aggregations import (parse_aggs,
                                                         reduce_aggs,
                                                         run_aggs)
from elasticsearch_tpu_torch.search.aggregations.bucket import \
    TermsAggregator
from elasticsearch_tpu_torch.search.queries import _batch_terms, parse_query
from elasticsearch_tpu_torch.search.service import (ShardDoc, _parse_sort,
                                                    _sort_key, _sort_value,
                                                    check_body, stats_groups)
from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException

# host-loop-only request features: their presence skips the mesh path
_UNSUPPORTED_KEYS = ("rescore", "search_after", "min_score", "scroll",
                     "profile", "terminate_after", "timeout",
                     "indices_boost")

_BY_DESIGN = object()  # host path chosen on purpose (IVF probing, hybrid)


def try_mesh_search(svc, searchers, body: dict,
                    global_stats=None) -> Optional[dict]:
    """Mesh-execute a search request; None → the caller uses the host
    loop. ``global_stats`` (``dfs_query_then_fetch``) gives the round's
    term weights the index-wide idf."""
    resp = _try_mesh_search(svc, searchers, body, global_stats)
    if resp is _BY_DESIGN:
        kernels.record("mesh_host_by_design")
        return None
    kernels.record("mesh_search" if resp is not None
                   else "mesh_fallback_total")
    return resp


def try_mesh_msearch(svc, searchers, queries, k: int):
    """The batched query phase over the shard mesh: every query of the
    batch (fused-eligible term groups on one field) scored on every
    shard in one round a segment row, with per-shard top-k, the merge in
    shard order and exact totals (``executor.search_terms``).

    Returns ``(cands, totals)`` in ``search/batch.py``'s candidate
    format, ``cands[qi]`` a list of ``(-score, shard, seg_id, local,
    segment)`` holding each query's global top ``k``, or None, and then
    the caller takes the per-segment host tiers (the same results, shard
    after shard). Fetch, paging and the responses stay with the caller."""
    out = _try_mesh_msearch(svc, searchers, queries, k)
    kernels.record("mesh_msearch" if out is not None
                   else "mesh_msearch_fallback")
    return out


def _try_mesh_msearch(svc, searchers, queries, k: int):
    if len(searchers) < 2 or k < 1:
        return None  # one shard: the host tiers already are one pass
    shard_segs = [list(s.segments) for s in searchers]
    if _any_nested(shard_segs) or _any_oversized(shard_segs):
        return None
    probe = next((seg for segs in shard_segs for seg in segs), None)
    if probe is None:
        return None  # an empty snapshot: the host tiers answer it
    # the probe context for analysis and mappings only: the weights stay
    # idf-free, each segment's own idf folds into its chunk tables
    ctx = SegmentContext(probe, svc.mappings, svc.analysis,
                         index_name=svc.name)
    got = _batch_terms(ctx, queries, idf=False)
    if got is None:
        return None
    field, rows = got
    qterms = [list(zip(tlist, wlist)) for tlist, wlist in rows]
    try:
        out = svc.mesh_executor().search_terms(field, qterms, k=k,
                                               shards=shard_segs)
    except CircuitBreakingException:
        # stacked postings denied by the breaker: the host tiers score
        # the batch segment at a time within what the budget leaves
        return None
    vals, shard, local, seg_ord, totals = out
    ok = (np.isfinite(vals) & (vals > 0)).tolist()
    cands: List[list] = []
    for row in zip(vals.tolist(), shard.tolist(), seg_ord.tolist(),
                   local.tolist(), ok):
        c = []
        for v, sh, o, lc, y in zip(*row):
            if y:  # a match; an empty slot's entries are -inf
                seg = shard_segs[sh][o]
                c.append((-v, sh, seg.seg_id, lc, seg))
        cands.append(c)
    return cands, totals.tolist()


def _any_nested(shard_segs) -> bool:
    """A segment holding nested docs: the round carries no block-join
    arrays (and no roots-only mask), so the host loop serves, as the
    reference's mesh declines."""
    return any(seg.has_nested for segs in shard_segs for seg in segs)


def _any_oversized(shard_segs) -> bool:
    """A segment with a field over the postings split's threshold: it
    cannot be stacked into the round's [S, ...] arrays, so the host loop
    scores it through its term-range split (parallel/postings_shard.py),
    as the reference's mesh declines."""
    return any(inv.wants_postings_shard() for segs in shard_segs
               for seg in segs for inv in seg.inverted.values())


def _canonical(body: dict) -> Optional[bytes]:
    """The prepared-query memo key: the request body, serialised (a
    repeated request skips build and copy; the round always re-runs).
    A pickle, not JSON: it writes a vector's floats as bytes, where JSON
    formats each one (0.2 ms for 128 floats); equal pickles are equal
    bodies, and the same body written in another key order only misses."""
    try:
        return pickle.dumps(body, protocol=pickle.HIGHEST_PROTOCOL)
    except (TypeError, pickle.PicklingError, AttributeError):
        return None


def _try_mesh_search(svc, searchers, body: dict, global_stats=None):
    body = body or {}
    check_body(body)  # the host loop's typed refusal, raised here too
    for key in _UNSUPPORTED_KEYS:
        # present at all (a min_score or timeout of 0 too): the host loop
        if body.get(key) is not None and body.get(key) is not False:
            return None
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    if frm + size > 10_000:
        return None  # the host loop raises the max_result_window error
    sort_spec = _parse_sort(body.get("sort"))
    query = parse_query(body.get("query"))
    aggs = parse_aggs(body.get("aggs") or body.get("aggregations"))
    # keyword terms aggs without subs count on the card in the round; any
    # other agg tree reads the round's match mask through the host-side
    # collectors. The query phase stays one mesh round either way.
    device_aggs = bool(aggs) and all(_terms_agg_eligible(a, svc.mappings)
                                     for a in aggs)
    t0 = time.perf_counter()
    executor = svc.mesh_executor()
    k = max(frm + size, 1)
    shard_segs = [list(s.segments) for s in searchers]
    if _any_nested(shard_segs) or _any_oversized(shard_segs):
        return None
    try:
        cands, totals, agg_rounds, mask_rounds = executor.search_dsl(
            query, svc.mappings, svc.analysis, k, shards=shard_segs,
            memo_key=lambda: _canonical(body),
            agg_specs=[(a.name, a.body["field"]) for a in aggs]
            if device_aggs else None,
            want_mask=bool(aggs) and not device_aggs,
            sort_spec=sort_spec or None, global_stats=global_stats)
    except MeshCompileError as e:
        return _BY_DESIGN if e.by_design else None
    except CircuitBreakingException:
        # a rehydration denied by the breaker: the host loop serves the
        # request shard by shard, where a shard that trips becomes a
        # ``_shards.failures`` entry
        return None
    groups = stats_groups(body)
    q_ms = (time.perf_counter() - t0) * 1e3
    for s in searchers:
        s.stats.on_query(q_ms / len(searchers), groups=groups)

    if sort_spec:
        page = _sorted_page(cands, shard_segs, sort_spec, k)[frm: frm + size]
        max_score = None
    else:
        page = [ShardDoc(sh, shard_segs[sh][seg_ord], local, val)
                for val, sh, seg_ord, local in cands][frm: frm + size]
        max_score = max(v for v, *_ in cands) if cands else None

    # fetch phase per shard, then restore the global order
    by_shard: Dict[int, List[ShardDoc]] = {}
    for d in page:
        by_shard.setdefault(d.shard_ord, []).append(d)
    fetched: Dict[int, dict] = {}
    for sh, ds in by_shard.items():
        tf = time.perf_counter()
        for d, h in zip(ds, searchers[sh].fetch_phase(ds, body, svc.name)):
            fetched[id(d)] = h
        searchers[sh].stats.on_fetch((time.perf_counter() - tf) * 1e3,
                                     groups=groups)
    response: Dict[str, Any] = {
        "took": int((time.perf_counter() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": len(searchers), "successful": len(searchers),
                    "failed": 0},
        "hits": {
            "total": totals,
            "max_score": max_score,
            "hits": [fetched[id(d)] for d in page],
        },
    }
    if aggs:
        if device_aggs:
            kernels.record("agg_terms_device")
            partials, shards = _agg_partials(aggs, agg_rounds)
        else:
            kernels.record("agg_mask")
            # a join in a filter agg prepares over its shard's segments
            rounds = sorted(mask_rounds, key=lambda r: (r[0], r[1]))
            partials = [
                run_aggs(aggs, SegmentContext(seg, svc.mappings,
                                              svc.analysis,
                                              index_name=svc.name,
                                              all_segments=shard_segs[sh]),
                         mask)
                for sh, _seg_ord, seg, mask in rounds]
            shards = [r[0] for r in rounds]
        partials = _psum_merge_partials(executor, aggs, partials, shards)
        response["aggregations"] = reduce_aggs(aggs, partials)
    return response


def _sorted_page(cands, shard_segs, sort_spec, k: int) -> List[ShardDoc]:
    """The global top ``k`` of the slots' sorted candidates by (value
    tuple, shard, segment, local), the host loop's merge order, each with
    its sort values."""
    docs = []
    for _v, sh, seg_ord, local in cands:
        seg = shard_segs[sh][seg_ord]
        sv = tuple(_sort_value(seg, s, local, None) for s in sort_spec)
        docs.append((_sort_key(sv, sort_spec), sh, seg_ord, local, seg, sv))
    docs.sort(key=lambda t: t[:4])
    return [ShardDoc(sh, seg, local, float("nan"), sv)
            for _key, sh, _o, local, seg, sv in docs[:k]]


def _terms_agg_eligible(agg, mappings) -> bool:
    """A keyword ``terms`` agg without sub-aggregations: the round counts
    it on the card."""
    if type(agg) is not TermsAggregator or agg.subs:
        return False
    field = agg.body.get("field")
    fm = mappings.get(field) if field is not None else None
    return fm is not None and fm.is_keyword


def _agg_partials(aggs, agg_rounds):
    """The rounds' count vectors → per-(shard, segment) partials in the
    shape ``TermsAggregator.collect`` makes (the same shard_size and
    min_doc_count selection), sorted by (shard, segment), the host
    loop's order. Returns (partials, the shard of each): the shards feed
    the cross-device merge."""
    by_seg: Dict[tuple, dict] = {}
    for agg in aggs:
        for sh, seg_ord, seg, counts in agg_rounds.get(agg.name, []):
            inv = seg.inverted.get(agg.body.get("field"))
            keys = inv.terms if inv is not None else []
            by_seg.setdefault((sh, seg_ord), {})[agg.name] = \
                agg.partial_from_counts(counts[: len(keys)], keys)
    items = sorted(by_seg.items())
    return [p for _, p in items], [sh for (sh, _o), _ in items]


def _psum_merge_partials(executor, aggs, partial_dicts, partial_shards):
    """The cross-shard merge of the integer lanes on a mesh of several
    devices (the reference's ``mesh_psum`` leg): for each agg whose
    partials span two shards or more and whose type has an exact device
    form, its per-shard integer lanes stack into one ``[S, L]`` array
    (shard i on slot i % S, so on device i % n), sum across the devices
    in int64 (``executor.psum_partials``) and replace that agg's
    partials with one pre-merged partial. Float lanes are folded on the
    host in partial order by ``reduce``'s own f64 sum (Python's
    ``sum()``, compensated since 3.12; the reference's ``+=`` loop can
    differ from its own reduce there in the last bits, ROADMAP C35), so
    the merged partial reduces to the very response the partials would.
    Within a shard (across its segments) the fold stays on the host. An
    agg the merge cannot express (a terms agg whose buckets carry
    sub-aggs, any other type) keeps its partials; ``reduce_aggs`` takes
    the mix. The lanes are int64, so no total is too large for the device
    sum (the reference's int32 lanes decline past 2^31 to this same
    answer). A failure raises; there is no quiet route to the host fold.
    One device: the partials as they are."""
    if executor is None or getattr(executor, "n_devices", 1) < 2:
        return partial_dicts
    merged: Dict[str, Any] = {}
    for agg in aggs:
        rows = [(sh, p[agg.name])
                for sh, p in zip(partial_shards, partial_dicts)
                if p is not None and agg.name in p]
        if len({sh for sh, _ in rows}) < 2:
            continue  # nothing crosses a shard boundary
        m = _device_merge_one(executor, agg, rows)
        if m is not None:
            merged[agg.name] = m
    if not merged:
        return partial_dicts
    out = [{k: v for k, v in p.items() if k not in merged}
           for p in partial_dicts if p is not None]
    out = [p for p in out if p]
    out.append(merged)
    return out


def _psum_int_lanes(executor, per_shard: Dict[int, np.ndarray]
                    ) -> np.ndarray:
    """{shard: int64[L]} → the exact int64[L] sum over the shards,
    summed across the mesh's devices: each shard's lanes on its slot
    (shard i → slot i % S; shards past the slots pre-fold onto theirs,
    integer adds, exact)."""
    S = executor.S
    L = next(iter(per_shard.values())).shape[0]
    arr = np.zeros((S, L), np.int64)
    for sh, v in per_shard.items():
        arr[sh % S] += v
    return executor.psum_partials(arr)


def _device_merge_one(executor, agg, rows):
    """One agg's cross-shard merge → a single pre-merged partial (what
    ``reduce`` makes of the rows), or None when the agg type has no
    exact device form."""
    from elasticsearch_tpu_torch.search.aggregations.metrics import (
        AvgAggregator, ExtendedStatsAggregator, StatsAggregator,
        ValueCountAggregator)

    if type(agg) is TermsAggregator:
        ps = [p for _, p in rows]
        if any("subs" in b for p in ps for b in p["buckets"].values()):
            return None  # sub-agg partials must reach reduce_subs intact
        keys = sorted({k for p in ps for k in p["buckets"]}, key=repr)
        idx = {k: i for i, k in enumerate(keys)}
        per_shard: Dict[int, np.ndarray] = {}
        for sh, p in rows:
            v = per_shard.setdefault(sh, np.zeros(len(keys) + 1, np.int64))
            for k2, b in p["buckets"].items():
                v[idx[k2]] += int(b["doc_count"])
            v[len(keys)] += int(p.get("sum_other_doc_count", 0))
        tot = _psum_int_lanes(executor, per_shard)
        return {
            "buckets": {k: {"doc_count": int(tot[i])}
                        for i, k in enumerate(keys)},
            "sum_other_doc_count": int(tot[len(keys)]),
            "order": rows[0][1].get("order", {"_count": "desc"}),
            "doc_count_error_upper_bound": 0,
        }
    if type(agg) is ValueCountAggregator:
        per_shard = {}
        for sh, p in rows:
            v = per_shard.setdefault(sh, np.zeros(1, np.int64))
            v[0] += int(p)
        return int(_psum_int_lanes(executor, per_shard)[0])
    if type(agg) is AvgAggregator:
        per_shard = {}
        for sh, p in rows:
            v = per_shard.setdefault(sh, np.zeros(1, np.int64))
            v[0] += int(p[1])
        # reduce()'s own f64 fold, in partial order: Python's sum()
        s_host = sum(p[0] for _, p in rows)
        return (s_host, int(_psum_int_lanes(executor, per_shard)[0]))
    if type(agg) in (StatsAggregator, ExtendedStatsAggregator):
        per_shard = {}
        for sh, p in rows:
            v = per_shard.setdefault(sh, np.zeros(1, np.int64))
            v[0] += int(p["count"])
        mns = [p["min"] for _, p in rows if p["min"] is not None]
        mxs = [p["max"] for _, p in rows if p["max"] is not None]
        tot = _psum_int_lanes(executor, per_shard)
        out = {"count": int(tot[0]), "sum": sum(p["sum"] for _, p in rows),
               "min": min(mns) if mns else None,
               "max": max(mxs) if mxs else None}
        if type(agg) is ExtendedStatsAggregator:
            out["sum_sq"] = sum(p["sum_sq"] for _, p in rows)
        return out
    return None

