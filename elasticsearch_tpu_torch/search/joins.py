"""Join queries: nested (block join), has_child, has_parent.

Port of elasticsearch_tpu/search/joins.py (NestedQueryBuilder over
Lucene's ToParentBlockJoinQuery, HasChildQueryBuilder and
HasParentQueryBuilder over the ``_parent`` field, ``top_children`` as
has_child's alias).

A nested join is a segmented reduction over the segment's block order:
every descendant of a doc lies in one contiguous run just before it, so
the selected children of each target (the root, or the enclosing nested
level's doc) are one run of the target array, and ``torch.segment_reduce``
sums each run in index order (the order of the reference's scatter-add on
the CPU) without atomics. Counts, max and min come the same way.

Parent/child spans segments (a child may be refreshed into another
segment than its parent), so has_child and has_parent ``prepare`` once a
request over every segment of the shard (``prepare_tree``, post-order):
the inner query runs a segment at a time on the device, and the join goes
through the ``_parent`` keyword column's ordinals: each child segment's
ordinals map once to the parents' local ids in every segment of the
shard (``parent_locals``), so no step walks the docs in Python. has_child
keeps the reference's f64 sums in (segment, local) order (``np.add.at``
applies in order); has_parent gathers its parents' scores onto the
children on the device.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.search.queries import Query, _empty
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

SCORE_MODES = ("avg", "sum", "max", "min", "none")


def run_reduce(values, target, mode: str, initial: float, D: int):
    """Per target doc the ``mode`` ("sum", "max", "min") of ``values``
    over the docs whose ``target`` it is, ``initial`` where none is: one
    ``segment_reduce`` over the runs of equal targets (block order makes
    each target's docs one run; a run of -1 targets nothing). Each run
    reduces in index order, the reference's, with no atomics."""
    runs, lengths = torch.unique_consecutive(target, return_counts=True)
    # a column of values: one thread a run adds its values in index
    # order on the card (a 1-D input would take a block-wide tree a run)
    red = torch.segment_reduce(values.view(-1, 1), mode, lengths=lengths,
                               initial=initial)[:, 0]
    out = torch.full((D + 1,), initial, dtype=values.dtype,
                     device=values.device)
    out[torch.where(runs >= 0, runs, D).long()] = red
    return out[:D]


class NestedQuery(Query):
    def __init__(self, path: str, inner: Query, score_mode: str = "avg",
                 boost: float = 1.0, inner_hits: Optional[dict] = None,
                 parent_path: Optional[str] = None):
        if score_mode not in SCORE_MODES:
            raise QueryParsingException(
                f"nested score_mode [{score_mode}] invalid")
        self.path = path
        self.inner = inner
        self.score_mode = score_mode
        self.boost = boost
        self.inner_hits = inner_hits
        # the enclosing nested scope at parse time: None joins to the
        # root docs, else to the enclosing path's level
        self.parent_path = parent_path

    def _join_target(self, seg):
        if self.parent_path is None:
            return seg.root_id_dev
        code = seg.nested_paths.get(self.parent_path)
        if code is None:
            return seg.root_id_dev
        return seg.ancestors_dev[code]

    def execute(self, ctx):
        seg = ctx.segment
        if not seg.has_nested or self.path not in seg.nested_paths:
            return _empty(ctx)
        sel, child_scores = self.child_selection(ctx)
        D = ctx.D
        # every doc keeps its own target, so each target's docs are one
        # run; the unselected ones add 0 (or the reduction's identity)
        tgt = self._join_target(seg)
        counts = run_reduce(sel.to(torch.float32), tgt, "sum", 0.0, D)
        parent_mask = counts > 0
        if self.score_mode == "none":
            return None, parent_mask
        if self.score_mode in ("avg", "sum"):
            sums = run_reduce(torch.where(sel, child_scores, 0.0), tgt,
                              "sum", 0.0, D)
            s = torch.div(sums, torch.clamp(counts, min=1.0)) \
                if self.score_mode == "avg" else sums
        else:
            ident = float("-inf" if self.score_mode == "max" else "inf")
            s = run_reduce(torch.where(sel, child_scores, ident), tgt,
                           self.score_mode, ident, D)
        return torch.where(parent_mask, s, 0.0) * self.boost, parent_mask

    def child_selection(self, ctx):
        """(sel bool[D], child_scores f32[D]): this path's matching live
        children, shared by ``execute`` and the inner_hits fetch."""
        seg = ctx.segment
        code = seg.nested_paths[self.path]
        child_scores, child_mask = self.inner.score_or_mask(ctx)
        sel = child_mask & (seg.nested_code_dev == code) & seg.live
        return sel, child_scores


def _parent_terms(seg) -> List[str]:
    inv = seg.inverted.get("_parent")
    return list(inv.terms) if inv is not None else []


def parent_locals(child_seg, parent_seg) -> np.ndarray:
    """Per ``_parent`` ordinal of ``child_seg``, the local id of the doc
    with that id in ``parent_seg`` (-1 where none), then one -1 for docs
    without a parent: the join between two (immutable) segments, built
    once a pair."""
    cache = child_seg.__dict__.setdefault("_parent_locals", {})
    got = cache.get(parent_seg.seg_id)
    if got is None:
        got = np.array([parent_seg.id_map.get(t, -1)
                        for t in _parent_terms(child_seg)] + [-1], np.int64)
        cache[parent_seg.seg_id] = got
    return got


def _selected(query, seg, ctx, type_name: str, default_all: bool = False):
    """(host mask, host f32 scores) of the live roots of ``type_name``
    that ``query`` matches in ``seg``."""
    scores, mask = query.score_or_mask(ctx)
    m = mask.cpu().numpy() & seg.live_host
    if seg.roots_host is not None:
        m = m & seg.roots_host
    return m & _type_mask(seg, type_name, default_all), scores.cpu().numpy()


class HasChildQuery(Query):
    """Parents with at least ``min_children`` (at most ``max_children``)
    children of ``child_type`` that match the inner query."""

    def __init__(self, child_type: str, inner: Query, score_mode: str = "none",
                 min_children: int = 1, max_children: int = 0,
                 boost: float = 1.0):
        self.child_type = child_type
        self.inner = inner
        self.score_mode = score_mode if score_mode != "score" else "max"
        self.min_children = max(1, min_children)
        self.max_children = max_children
        self.boost = boost
        # parent segment id -> per local doc (n, sum, max, min) in f64
        self._stats: Optional[Dict[int, tuple]] = None

    def prepare(self, segments, mappings, analysis, global_stats=None):
        """Per parent segment the matching children's count, f64 sum, max
        and min a parent doc, each child added where its parent's id lives
        in (child segment, local) order: the reference's Python floats,
        summed in its order (``np.add.at`` applies in order)."""
        from elasticsearch_tpu_torch.search.context import SegmentContext

        stats: Dict[int, tuple] = {}
        for seg in segments:
            pcol = seg.keywords.get("_parent")
            if pcol is None:
                continue
            ctx = SegmentContext(seg, mappings, analysis, global_stats)
            m, sc = _selected(self.inner, seg, ctx, self.child_type)
            ords = np.asarray(pcol.ords_host)
            locs = np.nonzero(m & (ords >= 0))[0]
            if locs.size == 0:
                continue
            sc = sc[locs].astype(np.float64)
            for par in segments:
                at = parent_locals(seg, par)[ords[locs]]
                ok = at >= 0
                if not ok.any():
                    continue
                D = par.max_docs
                n, s, mx, mn = stats.setdefault(par.seg_id, (
                    np.zeros(D), np.zeros(D), np.full(D, -np.inf),
                    np.full(D, np.inf)))
                at, v = at[ok], sc[ok]
                np.add.at(n, at, 1.0)
                np.add.at(s, at, v)
                np.maximum.at(mx, at, v)
                np.minimum.at(mn, at, v)
        self._stats = stats

    def execute(self, ctx):
        seg = ctx.segment
        got = (self._stats or {}).get(seg.seg_id)
        if got is None:
            return _empty(ctx)
        n, s, mx, mn = got
        keep = (n >= self.min_children) & seg.live_host
        if self.max_children:
            keep &= n <= self.max_children
        score = np.zeros(ctx.D, dtype=np.float32)
        if self.score_mode == "sum":
            score[keep] = s[keep]
        elif self.score_mode == "avg":
            score[keep] = s[keep] / n[keep]
        elif self.score_mode == "max":
            score[keep] = mx[keep]
        elif self.score_mode == "min":
            score[keep] = mn[keep]
        dm = torch.from_numpy(keep).to(ctx.device)
        if self.score_mode == "none":
            return None, dm
        return torch.from_numpy(score * self.boost).to(ctx.device), dm


class HasParentQuery(Query):
    """Children whose parent (of ``parent_type``) matches the inner
    query."""

    def __init__(self, parent_type: str, inner: Query, score_mode: str = "none",
                 boost: float = 1.0):
        self.parent_type = parent_type
        self.inner = inner
        self.score_mode = score_mode  # none | score
        self.boost = boost
        # (segment, host mask, host scores) of every segment with a match
        self._parents: Optional[list] = None

    def prepare(self, segments, mappings, analysis, global_stats=None):
        from elasticsearch_tpu_torch.search.context import SegmentContext

        found = []
        for seg in segments:
            ctx = SegmentContext(seg, mappings, analysis, global_stats)
            m, sc = _selected(self.inner, seg, ctx, self.parent_type,
                              default_all=True)
            if m.any():
                found.append((seg, m, sc))
        self._parents = found

    def execute(self, ctx):
        seg = ctx.segment
        pcol = seg.keywords.get("_parent")
        if not self._parents or pcol is None:
            return _empty(ctx)
        # per parent ordinal its parent's score (NaN: no match; a later
        # segment's match stands, as a later write of the id does), then
        # one gather onto the segment's docs on the device
        by_ord = np.full(len(_parent_terms(seg)) + 1, np.nan, np.float32)
        for par, m, sc in self._parents:
            at = parent_locals(seg, par)
            hit = (at >= 0) & m[np.maximum(at, 0)]
            by_ord[hit] = sc[at[hit]]
        by_ord = torch.from_numpy(by_ord).to(ctx.device)
        ords = pcol.ords.long()
        got = by_ord[torch.where(ords >= 0, ords, by_ord.numel() - 1)]
        mask = ~torch.isnan(got) & seg.live
        if self.score_mode == "none":
            return None, mask
        return torch.where(mask, got, 0.0) * self.boost, mask


def _type_mask(seg, type_name: str, default_all: bool = False) -> np.ndarray:
    """bool[max_docs]: docs whose ``_type`` is ``type_name`` (its host
    postings run). ``default_all``: a segment of docs indexed without a
    ``_type`` matches every type."""
    inv = seg.inverted.get("_type")
    if inv is None:
        return np.full(seg.max_docs, default_all, dtype=bool)
    s, ln = inv.term_slice(type_name)
    m = np.zeros(seg.max_docs, dtype=bool)
    if ln:
        m[inv.doc_ids_host[s: s + ln]] = True
    return m


# ---------------------------------------------------------------------------
# the shard-level preparation pass
# ---------------------------------------------------------------------------

def _children(q: Any):
    """The Query-valued attributes of a node, and those inside lists."""
    for v in (getattr(q, "__dict__", None) or {}).values():
        if isinstance(v, Query):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from (x for x in v if isinstance(x, Query))


def prepare_tree(q: Any, segments, mappings, analysis,
                 global_stats=None) -> None:
    """Run ``prepare`` on every node that needs a shard-wide pass
    (has_child, has_parent), children first: a join inside another join's
    inner query is ready before the outer one runs that query."""
    if q is None:
        return
    for c in _children(q):
        prepare_tree(c, segments, mappings, analysis, global_stats)
    if hasattr(q, "prepare"):
        q.prepare(segments, mappings, analysis, global_stats)


def collect_nested_inner_hits(q: Any, out: Optional[List[NestedQuery]] = None
                              ) -> List[NestedQuery]:
    """Every NestedQuery with an inner_hits spec, in tree order."""
    if out is None:
        out = []
    if isinstance(q, NestedQuery) and q.inner_hits is not None:
        out.append(q)
    for c in _children(q):
        collect_nested_inner_hits(c, out)
    return out


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

_SCOPE = threading.local()  # the nested-scope stack of this thread's parse


def parse_join_query(qtype: str, body: dict):
    from elasticsearch_tpu_torch.search.queries import parse_query

    if qtype == "nested":
        if "path" not in body or "query" not in body:
            raise QueryParsingException("nested requires [path] and [query]")
        stack = getattr(_SCOPE, "stack", None)
        if stack is None:
            stack = _SCOPE.stack = []
        parent_path = stack[-1] if stack else None
        stack.append(body["path"])
        try:
            inner = parse_query(body["query"])
        finally:
            stack.pop()
        return NestedQuery(
            body["path"], inner, score_mode=body.get("score_mode", "avg"),
            boost=float(body.get("boost", 1.0)),
            inner_hits=body.get("inner_hits"), parent_path=parent_path)
    if qtype in ("has_child", "top_children"):
        if "type" not in body or "query" not in body:
            raise QueryParsingException(
                f"{qtype} requires [type] and [query]")
        return HasChildQuery(
            body["type"], parse_query(body["query"]),
            score_mode=body.get("score_mode", body.get("score_type", "none")),
            min_children=int(body.get("min_children", 1)),
            max_children=int(body.get("max_children", 0)),
            boost=float(body.get("boost", 1.0)))
    if qtype == "has_parent":
        ptype = body.get("parent_type", body.get("type"))
        if ptype is None or "query" not in body:
            raise QueryParsingException(
                "has_parent requires [parent_type] and [query]")
        return HasParentQuery(
            ptype, parse_query(body["query"]),
            score_mode=body.get("score_mode", body.get("score_type", "none")),
            boost=float(body.get("boost", 1.0)))
    raise QueryParsingException(f"unknown join query [{qtype}]")
