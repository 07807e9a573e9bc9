"""Percolator: match documents against registered queries.

Port of elasticsearch_tpu/search/percolator.py (reference: ES's
PercolatorService, which builds a one-doc in-memory index and runs every
registered query against it). Queries register by indexing docs of type
``.percolator`` whose source holds a ``query``. To percolate, the docs
are parsed through the index's analysis chain and frozen into one
segment on the index's device; each registered query runs once over
that segment, and its mask is read at each doc's root. The term leaves
of all the queries (a term, a plain OR match, also inside bools) are
answered together, by one postings pass a field, and the bools that hold
them combine those masks by ``BoolQuery.mask``, without scoring; a query
of any other type runs its own program.

The segment is real device data: it is charged to the ``segments``
breaker while it lives (its columns to ``fielddata``, as any segment's)
and freed, with both charges released, when the call ends
(``percolate_segment``). A query that raises ElasticsearchTpuException
(an unmapped field, say) matches nothing; any other error raises.
"""
from __future__ import annotations

import copy
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch.index.doc_parser import DocumentParser
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops.scoring import _upload_tables, \
    match_count_runs
from elasticsearch_tpu_torch.search.context import SegmentContext
from elasticsearch_tpu_torch.search.highlight import (extract_query_terms,
                                                      highlight_field)
from elasticsearch_tpu_torch.search.queries import (BoolQuery, MatchQuery,
                                                    Query, TermQuery,
                                                    parse_query,
                                                    rewrite_mlt_in_body)
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

PERCOLATOR_TYPE = ".percolator"


class PercolatorRegistry:
    """The registered queries of one index, parsed once a doc id and
    replaced when the id re-registers (reference:
    PercolatorQueriesRegistry)."""

    def __init__(self):
        self._queries: Dict[str, Any] = {}  # id -> (raw dsl, parsed Query)
        self._lock = threading.Lock()
        # the index's doc lookup for queries that name docs (terms lookup,
        # more_like_this ids), resolved when the query registers
        self.doc_lookup = None

    def validate(self, source: dict):
        """Parse the query without registering it: called before the doc
        is written, so an invalid query never reaches the translog."""
        if not isinstance(source, dict) or "query" not in source:
            raise ElasticsearchTpuException(
                "percolator document requires a [query] field")
        q = source["query"]
        if self.doc_lookup is not None:
            q = rewrite_mlt_in_body(q, self.doc_lookup)
        return q, parse_query(q)

    def register(self, doc_id: str, source: dict) -> None:
        raw, parsed = self.validate(source)
        with self._lock:
            self._queries[doc_id] = (raw, parsed)

    def unregister(self, doc_id: str) -> None:
        with self._lock:
            self._queries.pop(doc_id, None)

    def __len__(self) -> int:
        return len(self._queries)

    def items(self):
        with self._lock:  # a snapshot: writers may register meanwhile
            return list(self._queries.items())


@contextmanager
def percolate_segment(docs: List[dict], mappings, analysis,
                      residency) -> Iterator[Optional[SegmentContext]]:
    """The docs frozen into one segment on ``residency``'s device, as a
    SegmentContext (None when no doc gives one): charged to the
    ``segments`` breaker for the block, then freed with every charge it
    made released."""
    parser = DocumentParser(mappings, analysis)
    builder = SegmentBuilder(mappings, residency)
    for i, d in enumerate(docs):
        builder.add(parser.parse(f"_percolate_{i}", d))
    seg = builder.freeze()
    if seg is None:
        yield None
        return
    br = residency.breakers.breaker("segments")
    n = seg.memory_bytes()
    try:
        br.break_or_reserve(n, label="percolate")
    except BaseException:
        seg.release_fielddata()
        raise
    try:
        yield SegmentContext(seg, mappings, analysis)
    finally:
        br.release(n)
        seg.release_fielddata()


def _term_leaf(q, ctx):
    """(field, terms) of a query whose match mask is "the doc holds one of
    ``terms`` in ``field``": a term on a field that is not numeric, a
    plain OR ``match`` (no operator ``and``, minimum_should_match or
    fuzziness). None for any other query."""
    if type(q) is TermQuery:
        fm = ctx.mappings.get(q.field)
        if fm is not None and fm.is_numeric:
            return None
        return q.field, [q._term_str(ctx)]
    if type(q) is MatchQuery and q.operator == "or" and q.msm is None \
            and q.fuzziness is None:
        return q.field, q._analyze(ctx)
    return None


def _leaves(q, ctx, out: Dict[int, tuple]) -> None:
    """The term leaves of ``q`` (itself, or inside bool clauses)."""
    leaf = _term_leaf(q, ctx)
    if leaf is not None:
        out[id(q)] = leaf
    elif type(q) is BoolQuery:
        for c in q.must + q.filter + q.must_not + q.should:
            _leaves(c, ctx, out)


def _leaf_masks(ctx, leaves: Dict[int, tuple]) -> Dict[int, torch.Tensor]:
    """Every term leaf's mask, one postings pass a field for all of them:
    a leaf's row counts its terms' postings at each doc (its mask is the
    docs counted at least once)."""
    out: Dict[int, torch.Tensor] = {}
    by_field: Dict[str, List[int]] = {}
    for key, (field, _terms) in leaves.items():
        by_field.setdefault(field, []).append(key)
    for field, keys in by_field.items():
        inv = ctx.inv(field)
        if inv is None:
            zero = torch.zeros(ctx.D, dtype=torch.bool, device=ctx.device)
            out.update((k, zero) for k in keys)
            continue
        runs = []
        for k in keys:
            got = [inv.term_slice(t) for t in dict.fromkeys(leaves[k][1])]
            runs.append([r for r in got if r[1]])
        T = max(1, max(len(r) for r in runs))
        starts = np.zeros((len(keys), T), np.int32)
        lens = np.zeros((len(keys), T), np.int32)
        for g, r in enumerate(runs):
            for t, (st, ln) in enumerate(r):
                starts[g, t], lens[g, t] = st, ln
        st, ln, _w, _b, sizes = _upload_tables(
            inv.doc_ids, starts, lens, np.zeros((len(keys), T), np.float32))
        hit = match_count_runs(inv.doc_ids, st, ln, sizes, D=ctx.D) > 0
        out.update((k, hit[g]) for g, k in enumerate(keys))
    return out


class _LeafMask(Query):
    """A term leaf answered by the batched pass: its mask, no scores."""

    def __init__(self, hit: torch.Tensor):
        self.hit = hit

    def execute(self, ctx):
        return None, self.hit


def _with_leaf_masks(q, leaf_masks: Dict[int, torch.Tensor]):
    """``q`` with each term leaf (itself, or inside bool clauses) replaced
    by its mask from the batched pass; the bools are shallow copies, so
    the registered tree stays as it is, and their ``mask`` is
    ``BoolQuery``'s own."""
    got = leaf_masks.get(id(q))
    if got is not None:
        return _LeafMask(got)
    if type(q) is not BoolQuery:
        return q
    b = copy.copy(q)
    for name in ("must", "filter", "must_not", "should"):
        setattr(b, name, [_with_leaf_masks(c, leaf_masks)
                          for c in getattr(q, name)])
    return b


def match_queries(registry: PercolatorRegistry, ctx: SegmentContext,
                  n: int) -> List[List[str]]:
    """Each doc's matching query ids, sorted: every query's mask over the
    segment, read at each doc's root (a doc's nested children precede
    it), all masks copied back in one transfer. The term leaves of every
    query (terms, plain matches, inside bools too) are answered by one
    postings pass a field; the rest run their own programs."""
    seg = ctx.segment
    roots = torch.tensor([seg.id_map[f"_percolate_{i}"] for i in range(n)],
                         dtype=torch.int64, device=seg.device)
    items = registry.items()
    leaves: Dict[int, tuple] = {}
    for _qid, (_raw, q) in items:
        _leaves(q, ctx, leaves)
    leaf_masks = _leaf_masks(ctx, leaves)
    qids, rows = [], []
    for qid, (_raw, q) in items:
        try:
            mask = _with_leaf_masks(q, leaf_masks).mask(ctx)
        except ElasticsearchTpuException:
            continue  # a query on an unmapped field never matches
        qids.append(qid)
        rows.append(mask.index_select(0, roots))
    matches: List[List[str]] = [[] for _ in range(n)]
    if rows:
        hit = torch.stack(rows).cpu().numpy()
        for j, qid in enumerate(qids):
            for i in hit[j].nonzero()[0].tolist():
                matches[i].append(qid)
    for row in matches:
        row.sort()
    return matches


def percolate(registry: PercolatorRegistry, docs: List[dict], mappings,
              analysis, residency):
    """(each doc's full sorted list of matching query ids, the number of
    queries evaluated). All docs go into one segment, so each query runs
    once for the batch."""
    empty = ([[] for _ in docs], 0)
    if not len(registry):
        return empty
    with percolate_segment(docs, mappings, analysis, residency) as ctx:
        if ctx is None:
            return empty
        return match_queries(registry, ctx, len(docs)), len(registry)


def highlight_matches(doc: dict, queries_by_id, hl_spec: dict,
                      ctx: SegmentContext) -> dict:
    """Highlight the percolated doc once a matching query: each match's
    snippets come from that query's terms, or from the field's
    ``highlight_query`` (reference: PercolateContext's highlighting).
    ``queries_by_id``: qid -> (raw dsl, parsed Query), the registry's own
    entries; ``ctx`` is the percolate batch's segment."""
    pre = (hl_spec.get("pre_tags") or ["<em>"])[0]
    post = (hl_spec.get("post_tags") or ["</em>"])[0]
    out = {}
    for qid, (_raw, parsed) in queries_by_id.items():
        per_field = {}
        for fname, fspec in (hl_spec.get("fields") or {}).items():
            raw_text = doc.get(fname)
            if not isinstance(raw_text, str):
                continue
            fspec = fspec or {}
            q_spec = fspec.get("highlight_query")
            try:
                query = parse_query(q_spec) if q_spec is not None else parsed
                terms = extract_query_terms(query, fname, ctx)
            except ElasticsearchTpuException:
                continue
            frags = highlight_field(
                raw_text, terms, ctx.search_analyzer(fname),
                pre_tag=pre, post_tag=post,
                fragment_size=int(fspec.get("fragment_size", 100)),
                number_of_fragments=int(fspec.get("number_of_fragments", 5)))
            if frags:
                per_field[fname] = frags
        if per_field:
            out[qid] = per_field
    return out
