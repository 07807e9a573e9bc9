"""Span queries: positional interval algebra.

Port of elasticsearch_tpu/search/spans.py (reference:
org/elasticsearch/index/query/Span*QueryBuilder.java and
FieldMaskingSpanQueryBuilder.java over Lucene's SpanQuery family).

The common shapes run as programs on the card over the field's
positional CSR (``ops/positional.py``), never a walk per doc:

* span_near over span_term clauses, in order at any arity and out of
  order with two clauses: ``phrase_freq_program``'s ordered and unordered
  modes, scored with Lucene's sloppy freq (idf_sum * tfNorm(Σ
  1/(1+matchLength))). Out of order with three or more clauses goes to
  the host walk, as in the reference: the nearest-per-clause program can
  miss a window there (``test_torch_spans.py`` pins the counterexample);
* span_term, span_or over terms and span_multi: the match set is the
  terms' union mask;
* span_first over a term union: each posting's first position, gathered
  on the card from the positional CSR;
* span_not with term-union include and exclude: ``span_not_program``.

Anything deeper (near of near, field_masking combinations) takes the
host walk: candidate docs by set algebra over the postings, intervals
verified doc by doc, scored as summed unigram BM25 over the tree's
terms. The reference's ``scatter_free`` and ``tail_mode_batch`` switches
are TPU workarounds and are not ported.

A span node yields, per doc, a sorted list of half-open intervals
(start, end) over token positions.
"""
from __future__ import annotations

import fnmatch
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.ops.positional import (build_phrase_inputs,
                                                    build_union_anchor_inputs,
                                                    phrase_freq_program,
                                                    phrase_score,
                                                    positional_device,
                                                    span_not_program)
from elasticsearch_tpu_torch.search.queries import (Query, _edit_distance_le,
                                                    _expand_prefix,
                                                    _score_term_group,
                                                    _terms_filter_mask)
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

Interval = Tuple[int, int]

# cap per-clause spans considered in the host near-combination walk (it
# guards the combinatorial search on pathological docs). Truncation is
# surfaced: the ``span_clause_truncated`` counter ticks whenever a clause
# exceeds the cap.
MAX_SPANS_PER_CLAUSE = 128


def _positions_for(inv, term: str, doc: int) -> Optional[np.ndarray]:
    s, ln = inv.term_slice(term)
    if ln == 0 or inv.doc_ids_host is None:
        return None
    run = inv.doc_ids_host[s: s + ln]
    k = int(np.searchsorted(run, doc))
    if k >= ln or run[k] != doc:
        return None
    e = s + k
    return inv.positions[int(inv.pos_offsets[e]): int(inv.pos_offsets[e + 1])]


class SpanNode:
    """Base: a compiled span expression bound to one field."""

    field: str

    def candidate_docs(self, ctx) -> np.ndarray:
        """Sorted int32 doc ids that *may* contain a span (superset)."""
        raise NotImplementedError

    def spans(self, ctx, doc: int) -> List[Interval]:
        raise NotImplementedError

    def any_span(self, ctx, doc: int) -> bool:
        """Existence check, overridden where a full spans() enumeration
        would be wasteful (SpanNearNode's combination walk)."""
        return bool(self.spans(ctx, doc))

    def terms(self) -> List[Tuple[str, str]]:
        """(field, term) leaves: used for BM25 scoring of matched docs."""
        raise NotImplementedError


class SpanTermNode(SpanNode):
    def __init__(self, field: str, term: str):
        self.field = field
        self.term = term

    def candidate_docs(self, ctx) -> np.ndarray:
        inv = ctx.inv(self.field)
        if inv is None or inv.doc_ids_host is None:
            return np.zeros(0, dtype=np.int32)
        s, ln = inv.term_slice(self.term)
        return inv.doc_ids_host[s: s + ln]

    def spans(self, ctx, doc: int) -> List[Interval]:
        inv = ctx.inv(self.field)
        if inv is None or inv.positions is None:
            return []
        p = _positions_for(inv, self.term, doc)
        if p is None:
            return []
        return [(int(x), int(x) + 1) for x in p]

    def terms(self):
        return [(self.field, self.term)]


class SpanMultiNode(SpanNode):
    """span_multi: wildcard/prefix/fuzzy/regexp expanded to a term union
    (Lucene SpanMultiTermQueryWrapper)."""

    def __init__(self, field: str, expand_fn):
        self.field = field
        self._expand = expand_fn  # ctx -> List[str]
        # per-segment expansion cache: term dictionaries differ per
        # segment, and the parsed tree serves every segment of a shard
        self._expanded: dict = {}

    def _exp(self, ctx) -> List[str]:
        key = ctx.segment.seg_id
        got = self._expanded.get(key)
        if got is None:
            got = self._expanded[key] = list(self._expand(ctx))
        return got

    def candidate_docs(self, ctx) -> np.ndarray:
        inv = ctx.inv(self.field)
        if inv is None or inv.doc_ids_host is None:
            return np.zeros(0, dtype=np.int32)
        runs = []
        for t in self._exp(ctx):
            s, ln = inv.term_slice(t)
            if ln:
                runs.append(inv.doc_ids_host[s: s + ln])
        if not runs:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(runs))

    def spans(self, ctx, doc: int) -> List[Interval]:
        inv = ctx.inv(self.field)
        if inv is None or inv.positions is None:
            return []
        out: List[Interval] = []
        for t in self._exp(ctx):
            p = _positions_for(inv, t, doc)
            if p is not None:
                out.extend((int(x), int(x) + 1) for x in p)
        out.sort()
        return out

    def terms(self):
        # the leaves are the segment's expansion: SpanQueryWrapper adds
        # them through expanded_terms
        return []

    def expanded_terms(self, ctx):
        return [(self.field, t) for t in self._exp(ctx)]


class SpanOrNode(SpanNode):
    def __init__(self, clauses: Sequence[SpanNode]):
        if not clauses:
            raise QueryParsingException("span_or requires [clauses]")
        self.clauses = list(clauses)
        self.field = clauses[0].field

    def candidate_docs(self, ctx) -> np.ndarray:
        runs = [c.candidate_docs(ctx) for c in self.clauses]
        runs = [r for r in runs if r.size]
        if not runs:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(runs))

    def spans(self, ctx, doc: int) -> List[Interval]:
        out: List[Interval] = []
        for c in self.clauses:
            out.extend(c.spans(ctx, doc))
        return sorted(set(out))

    def terms(self):
        return [t for c in self.clauses for t in c.terms()]


class SpanNearNode(SpanNode):
    """Lucene SpanNearQuery: every clause matches, combined width minus the
    sum of clause lengths ≤ slop; in_order additionally requires clause
    spans to appear in clause order without overlap."""

    def __init__(self, clauses: Sequence[SpanNode], slop: int = 0,
                 in_order: bool = True):
        if not clauses:
            raise QueryParsingException("span_near requires [clauses]")
        self.clauses = list(clauses)
        self.slop = slop
        self.in_order = in_order
        self.field = clauses[0].field

    def candidate_docs(self, ctx) -> np.ndarray:
        doc_sets = [c.candidate_docs(ctx) for c in self.clauses]
        out = doc_sets[0]
        for ds in doc_sets[1:]:
            out = np.intersect1d(out, ds, assume_unique=False)
            if out.size == 0:
                break
        return out

    def _clause_spans(self, ctx, doc: int
                      ) -> Optional[List[List[Interval]]]:
        full = [c.spans(ctx, doc) for c in self.clauses]
        per = [p[:MAX_SPANS_PER_CLAUSE] for p in full]
        if any(len(f) > MAX_SPANS_PER_CLAUSE for f in full):
            kernels.record("span_clause_truncated")
        if any(not p for p in per):
            return None
        return per

    def _walk(self, per: List[List[Interval]], first_only: bool
              ) -> List[Interval]:
        """Combination walk over per-clause span lists. Pruning: adding a
        span never shrinks the window spread, and each remaining clause
        can add at most its longest span to the total length, so a partial
        whose matchSlop can no longer reach ``slop`` is dead. With
        first_only the walk stops at the first valid window."""
        if not self.in_order:
            # unordered combinations are order-free: walk the scarcest
            # clause first so dead branches die at depth 1
            per = sorted(per, key=len)
        max_len = [max(e - s for s, e in p) for p in per]
        suffix = [0] * (len(per) + 1)
        for i in range(len(per) - 1, -1, -1):
            suffix[i] = suffix[i + 1] + max_len[i]
        found: List[Interval] = []

        def rec(i: int, chosen: List[Interval], lo: int, hi: int, tl: int
                ) -> bool:
            if i == len(per):
                if (hi - lo) - tl <= self.slop:
                    found.append((lo, hi))
                    return first_only
                return False
            for sp in per[i]:
                if self.in_order and chosen and sp[0] < chosen[-1][1]:
                    continue
                nlo = min(lo, sp[0]) if chosen else sp[0]
                nhi = max(hi, sp[1]) if chosen else sp[1]
                ntl = tl + (sp[1] - sp[0])
                if (nhi - nlo) - (ntl + suffix[i + 1]) > self.slop:
                    continue  # no suffix completion can recover
                if rec(i + 1, chosen + [sp], nlo, nhi, ntl):
                    return True
            return False

        rec(0, [], 0, 0, 0)
        return sorted(set(found))

    def any_span(self, ctx, doc: int) -> bool:
        per = self._clause_spans(ctx, doc)
        return bool(per and self._walk(per, first_only=True))

    def spans(self, ctx, doc: int) -> List[Interval]:
        per = self._clause_spans(ctx, doc)
        if per is None:
            return []
        return self._walk(per, first_only=False)

    def terms(self):
        return [t for c in self.clauses for t in c.terms()]


class SpanNotNode(SpanNode):
    def __init__(self, include: SpanNode, exclude: SpanNode, pre: int = 0,
                 post: int = 0):
        self.include = include
        self.exclude = exclude
        self.pre = pre
        self.post = post
        self.field = include.field

    def candidate_docs(self, ctx) -> np.ndarray:
        return self.include.candidate_docs(ctx)

    def spans(self, ctx, doc: int) -> List[Interval]:
        inc = self.include.spans(ctx, doc)
        if not inc:
            return []
        exc = self.exclude.spans(ctx, doc)
        if not exc:
            return inc
        out = []
        for s, e in inc:
            lo, hi = s - self.pre, e + self.post
            if not any(xs < hi and xe > lo for xs, xe in exc):
                out.append((s, e))
        return out

    def terms(self):
        return self.include.terms()  # exclusion terms don't contribute score


class SpanFirstNode(SpanNode):
    def __init__(self, match: SpanNode, end: int):
        self.match = match
        self.end = end
        self.field = match.field

    def candidate_docs(self, ctx) -> np.ndarray:
        return self.match.candidate_docs(ctx)

    def spans(self, ctx, doc: int) -> List[Interval]:
        return [(s, e) for s, e in self.match.spans(ctx, doc)
                if e <= self.end]

    def terms(self):
        return self.match.terms()


class FieldMaskingSpanNode(SpanNode):
    """Reports the inner spans under a different field name so they can join
    a SpanNear/Or across fields that share position semantics (Lucene
    FieldMaskingSpanQuery)."""

    def __init__(self, inner: SpanNode, field: str):
        self.inner = inner
        self.field = field

    def candidate_docs(self, ctx) -> np.ndarray:
        return self.inner.candidate_docs(ctx)

    def spans(self, ctx, doc: int) -> List[Interval]:
        return self.inner.spans(ctx, doc)

    def terms(self):
        return self.inner.terms()


# ---------------------------------------------------------------------------
# query-tree integration
# ---------------------------------------------------------------------------


class SpanQueryWrapper(Query):
    """A SpanNode in the (scores, mask) query protocol: the common shapes
    on the card (module docstring), anything else by the host walk, its
    matched docs scored with summed unigram BM25 over the span tree's
    terms."""

    def __init__(self, node: SpanNode, boost: float = 1.0):
        self.node = node
        self.boost = boost

    def execute(self, ctx):
        fast = self._device_fast(ctx)
        if fast is not None:
            kernels.record("span_device")
            return fast
        kernels.record("span_host_walk")
        cand = self.node.candidate_docs(ctx)
        ok = np.zeros(ctx.D, dtype=bool)
        for d in np.unique(cand):
            if self.node.any_span(ctx, int(d)):
                ok[d] = True
        mask = torch.from_numpy(ok).to(ctx.device)
        if not ok.any():
            return None, mask
        return self._score_leaves(ctx, mask)

    def _score_leaves(self, ctx, mask):
        """Summed unigram BM25 over the tree's terms × the match mask (the
        scoring convention for every non-near span shape)."""
        leaves = self.node.terms()
        for n in _walk_multis(self.node):
            leaves.extend(n.expanded_terms(ctx))
        by_field = {}
        for f, t in leaves:
            by_field.setdefault(f, []).append(t)
        scores = None
        for f, ts in by_field.items():
            s, _, _ = _score_term_group(ctx, f, ts, self.boost)
            scores = s if scores is None else scores + s
        if scores is None:
            scores = mask.to(torch.float32) * self.boost
        return scores * mask, mask

    def _device_fast(self, ctx):
        """The common span shapes on the card (module docstring); None →
        the host interval walk."""
        node = self.node
        if isinstance(node, SpanNearNode):
            return self._device_near(ctx, node)
        if isinstance(node, (SpanTermNode, SpanOrNode, SpanMultiNode)):
            terms = _union_terms(node, ctx)
            if terms is None:
                return None
            field, ts = terms
            return self._score_leaves(ctx, _terms_filter_mask(ctx, field, ts))
        if isinstance(node, SpanFirstNode):
            inner = _union_terms(node.match, ctx)
            if inner is None:
                return None
            field, ts = inner
            mask = _first_position_mask(ctx, field, ts, node.end)
            if mask is None:
                return None
            return self._score_leaves(ctx, mask)
        if isinstance(node, SpanNotNode):
            return self._device_not(ctx, node)
        return None

    def _device_near(self, ctx, node):
        """span_near over span_term clauses, in order and (two clauses)
        out of order: one anchor-entry program over the positional CSR,
        scored with sloppy freq (idf_sum * tfNorm(Σ weights))."""
        if not all(isinstance(c, SpanTermNode) for c in node.clauses):
            return None
        if len({c.field for c in node.clauses}) != 1 \
                or len(node.clauses) < 2:
            return None
        if not node.in_order and len(node.clauses) >= 3:
            # the nearest-per-clause program can miss valid windows here
            # (the nearest occurrence of clause B can push the window over
            # the slop when a farther B admits a tighter one with C); the
            # host walk explores every combination
            return None
        inv = ctx.inv(node.field)
        if inv is None or inv.positions is None:
            return None
        terms = [c.term for c in node.clauses]
        if any(t not in inv.vocab for t in terms):
            return None, torch.zeros(ctx.D, dtype=torch.bool,
                                     device=ctx.device)
        # the near modes ignore the deltas; clauses chain (ordered) or
        # take the nearest windows (unordered)
        inputs = build_phrase_inputs(inv, [(t, i) for i, t in
                                           enumerate(terms)], ctx.D)
        if inputs is None:
            return None, torch.zeros(ctx.D, dtype=torch.bool,
                                     device=ctx.device)
        freq = phrase_freq_program(*inputs, slop=int(node.slop), D=ctx.D,
                                   ordered=node.in_order,
                                   unordered=not node.in_order)
        idf_sum = sum(ctx.idf(node.field, t) for t in dict.fromkeys(terms))
        lengths = ctx.segment.field_lengths.get(node.field)
        if lengths is None:
            lengths = torch.zeros(ctx.D, dtype=torch.float32,
                                  device=ctx.device)
        scores = phrase_score(freq, lengths.to(torch.float32),
                              float(np.float32(inv.avg_len)),
                              float(np.float32(idf_sum))) * self.boost
        return scores, freq > 0

    def _device_not(self, ctx, node):
        """span_not with term-union include and exclude on one field: the
        span_not_program on the card."""
        inc = _union_terms(node.include, ctx)
        exc = _union_terms(node.exclude, ctx)
        if inc is None or exc is None or inc[0] != exc[0]:
            return None
        field, inc_terms = inc
        _, exc_terms = exc
        inv = ctx.inv(field)
        if inv is None or inv.positions is None:
            return None
        inputs = build_union_anchor_inputs(inv, inc_terms, exc_terms, ctx.D)
        if inputs is None:
            return None, torch.zeros(ctx.D, dtype=torch.bool,
                                     device=ctx.device)
        freq = span_not_program(*inputs, int(node.pre), int(node.post),
                                D=ctx.D)
        return self._score_leaves(ctx, freq > 0)


def _union_terms(node: SpanNode, ctx) -> Optional[Tuple[str, List[str]]]:
    """(field, terms) when ``node`` is a term / or-of-terms / multi-term
    expansion on one field, the shapes whose span set is exactly the
    term-position union; None for anything deeper."""
    if isinstance(node, SpanTermNode):
        return node.field, [node.term]
    if isinstance(node, SpanMultiNode):
        return node.field, list(node._exp(ctx))
    if isinstance(node, SpanOrNode):
        field: Optional[str] = None
        terms: List[str] = []
        for c in node.clauses:
            got = _union_terms(c, ctx)
            if got is None:
                return None
            f, ts = got
            if field is None:
                field = f
            elif f != field:
                return None
            terms.extend(ts)
        return field, list(dict.fromkeys(terms))
    return None


def _first_position_mask(ctx, field: str, terms: List[str], end: int):
    """bool[D] on the card: docs whose earliest occurrence of any term ends
    at or before ``end`` (span_first). Each posting's first position is
    gathered from the positional CSR on the card (positions sort within a
    posting, so it is the least), and one fill marks the docs. None when
    positional data is missing (the host walk serves it)."""
    inv = ctx.inv(field)
    if inv is None or inv.positions is None or inv.doc_ids_host is None:
        return None
    dev = positional_device(inv)
    if dev is None:
        return None
    positions, pos_offsets, _dpp = dev
    slices = [sl for sl in (inv.term_slice(t) for t in terms) if sl[1]]
    hit = torch.zeros(ctx.D + 1, dtype=torch.bool, device=ctx.device)
    if slices:
        entries = torch.cat([torch.arange(s, s + ln, device=ctx.device)
                             for s, ln in slices])
        firsts = positions.index_select(
            0, pos_offsets.index_select(0, entries).to(torch.int64))
        docs = inv.doc_ids.index_select(0, entries).to(torch.int64)
        # (x, x + 1) fits iff x + 1 <= end; the rest fill the dump slot D
        hit.index_fill_(0, torch.where(firsts < end, docs, ctx.D), True)
    return hit[: ctx.D]


def _walk_multis(node: SpanNode):
    if isinstance(node, SpanMultiNode):
        yield node
    for c in getattr(node, "clauses", None) or []:
        yield from _walk_multis(c)
    for attr in ("include", "match", "inner"):
        c = getattr(node, attr, None)
        if isinstance(c, SpanNode):
            yield from _walk_multis(c)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def parse_span_node(body: dict) -> SpanNode:
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingException("span clause must be a single-key object")
    qtype, spec = next(iter(body.items()))

    if qtype == "span_term":
        field, v = next(iter(spec.items()))
        if isinstance(v, dict):
            v = v.get("value", v.get("term"))
            if v is None:
                raise QueryParsingException(
                    f"span_term on [{field}] requires a [value]")
        return SpanTermNode(field, str(v))

    if qtype == "span_near":
        return SpanNearNode(
            [parse_span_node(c) for c in spec.get("clauses", [])],
            slop=int(spec.get("slop", 0)),
            in_order=bool(spec.get("in_order", True)),
        )

    if qtype == "span_or":
        return SpanOrNode([parse_span_node(c)
                           for c in spec.get("clauses", [])])

    if qtype == "span_not":
        return SpanNotNode(
            parse_span_node(spec["include"]),
            parse_span_node(spec["exclude"]),
            pre=int(spec.get("pre", spec.get("dist", 0))),
            post=int(spec.get("post", spec.get("dist", 0))),
        )

    if qtype == "span_first":
        return SpanFirstNode(parse_span_node(spec["match"]),
                             end=int(spec.get("end", 1)))

    if qtype == "field_masking_span":
        return FieldMaskingSpanNode(parse_span_node(spec["query"]),
                                    field=spec["field"])

    if qtype == "span_multi":
        return _parse_span_multi(spec)

    raise QueryParsingException(f"unknown span query type [{qtype}]")


def _expand_multi(ctx, field: str, mtype: str, value: str, fuzziness,
                  max_expansions: int = 50) -> List[str]:
    """Expand a multi-term leaf against the segment's term dictionary,
    the standalone wildcard/regexp/fuzzy queries' capped scan."""
    inv = ctx.inv(field)
    if inv is None:
        return []
    if mtype == "prefix":
        return _expand_prefix(inv, value, max_expansions)
    if mtype == "wildcard":
        # the literal prefix ends at the first metacharacter, character
        # classes included, as in the standalone WildcardQuery
        i = min((value.find(c) for c in "*?[]" if c in value),
                default=len(value))
        cands = _expand_prefix(inv, value[:i], 1 << 30) if i else inv.terms
        rx = re.compile(fnmatch.translate(value))
        return [t for t in cands if rx.match(t)][:max_expansions]
    if mtype == "regexp":
        try:
            rx = re.compile(value)
        except re.error as e:
            raise QueryParsingException(f"invalid regexp [{value}]: {e}")
        return [t for t in inv.terms if rx.fullmatch(t)][:max_expansions]
    if mtype == "fuzzy":
        k = fuzziness
        if k in (None, "AUTO", "auto"):
            k = 0 if len(value) < 3 else (1 if len(value) < 6 else 2)
        k = int(k)
        return [c for c in inv.terms
                if _edit_distance_le(value, c, k)][:max_expansions]
    raise QueryParsingException(f"span_multi does not support [{mtype}]")


def _parse_span_multi(spec: dict) -> SpanMultiNode:
    match = spec.get("match")
    if not isinstance(match, dict) or len(match) != 1:
        raise QueryParsingException(
            "span_multi requires a [match] multi-term query")
    mtype, mspec = next(iter(match.items()))
    field, v = next(iter(mspec.items()))
    fz = None
    if isinstance(v, dict):
        fz = v.get("fuzziness")
        value = v.get("value", v.get(mtype, v.get("prefix")))
        if value is None:
            raise QueryParsingException(
                f"span_multi [{mtype}] on [{field}] requires a [value]")
    else:
        value = v
    value = str(value)

    def expand(ctx, f=field, m=mtype, p=value, z=fz):
        return _expand_multi(ctx, f, m, p, z)

    return SpanMultiNode(field, expand)


def parse_span_query(qtype: str, spec: dict, boost: float = 1.0):
    node = parse_span_node({qtype: spec})
    return SpanQueryWrapper(node, boost=float(spec.get("boost", boost))
                            if isinstance(spec, dict) else boost)
