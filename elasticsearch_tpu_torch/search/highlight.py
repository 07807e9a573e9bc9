"""Plain highlighter.

Copy of elasticsearch_tpu/search/highlight.py (reference:
org/elasticsearch/search/highlight/PlainHighlighter.java): re-analyzes
the source text, wraps the words whose analyzed form is a query term in
tags, and cuts fragments around them. ``extract_query_terms`` walks the
query tree as the reference's does: a phrase gives its analyzed terms, a
prefix its first 64 completions, a fuzzy query its expansions (a
wildcard, as in the reference, none), a multi_match its text on each of
its fields.
"""
from __future__ import annotations

import re
from typing import List, Set

from elasticsearch_tpu_torch.search import queries as Q


def extract_query_terms(query, field: str, ctx) -> Set[str]:
    """Walk a Query tree collecting analyzed terms targeting `field`."""
    terms: Set[str] = set()

    def walk(q):
        if isinstance(q, Q.MatchQuery) and q.field == field:
            terms.update(q._analyze(ctx))
        elif isinstance(q, (Q.MatchPhraseQuery, Q.MatchPhrasePrefixQuery)) \
                and q.field == field:
            an = ctx.search_analyzer(field)
            if an:
                terms.update(t for t, _ in an.analyze(str(q.text)))
        elif isinstance(q, Q.TermQuery) and q.field == field:
            terms.add(str(q.value))
        elif isinstance(q, Q.TermsQuery) and q.field == field:
            terms.update(str(v) for v in q.values)
        elif isinstance(q, (Q.PrefixQuery, Q.WildcardQuery, Q.FuzzyQuery)) \
                and q.field == field:
            inv = ctx.inv(field)
            if inv is not None:
                if isinstance(q, Q.PrefixQuery):
                    terms.update(Q._expand_prefix(inv, str(q.value), 64))
                elif isinstance(q, Q.FuzzyQuery):  # every expansion
                    terms.update(Q.fuzzy_terms(inv, str(q.value),
                                               q.fuzziness, len(inv.terms)))
        elif isinstance(q, Q.MultiMatchQuery):
            for f in q.fields:
                base = f.partition("^")[0]
                if base == field:
                    terms.update(Q.MatchQuery(base, q.text)._analyze(ctx))
        elif isinstance(q, Q.BoolQuery):
            for sub in q.must + q.should + q.filter:
                walk(sub)
        elif isinstance(q, Q.DisMaxQuery):
            for sub in q.queries:
                walk(sub)
        elif hasattr(q, "inner"):
            walk(q.inner)

    walk(query)
    return terms


def highlight_field(
    text: str,
    terms: Set[str],
    analyzer,
    pre_tag: str = "<em>",
    post_tag: str = "</em>",
    fragment_size: int = 100,
    number_of_fragments: int = 5,
) -> List[str]:
    """Return highlighted fragments of `text` for analyzed `terms`."""
    if not text or not terms:
        return []
    # find char spans whose analyzed form is in terms
    spans = []
    for m in re.finditer(r"\w+(?:[.']\w+)*", text):
        word = m.group(0)
        toks = analyzer.analyze(word) if analyzer else [(word.lower(), 0)]
        if any(t in terms for t, _ in toks):
            spans.append((m.start(), m.end()))
    if not spans:
        return []
    if number_of_fragments == 0:
        # whole-field highlighting
        out, prev = [], 0
        for s, e in spans:
            out.append(text[prev:s])
            out.append(pre_tag + text[s:e] + post_tag)
            prev = e
        out.append(text[prev:])
        return ["".join(out)]
    # greedy fragmenting around matches
    frags: List[str] = []
    used_until = -1
    for s, e in spans:
        if s < used_until:
            continue
        fs = max(0, s - fragment_size // 2)
        fe = min(len(text), fs + fragment_size)
        used_until = fe
        frag = text[fs:fe]
        # highlight all spans inside the fragment
        offset = fs
        inner = [(a - offset, b - offset) for a, b in spans
                 if a >= fs and b <= fe]
        out, prev = [], 0
        for a, b in inner:
            out.append(frag[prev:a])
            out.append(pre_tag + frag[a:b] + post_tag)
            prev = b
        out.append(frag[prev:])
        frags.append("".join(out))
        if len(frags) >= number_of_fragments:
            break
    return frags
