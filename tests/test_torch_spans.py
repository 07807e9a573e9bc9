"""Span queries of the port (``search/spans.py``) against the reference's
``Node``, on the port's mesh route (which declines spans to the host
loop, as the reference's does) and its host loop.

Mirrors every case of ``tests/unit/test_spans.py`` with the hand-stated
answers kept: span_term, span_near in and out of order at several
slops, span_first, span_or, span_not, span_multi (prefix, wildcard,
fuzzy; expanded per segment), field_masking_span, positive scores, a
span inside a bool filter, the truncation counter, the three-clause
unordered counterexample, the repeated-term overlap quirk, and that the
common shapes run on the card, never as a walk per doc. Then the span
types on a seeded corpus of one and two shards of several segments,
``_name`` and highlighting (the reference's highlighter takes no terms
from a span tree, nor does the port's).

Bars: the same ids in the same order, ``hits.total`` exact, scores
within rtol 1e-5; the port's two routes byte-identical.
"""
import copy
import json
import os

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import spans as S
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

from _torch_parity import corpus

WS = {"type": "text", "analyzer": "whitespace"}
UNIT_MAPPING = {"properties": {"body": WS, "alt": WS}}
BODY_MAPPING = {"properties": {"body": WS}}
UNIT_DOCS = [
    "the quick brown fox",             # 0: quick@1 brown@2 fox@3
    "quick red fox",                   # 1: quick@0 fox@2
    "fox quick",                       # 2: reversed order
    "quick a b c d e fox",             # 3: far apart (gap 5)
    "the lazy dog",                    # 4: no match
    "quick brown quick fox",           # 5: multiple occurrences
]
CORPUS_MAPPING = {"properties": {"body": WS, "tag": {"type": "keyword"}}}
# (shards, first doc, end doc) of the corpus indices; a refresh every 60
CORPUS = {"c1": (1, 0, 240), "c2": (2, 240, 480)}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _load(node, name, docs, mapping, shards=1, every=None):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})
    svc = node.indices[name]
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if every and (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


def _unord3_doc():
    toks = [f"x{i}" for i in range(18)]
    toks[7], toks[10], toks[14], toks[15] = "b", "a", "b", "c"
    return " ".join(toks)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for node in (ref, port):
            _load(node, "spans", [(str(i), {"body": t, "alt": "fox sleeps"})
                                  for i, t in enumerate(UNIT_DOCS)],
                  UNIT_MAPPING)
            # two segments: a term only in the second one
            _load(node, "seg2", [("0", {"body": "alpha beta"}),
                                 ("1", {"body": "dog gamma"})],
                  BODY_MAPPING, every=1)
            _load(node, "trunc", [("1", {"body": " ".join(
                ["a"] * (S.MAX_SPANS_PER_CLAUSE + 10) + ["b"])})],
                BODY_MAPPING)
            _load(node, "unord3", [("0", {"body": _unord3_doc()})],
                  BODY_MAPPING)
            _load(node, "rep", [("0", {"body": "z z a z z"}),
                                ("1", {"body": "a w a"}),
                                ("2", {"body": "w w w"})], BODY_MAPPING)
            for name, (shards, lo, hi) in CORPUS.items():
                _load(node, name, corpus(480, seed=13)[lo:hi],
                      CORPUS_MAPPING, shards=shards, every=60)
    yield ref, port
    ref.close()
    port.close()


def _search(node, index, body, host):
    if host:
        os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        return node.search(index, copy.deepcopy(body))
    finally:
        if host:
            del os.environ["ESTPU_DISABLE_MESH"]


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def _check(nodes, index, query, size=20, extra=None):
    """The port's routes against the reference (ids, order, total,
    scores) and each other; returns the sorted hit ids."""
    ref, port = nodes
    body = dict({"query": query, "size": size}, **(extra or {}))
    want = ref.search(index, copy.deepcopy(body))
    kernels.reset()
    mesh = _search(port, index, body, False)
    snap = kernels.snapshot()
    host = _search(port, index, body, True)
    assert snap.get("mesh_fallback_total") == 1, snap  # declined
    assert _strip(mesh) == _strip(host)
    gh, wh = host["hits"]["hits"], want["hits"]["hits"]
    assert host["hits"]["total"] == want["hits"]["total"], query
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh], query
    np.testing.assert_allclose([h["_score"] for h in gh],
                               [h["_score"] for h in wh], rtol=1e-5,
                               err_msg=str(query))
    for g, w in zip(gh, wh):
        assert g.get("matched_queries") == w.get("matched_queries")
        assert g.get("highlight") == w.get("highlight")
    return sorted(h["_id"] for h in gh)


def _near(a, b, slop, in_order, field="body"):
    return {"span_near": {"clauses": [{"span_term": {field: a}},
                                      {"span_term": {field: b}}],
                          "slop": slop, "in_order": in_order}}


# -- tests/unit/test_spans.py, case by case ------------------------------------

def test_span_term(nodes):
    assert _check(nodes, "spans", {"span_term": {"body": "quick"}}) == \
        ["0", "1", "2", "3", "5"]
    assert _check(nodes, "spans",
                  {"span_term": {"body": {"value": "dog"}}}) == ["4"]


def test_span_near_in_order_slop0(nodes):
    assert _check(nodes, "spans", _near("quick", "fox", 0, True)) == ["5"]


def test_span_near_slop(nodes):
    assert _check(nodes, "spans", _near("quick", "fox", 1, True)) == \
        ["0", "1", "5"]
    assert _check(nodes, "spans", _near("quick", "fox", 5, True)) == \
        ["0", "1", "3", "5"]


def test_span_near_unordered(nodes):
    assert _check(nodes, "spans", _near("quick", "fox", 0, False)) == \
        ["2", "5"]


def test_span_first(nodes):
    q = {"span_first": {"match": {"span_term": {"body": "fox"}}, "end": 3}}
    assert _check(nodes, "spans", q) == ["1", "2"]


def test_span_or(nodes):
    q = {"span_or": {"clauses": [{"span_term": {"body": "dog"}},
                                 {"span_term": {"body": "red"}}]}}
    assert _check(nodes, "spans", q) == ["1", "4"]


def test_span_not(nodes):
    q = {"span_not": {"include": {"span_term": {"body": "quick"}},
                      "exclude": {"span_term": {"body": "brown"}},
                      "post": 1}}
    got = _check(nodes, "spans", q)
    assert {"1", "2", "3", "5"} <= set(got) and "0" not in got


def test_span_multi_prefix(nodes):
    q = {"span_near": {"clauses": [
        {"span_multi": {"match": {"prefix": {"body": "qui"}}}},
        {"span_term": {"body": "fox"}}], "slop": 1, "in_order": True}}
    assert _check(nodes, "spans", q) == ["0", "1", "5"]


def test_span_multi_wildcard_and_fuzzy(nodes):
    assert _check(nodes, "spans", {"span_multi": {"match": {
        "wildcard": {"body": "d*g"}}}}) == ["4"]
    assert _check(nodes, "spans", {"span_multi": {"match": {
        "fuzzy": {"body": {"value": "quickk", "fuzziness": 1}}}}}) == \
        ["0", "1", "2", "3", "5"]


def test_field_masking_span(nodes):
    q = {"span_near": {"clauses": [
        {"field_masking_span": {"query": {"span_term": {"alt": "fox"}},
                                "field": "body"}},
        {"span_term": {"body": "quick"}}], "slop": 0, "in_order": True}}
    assert _check(nodes, "spans", q) == ["0", "2"]


def test_span_scores_positive_and_deterministic(nodes):
    _ref, port = nodes
    body = {"query": {"span_term": {"body": "fox"}}}
    a = port.search("spans", copy.deepcopy(body))
    scores = [h["_score"] for h in a["hits"]["hits"]]
    assert scores and all(s > 0 for s in scores)
    assert scores == [h["_score"] for h in port.search(
        "spans", copy.deepcopy(body))["hits"]["hits"]]
    _check(nodes, "spans", body["query"])


def test_span_multi_expands_per_segment(nodes):
    assert _check(nodes, "seg2", {"span_multi": {"match": {
        "prefix": {"body": "do"}}}}) == ["1"]
    assert _check(nodes, "seg2", {"span_multi": {"match": {
        "wildcard": {"body": "d[ou]g"}}}}) == ["1"]


def test_span_term_missing_value_raises():
    from elasticsearch_tpu.search.queries import parse_query as ref_parse
    from elasticsearch_tpu.utils.errors import \
        QueryParsingException as RefQPE
    from elasticsearch_tpu_torch.search.queries import parse_query

    body = {"span_term": {"body": {"boost": 2.0}}}
    with pytest.raises(RefQPE) as r:
        ref_parse(body)
    with pytest.raises(QueryParsingException) as p:
        parse_query(body)
    assert str(p.value) == str(r.value)


def test_span_in_bool_filter_context(nodes):
    q = {"bool": {"filter": [_near("quick", "fox", 0, True)]}}
    assert _check(nodes, "spans", q) == ["5"]


def test_common_shapes_avoid_per_doc_host_walk(nodes, monkeypatch):
    """The common span shapes run on the card: the per-doc interval walk
    (``.spans``) never runs for them, and each records ``span_device``."""
    def boom(self, ctx, doc):
        raise AssertionError("per-doc host walk on a device-eligible shape")

    for cls in (S.SpanTermNode, S.SpanOrNode, S.SpanNearNode,
                S.SpanFirstNode, S.SpanNotNode, S.SpanMultiNode):
        monkeypatch.setattr(cls, "spans", boom)
    _ref, port = nodes
    queries = [
        {"span_term": {"body": "quick"}},
        {"span_or": {"clauses": [{"span_term": {"body": "dog"}},
                                 {"span_term": {"body": "red"}}]}},
        _near("quick", "fox", 1, True), _near("quick", "fox", 0, False),
        {"span_first": {"match": {"span_term": {"body": "fox"}}, "end": 3}},
        {"span_not": {"include": {"span_term": {"body": "quick"}},
                      "exclude": {"span_term": {"body": "brown"}},
                      "post": 1}},
        {"span_first": {"match": {"span_or": {"clauses": [
            {"span_term": {"body": "fox"}}, {"span_term": {"body": "dog"}}]}},
            "end": 3}},
    ]
    for q in queries:
        for host in (False, True):
            kernels.reset()
            assert _search(port, "spans", {"query": q}, host)["hits"]["hits"]
            snap = kernels.snapshot()
            assert snap.get("span_device") and not snap.get(
                "span_host_walk"), (q, snap)


def test_span_truncation_is_surfaced(nodes):
    _ref, port = nodes
    q = {"span_near": {"clauses": [
        {"span_near": {"clauses": [{"span_term": {"body": "a"}},
                                   {"span_term": {"body": "a"}}],
                       "slop": 10, "in_order": False}},
        {"span_term": {"body": "b"}}], "slop": 200, "in_order": False}}
    for host in (False, True):
        kernels.reset()
        _search(port, "trunc", {"query": q, "size": 5}, host)
        snap = kernels.snapshot()
        assert snap.get("span_clause_truncated", 0) >= 1, snap
        assert snap.get("span_host_walk") == 1, snap
    _check(nodes, "trunc", q)


def test_span_near_unordered_three_clauses_explores_alternatives(nodes):
    """b@7, a@10, b@14, c@15: the b nearest the anchor gives a window of
    matchSlop 6 > 5; b@14 gives 3. The host walk finds it."""
    q = {"span_near": {"clauses": [
        {"span_term": {"body": "a"}}, {"span_term": {"body": "b"}},
        {"span_term": {"body": "c"}}], "slop": 5, "in_order": False}}
    kernels.reset()
    assert _check(nodes, "unord3", q) == ["0"]
    assert kernels.snapshot().get("span_host_walk")
    q["span_near"]["slop"] = 2
    assert _check(nodes, "unord3", q) == []


def test_span_near_unordered_repeated_term_overlap_quirk(nodes):
    assert _check(nodes, "rep", _near("a", "a", 1, False)) == ["0", "1"]
    assert _check(nodes, "rep", _near("a", "a", 2, True)) == ["1"]


# -- the span types on a seeded corpus -----------------------------------------

CORPUS_QUERIES = {
    "term": {"span_term": {"body": "fox"}},
    "term_boost": {"span_term": {"body": {"value": "river", "boost": 2.5}}},
    "near_ordered": _near("quick", "brown", 1, True),
    "near_ordered3": {"span_near": {"clauses": [
        {"span_term": {"body": "the"}}, {"span_term": {"body": "quick"}},
        {"span_term": {"body": "fox"}}], "slop": 4, "in_order": True}},
    "near_unordered": _near("fox", "the", 3, False),
    "near_unordered3": {"span_near": {"clauses": [
        {"span_term": {"body": "the"}}, {"span_term": {"body": "quick"}},
        {"span_term": {"body": "brown"}}], "slop": 3, "in_order": False}},
    "near_absent": _near("fox", "zzzz", 2, True),
    "first": {"span_first": {"match": {"span_term": {"body": "the"}},
                             "end": 2}},
    "first_or": {"span_first": {"match": {"span_or": {"clauses": [
        {"span_term": {"body": "fox"}}, {"span_term": {"body": "dog"}}]}},
        "end": 4}},
    "or3": {"span_or": {"clauses": [{"span_term": {"body": w}}
                                    for w in ("river", "ocean", "lake")]}},
    "not": {"span_not": {"include": {"span_term": {"body": "quick"}},
                         "exclude": {"span_term": {"body": "the"}},
                         "pre": 1, "post": 2}},
    "not_dist": {"span_not": {"include": {"span_or": {"clauses": [
        {"span_term": {"body": "fox"}}, {"span_term": {"body": "dog"}}]}},
        "exclude": {"span_term": {"body": "brown"}}, "dist": 1}},
    "multi_prefix": {"span_multi": {"match": {"prefix": {"body": "r"}}}},
    "multi_regexp": {"span_multi": {"match": {"regexp": {"body": "qu.*"}}}},
    "near_of_near": {"span_near": {"clauses": [
        _near("the", "quick", 2, True), {"span_term": {"body": "fox"}}],
        "slop": 3, "in_order": True}},
    "first_of_near": {"span_first": {"match": _near("the", "quick", 1,
                                                    True), "end": 5}},
    "not_of_near": {"span_not": {"include": _near("quick", "fox", 2, True),
                                 "exclude": {"span_term": {"body": "dog"}}}},
    "in_bool": {"bool": {"must": [{"match": {"body": "river"}}],
                         "should": [_near("the", "river", 2, False)],
                         "filter": [{"term": {"tag": "t1"}}]}},
    "named": {"span_near": {"clauses": [{"span_term": {"body": "quick"}},
                                        {"span_term": {"body": "fox"}}],
                            "slop": 2, "in_order": False, "_name": "sn"}},
}


@pytest.mark.parametrize("index", sorted(CORPUS))
@pytest.mark.parametrize("name", sorted(CORPUS_QUERIES))
def test_corpus_span_queries(nodes, name, index):
    _check(nodes, index, CORPUS_QUERIES[name], size=25)


def test_highlight_takes_no_span_terms(nodes):
    """The reference's highlighter walks ``inner`` and no span tree, so
    a span query highlights nothing; the port answers the same."""
    body = {"highlight": {"fields": {"body": {}}}}
    _check(nodes, "c1", CORPUS_QUERIES["near_ordered"], extra=body)
    ref, port = nodes
    got = port.search("c1", {"query": CORPUS_QUERIES["near_ordered"],
                             **body})
    assert got["hits"]["hits"] and \
        not any(h.get("highlight") for h in got["hits"]["hits"])


def test_malformed_span_bodies_raise(nodes):
    _ref, port = nodes
    for q in ({"span_near": {"clauses": []}}, {"span_or": {"clauses": []}},
              {"span_multi": {"match": {"range": {"body": {"gt": 1}}}}},
              {"span_multi": {"match": {}}}, {"span_first": {"match": 3}}):
        with pytest.raises(QueryParsingException):
            port.search("spans", {"query": q})
