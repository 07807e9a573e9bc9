"""The search APIs over HTTP: the port's server against the reference's,
the same requests to both (``tests/_torch_rest.py``).

Bodies: match, term and bool, aggregations, sort, highlight, scroll,
``_count``, ``_msearch`` NDJSON, brute-force and IVF-PQ ``knn`` and a
``hybrid`` body with a PQ MaxSim re-rank (so the CPU twins of B2, B3 and
B4 run behind HTTP), suggest, percolate, explain, validate, search
templates, field stats, search shards, search exists and more-like-this.

Bars: every key of the answer equal but for the masked ones; scores at
the bar of the path's parity test (``SCORE_RTOL``: the generic bar of
``tests/test_torch_slice.py`` for most bodies, its fused bar for bodies
B1 serves, where the ids are held at recall >= 0.95 as there). Each
search body's HTTP answer from the port is also held byte for byte
against the port's own ``Node.search`` answer (``same_as_in_process``).
The IVF-PQ index carries the reference's frozen segments across with
``segment_from_arrays``, as ``tests/test_torch_slice.py`` does.
"""
import copy
import json

import numpy as np
import pytest

from _torch_parity import MAPPING, clustered, corpus, reference_arrays
from _torch_rest import (SCORE_RTOL, Pair, http, http_raw, ids, ndjson,
                         same, same_as_in_process)

SETTINGS = {"index": {"number_of_shards": 2, "search": {"mesh": "false"}}}
N_DOCS = 900
DIMS = 8
N_VECS = 320


def _vec_mapping(opts=None):
    emb = {"type": "dense_vector", "dims": DIMS}
    if opts:
        emb["index_options"] = opts
    return {"properties": {"emb": emb, "body": {"type": "text"},
                           "tag": {"type": "keyword"}}}


def _vec_docs():
    x = clustered(N_VECS, DIMS, 8, seed=5)
    rng = np.random.RandomState(42)
    out = []
    for i in range(N_VECS):
        words = ["alpha"] if rng.rand() < 0.85 else []
        if rng.rand() < 0.55:
            words.append("beta")
        out.append((str(i), {"emb": [float(a) for a in x[i]],
                             "body": " ".join(words or ["gamma"]),
                             "tag": f"t{i % 5}"}))
    return x, out


@pytest.fixture(scope="module")
def pair():
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    p = Pair()
    p.wipe()
    p.same("PUT", "/docs", {"settings": SETTINGS, "mappings": MAPPING})
    lines = []
    for doc_id, src in corpus(N_DOCS, seed=4):
        lines += [{"index": {"_index": "docs", "_id": doc_id}}, src]
    p.same("POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    x, vdocs = _vec_docs()
    p.x = x
    vlines = []
    for doc_id, src in vdocs:
        vlines += [{"index": {"_id": doc_id}}, src]
    p.same("PUT", "/vb", {"settings": SETTINGS,
                          "mappings": _vec_mapping()})
    p.same("POST", "/vb/_bulk?refresh=true", ndjson=ndjson(vlines))
    # IVF-PQ: the reference writes and freezes, the port takes its frozen
    # segments (quantizer and codes included)
    body = {"settings": {"index": {"number_of_shards": 1,
                                   "search": {"mesh": "false"}}},
            "mappings": _vec_mapping({"type": "ivf_pq"})}
    p.same("PUT", "/vq", body)
    http(p.ref_server.port, "POST", "/vq/_bulk?refresh=true",
         ndjson=ndjson(vlines))
    for seg in p.ref.indices["vq"].shards[0].engine.segments:
        assert seg.vectors["emb"]._ivf and seg.vectors["emb"]._pq
        p.port.get_index("vq").shards[0].engine.add_segment(
            segment_from_arrays(reference_arrays(seg), p.port.residency))
    yield p
    p.close()


def _q(x, i, noise=0.05):
    rng = np.random.default_rng(i)
    return [float(a) for a in x[i] + noise * rng.standard_normal(DIMS)]


GENERIC = {
    "match_and": {"query": {"match": {"body": {"query": "quick fox river",
                                               "operator": "and"}}}},
    "match_tail": {"query": {"match": {"body": "zulu yankee island"}},
                   "size": 5},
    "term_keyword": {"query": {"term": {"tag": "t3"}}, "size": 20},
    "bool": {"query": {"bool": {
        "must": [{"match": {"body": "brown dog"}}],
        "should": [{"match": {"body": "river"}}, {"term": {"tag": "t2"}}],
        "must_not": [{"term": {"tag": "t4"}}],
        "filter": [{"range": {"price": {"gte": 10, "lt": 80}}}]}},
        "size": 15},
    "range": {"query": {"range": {"n": {"gt": 100_000_300,
                                        "lte": 700_002_100}}}},
    "match_all_paged": {"query": {"match_all": {}}, "from": 30, "size": 25},
    "aggs": {"size": 0, "aggs": {
        "tags": {"terms": {"field": "tag"},
                 "aggs": {"p": {"max": {"field": "price"}}}},
        "n_hist": {"histogram": {"field": "price", "interval": 20}},
        "stats": {"stats": {"field": "price"}},
        "missing_n": {"missing": {"field": "n"}}}},
    "sort": {"query": {"match": {"body": "ocean desert"}},
             "sort": [{"tag": "desc"}, "_score"], "size": 20},
    "highlight": {"query": {"match": {"body": "zulu mountain"}},
                  "highlight": {"fields": {"body": {}}}, "size": 5},
    "source_filter": {"query": {"term": {"tag": "t1"}}, "size": 5,
                      "_source": ["tag", "n"]},
    "query_string": {"query": {"query_string": {
        "query": "body:(xray OR juliet) AND tag:t2"}}},
}

FUSED = {
    "match_or": {"query": {"match": {"body": "quick brown fox"}}},
    "term_text": {"query": {"term": {"body": "fox"}}, "size": 20},
}


def _recall(r, p) -> float:
    want = ids(r)
    return len(set(want) & set(ids(p))) / max(1, len(want))


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_body(pair, name):
    body = GENERIC[name]
    pair.same("POST", "/docs/_search", body)
    status, raw, _ = http_raw(pair.port_server.port, "POST",
                              "/docs/_search", body)
    assert status == 200
    same_as_in_process(pair, raw, "docs", body)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_body(pair, name):
    """B1's twin behind HTTP: the fused path's bar
    (``tests/test_torch_slice.py``)."""
    from elasticsearch_tpu_torch.monitor import kernels

    body = FUSED[name]
    before = kernels.snapshot().get("bm25_fused_topk", 0)
    (rs, r), (ps, p) = pair.both("POST", "/docs/_search", body)
    assert rs == ps == 200
    assert kernels.snapshot().get("bm25_fused_topk", 0) > before
    assert p["hits"]["total"] == r["hits"]["total"]
    assert p["_shards"] == r["_shards"]
    assert _recall(r, p) >= 0.95
    rs_, ps_ = ({h["_id"]: h["_score"] for h in x["hits"]["hits"]}
                for x in (r, p))
    for k in set(rs_) & set(ps_):
        assert ps_[k] == pytest.approx(rs_[k], rel=SCORE_RTOL["fused"])
    status, raw, _ = http_raw(pair.port_server.port, "POST",
                              "/docs/_search", body)
    same_as_in_process(pair, raw, "docs", body)


def test_uri_search_and_count(pair):
    s = pair.same
    s("GET", "/docs/_search?q=tag:t5&size=7")
    s("GET", "/_search?q=tag:t6&size=3")
    s("POST", "/docs/_count", {"query": {"term": {"tag": "t2"}}})
    s("GET", "/_count?q=tag:t1")
    s("GET", "/docs/_count")
    s("POST", "/docs/doc/_count", {"query": {"term": {"tag": "t2"}}})
    s("POST", "/docs/_search", {"query": {"nope": {}}})
    # a kept refusal (ROADMAP A, A6c's remainder): the reference drops
    # `explain` silently, the port names the item it waits for
    (rs, rb), (ps, pb) = pair.both("POST", "/docs/_search", {
        "query": {"match_all": {}}, "explain": True})
    assert rs == 200 and "_explanation" not in rb["hits"]["hits"][0]
    assert ps == 400 and pb["error"]["type"] == "search_parse_exception"
    assert "ROADMAP A6c" in pb["error"]["reason"]
    s("POST", "/nope/_search", {})
    s("GET", "/docs/_search/exists?q=tag:t3")
    s("GET", "/docs/_search/exists?q=tag:none")
    s("GET", "/docs/_search_shards")


def test_msearch(pair):
    pairs = [({"index": "docs"}, GENERIC["match_tail"]),
             ({"index": "docs"}, GENERIC["term_keyword"]),
             ({"index": "docs"}, {"query": {"match": {"body": "papa"}},
                                  "size": 3}),
             ({"index": "nope"}, {"query": {"match_all": {}}}),
             ({}, {"query": {"term": {"tag": "t0"}}, "size": 2})]
    lines = [x for hb in pairs for x in hb]
    pair.same("POST", "/_msearch", ndjson=ndjson(lines))
    pair.same("POST", "/docs/_msearch", ndjson=ndjson(lines[:6]))
    status, raw, _ = http_raw(pair.port_server.port, "POST", "/_msearch",
                              ndjson=ndjson(lines[:6]))
    assert status == 200
    same_as_in_process(pair, raw, None, pairs[:3], msearch=True)


def test_scroll(pair):
    body = {"query": {"match": {"body": "apple banana cherry"}},
            "size": 15}
    pages = {}
    for side, port in (("ref", pair.ref_server.port),
                       ("port", pair.port_server.port)):
        st, first = http(port, "POST", "/docs/_search?scroll=1m", body)
        assert st == 200
        got = [ids(first)]
        sid = first["_scroll_id"]
        while got[-1]:
            st, page = http(port, "POST", "/_search/scroll",
                            {"scroll": "1m", "scroll_id": sid})
            assert st == 200
            got.append(ids(page))
        st, cleared = http(port, "DELETE", "/_search/scroll",
                           {"scroll_id": [sid]})
        assert st == 200 and cleared["num_freed"] == 1
        pages[side] = (got, first["hits"]["total"],
                       http(port, "POST", "/_search/scroll",
                            {"scroll_id": sid}))
    assert pages["port"][0] == pages["ref"][0]
    assert pages["port"][1] == pages["ref"][1]
    (rs, rb), (ps, pb) = pages["ref"][2], pages["port"][2]
    assert ps == rs == 404
    assert pb["error"]["type"] == rb["error"]["type"]


def test_knn_brute_force(pair):
    """B2's twin behind HTTP."""
    x = pair.x
    for i, body in enumerate([
            {"query": {"knn": {"field": "emb", "query_vector": _q(x, 3)}}},
            {"query": {"knn": {"field": "emb", "query_vector": _q(x, 7),
                               "k": 20, "num_candidates": 50}},
             "size": 20},
            {"query": {"knn": {"field": "emb", "query_vector": _q(x, 9),
                               "filter": {"term": {"tag": "t2"}}}}}]):
        pair.same("POST", "/vb/_search", body, scores="knn")
        status, raw, _ = http_raw(pair.port_server.port, "POST",
                                  "/vb/_search", body)
        same_as_in_process(pair, raw, "vb", body)


def test_knn_ivf_pq_and_hybrid_pq_rerank(pair):
    """B3's twin (IVF-PQ) and B4's (the PQ MaxSim re-rank of a hybrid
    body) behind HTTP, on the reference's carried IVF-PQ segment."""
    x = pair.x
    rng = np.random.RandomState(15)
    tokens = np.round(rng.randn(4, DIMS), 6).tolist()
    bodies = [
        {"query": {"knn": {"field": "emb", "query_vector": _q(x, 11),
                           "num_candidates": 60}}},
        {"query": {"hybrid": {
            "query": {"match": {"body": "alpha beta"}},
            "knn": {"field": "emb", "query_vector": _q(x, 12), "k": 10,
                    "num_candidates": 50, "ann": False},
            "fusion": {"method": "rrf", "rank_constant": 60},
            "rerank": {"query_vectors": tokens, "window_size": 10,
                       "pq": True}}}, "size": 10},
    ]
    for body in bodies:
        pair.same("POST", "/vq/_search", body, scores="knn")
        status, raw, _ = http_raw(pair.port_server.port, "POST",
                                  "/vq/_search", body)
        same_as_in_process(pair, raw, "vq", body)


def test_suggest(pair):
    term = {"s1": {"text": "quikc brwn", "term": {"field": "body"}}}
    pair.same("POST", "/docs/_suggest", term)
    pair.same("POST", "/_suggest", term)
    pair.same("POST", "/docs/_search", {"size": 0, "suggest": term})
    pair.same("POST", "/docs/_suggest", {"s": {"text": "x",
                                               "term": {"nope": 1}}})


def test_percolate(pair):
    s = pair.same
    s("PUT", "/perc", {"mappings": {"properties": {
        "body": {"type": "text"}, "n": {"type": "long"}}}})
    s("PUT", "/perc/.percolator/q1", {"query": {"match": {"body": "fox"}}})
    s("PUT", "/perc/.percolator/q2", {"query": {"range": {"n": {"gte": 5}}}})
    s("PUT", "/perc/.percolator/q3?refresh=true",
      {"query": {"match": {"body": "dog"}}})
    doc = {"doc": {"body": "the quick fox", "n": 7}}
    s("POST", "/perc/doc/_percolate", doc)
    s("POST", "/perc/doc/_percolate/count", doc)
    s("PUT", "/perc/doc/d1?refresh=true", {"body": "lazy dog", "n": 1})
    s("GET", "/perc/doc/d1/_percolate")
    s("POST", "/_mpercolate", ndjson=ndjson([
        {"percolate": {"index": "perc", "type": "doc"}},
        {"doc": {"body": "fox and dog"}},
        {"percolate": {"index": "nope", "type": "doc"}},
        {"doc": {"body": "x"}}]))
    s("DELETE", "/perc")


def test_explain_and_validate(pair):
    s = pair.same
    q = {"query": {"match": {"body": "zulu"}}}
    hit = ids(pair.same("POST", "/docs/_search", q)[1])[0]
    s("POST", f"/docs/_explain/{hit}", q)
    s("GET", f"/docs/doc/{hit}/_explain", q)
    s("POST", "/docs/_explain/nope", q)
    s("POST", "/docs/_validate/query", q)
    s("POST", "/docs/_validate/query?explain=true", q)
    s("POST", "/docs/_validate/query?explain=true",
      {"query": {"bogus": {}}})
    s("GET", "/_validate/query?q=tag:t1")


def test_search_templates(pair):
    s = pair.same
    inline = {"inline": {"query": {"term": {"tag": "{{t}}"}},
                         "size": "{{n}}"},
              "params": {"t": "t4", "n": 6}}
    s("POST", "/docs/_search/template", inline)
    s("POST", "/_render/template", inline)
    s("PUT", "/_search/template/tpl1",
      {"template": {"query": {"match": {"body": "{{q}}"}}}})
    s("PUT", "/_search/template/tpl1",
      {"template": {"query": {"match": {"body": "{{q}}"}}}})
    s("GET", "/_search/template/tpl1")
    s("POST", "/docs/_search/template",
      {"id": "tpl1", "params": {"q": "lima mike"}})
    s("DELETE", "/_search/template/tpl1")
    s("GET", "/_search/template/tpl1")
    s("POST", "/docs/_search/template", {"id": "tpl1", "params": {}})


def test_field_stats_and_mlt(pair):
    s = pair.same
    s("GET", "/docs/_field_stats?fields=n,price,body,tag")
    s("GET", "/_field_stats?fields=n&level=indices")
    s("GET", "/docs/doc/d3/_mlt?mlt_fields=body&min_term_freq=1"
             "&min_doc_freq=1")


def test_http_answer_is_the_in_process_answer(pair):
    """The REST layer adds no arithmetic: each generic body's HTTP
    answer equals ``Node.search``'s, byte for byte but ``took``."""
    for body in GENERIC.values():
        status, raw, _ = http_raw(pair.port_server.port, "POST",
                                  "/docs/_search", body)
        assert status == 200
        same_as_in_process(pair, raw, "docs", body)
    got = json.loads(raw)
    same(got, pair.port.search("docs", copy.deepcopy(body)))


@pytest.mark.parametrize("consumed", [None, 0, 5])
def test_register_scroll_hits_pages_as_the_reference(consumed):
    """A materialized scroll (the reference's cross-host scroll registers
    one): the same pages, past its end too."""
    from elasticsearch_tpu.search import service as ref_service
    from elasticsearch_tpu_torch.search import service

    hits = [{"_id": str(i), "_score": None} for i in range(11)]
    body = {"size": 3, "query": {"match_all": {}}}
    sids = (ref_service.register_scroll_hits(body, hits, 11, consumed),
            service.register_scroll_hits(body, hits, 11, consumed))
    for _ in range(5):
        r, p = (mod.scroll_next(sid) for mod, sid in
                zip((ref_service, service), sids))
        assert p.pop("_scroll_id") == sids[1]
        r.pop("_scroll_id")
        assert p == r
    assert ref_service.clear_scroll(sids[0]) and service.clear_scroll(sids[1])
