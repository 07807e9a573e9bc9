"""The ``hybrid`` query and ``rescore`` of the PyTorch port end to end:
the seeded corpora of the reference's own hybrid tests indexed into a
JAX-package Node (host search loop, ``search.mesh: false``) and a port
Node on the CPU, then the same ``_search`` bodies through both.

The port writes the brute-force indices itself. The ``ivf_pq`` index
carries the reference's frozen segment across with
``segment_from_arrays``, IVF quantizer and PQ codes included, so the
IVF-PQ knn side and the PQ re-rank do not hang on two k-means runs
agreeing.

Bar: the same ids in the same order, ``hits.total`` exact, scores at
rtol 1e-5 (f32 sums in other orders), RRF scores at rtol 1e-6 (a rank is
exact; only the lexical and vector scores it orders carry rounding), the
``hybrid`` section equal.
"""
import copy

import numpy as np
import pytest

from elasticsearch_tpu import resources as ref_resources
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import ivf as port_ivf
from elasticsearch_tpu_torch.search import hybrid as port_hybrid
from elasticsearch_tpu_torch.search import queries as port_queries
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

DIMS = 8


def _settings(shards=1):
    return {"number_of_shards": shards, "search": {"mesh": "false"}}


def _mapping(opts=None):
    emb = {"type": "dense_vector", "dims": DIMS}
    if opts:
        emb["index_options"] = opts
    return {"properties": {"emb": emb, "body": {"type": "text"}}}


def _dense_docs():
    """tests/unit/test_hybrid.py::dense_corpus: 320 docs, "alpha" in most
    (a dense impact row), "beta" in about half."""
    rng = np.random.RandomState(42)
    V = rng.randn(320, DIMS).astype(np.float32)
    docs = []
    for i in range(320):
        words = []
        if rng.rand() < 0.85:
            words.append("alpha")
        if rng.rand() < 0.55:
            words.append("beta")
        docs.append((str(i), {"emb": [float(x) for x in V[i]],
                              "body": " ".join(words or ["gamma"])}))
    return docs


def _sparse_docs():
    """tests/unit/test_hybrid.py::sparse_corpus: 120 docs of rare terms
    (no dense impact rows: the scatter form of the lexical side)."""
    rng = np.random.RandomState(7)
    V = rng.randn(120, DIMS).astype(np.float32)
    words = ["quick", "brown", "fox", "lazy", "dog"]
    return [(str(i), {"emb": [float(x) for x in V[i]],
                      "body": " ".join(rng.choice(words,
                                                  size=rng.randint(1, 4)))})
            for i in range(120)]


def _tie_docs():
    return [(str(i), {"emb": [1.0] * DIMS, "body": "same"})
            for i in range(40)]


def _multi_docs():
    rng = np.random.RandomState(12)
    V = rng.randn(160, DIMS).astype(np.float32)
    return [(str(i), {"emb": [float(x) for x in V[i]],
                      "body": "alpha" if i % 3 else "alpha beta"})
            for i in range(160)]


@pytest.fixture(scope="module")
def nodes():
    """(ref, port): indices "hyb" (dense), "hys" (sparse), "ties", "hym"
    (two shards), written by both; "hyq" (ivf_pq over the dense docs),
    written by the reference and carried across."""
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    from _torch_parity import reference_arrays

    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    for name, docs, shards in (("hyb", _dense_docs(), 1),
                               ("hys", _sparse_docs(), 1),
                               ("ties", _tie_docs(), 1),
                               ("hym", _multi_docs(), 2)):
        body = {"settings": _settings(shards), "mappings": _mapping()}
        ref.create_index(name, copy.deepcopy(body))
        port.create_index(name, copy.deepcopy(body))
        for doc_id, src in docs:
            ref.indices[name].index_doc(doc_id, src)
            port.index(name, doc_id, src)
        ref.indices[name].refresh()
        port.refresh(name)
    body = {"settings": _settings(), "mappings": _mapping({"type": "ivf_pq"})}
    ref.create_index("hyq", copy.deepcopy(body))
    port.create_index("hyq", copy.deepcopy(body))
    for doc_id, src in _dense_docs():
        ref.indices["hyq"].index_doc(doc_id, src)
    ref.indices["hyq"].refresh()
    for seg in ref.indices["hyq"].shards[0].engine.segments:
        assert seg.vectors["emb"]._ivf and seg.vectors["emb"]._pq
        port.get_index("hyq").shards[0].engine.add_segment(
            segment_from_arrays(reference_arrays(seg), port.residency))
    yield ref, port
    ref.close()
    port.close()


def _vec(seed, n=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(DIMS) if n is None else rng.randn(n, DIMS)
    return np.round(x, 6).tolist()


def _hybrid(qvec, method="rrf", weights=(1.0, 1.0), rank_constant=60.0,
            nc=50, lex="alpha beta", boost=1.0, size=10, **knn):
    return {"query": {"hybrid": {
        "query": {"match": {"body": lex}},
        "knn": dict({"field": "emb", "query_vector": qvec, "k": 10,
                     "num_candidates": nc, "boost": boost}, **knn),
        "fusion": {"method": method, "weights": list(weights),
                   "rank_constant": rank_constant},
    }}, "size": size}


def _rerank(body, tokens, window, pq=None):
    body = copy.deepcopy(body)
    body["query"]["hybrid"]["rerank"] = {"query_vectors": tokens,
                                         "window_size": window}
    if pq is not None:
        body["query"]["hybrid"]["rerank"]["pq"] = pq
    return body


def _cases():
    """name -> (index, body, rtol, expected launches by wrapper name)."""
    q1, q2, q3 = _vec(1), _vec(2), _vec(3)
    in_bool = {"query": {"bool": {
        "must": [{"match": {"body": "beta"}}],
        "filter": [_hybrid(q3)["query"]]}}, "size": 15}
    return {
        "rrf_dense": ("hyb", _hybrid(q1, "rrf", (1.0, 1.5), 10.0, nc=40),
                      1e-6, {"knn": 1}),
        "rrf_dense_wide": ("hyb", _hybrid(q2, "rrf", (1.0, 2.5), 12.0,
                                          nc=60, size=40), 1e-6, {"knn": 1}),
        "linear_boost": ("hyb", _hybrid(q2, "linear", (0.3, 2.0), nc=60,
                                        boost=1.7), 1e-5, {"knn": 1}),
        "rrf_sparse": ("hys", _hybrid(q3, "rrf", (1.0, 1.0), 20.0, nc=30,
                                      lex="quick fox"), 1e-6, {"knn": 1}),
        "linear_sparse": ("hys", _hybrid(q1, "linear", (1.0, 0.5), nc=30,
                                         lex="lazy dog"), 1e-5, {"knn": 1}),
        "knn_boost_zero": ("hyb", _hybrid(q1, "rrf", nc=40, boost=0.0),
                           1e-6, {"knn": 1}),
        "in_bool_filter": ("hyb", in_bool, 1e-5, {"knn": 1}),
        "knn_filter": ("hyb", _hybrid(q2, "rrf", nc=40, filter={
            "term": {"body": "beta"}}), 1e-6, {"knn": 1}),
        "ivf_pq_knn": ("hyq", _hybrid(q1, "rrf", nc=60), 1e-6,
                       {"knn": 0, "adc": 1}),
        "rerank_exact": ("hyb", _rerank(_hybrid(q1), _vec(13, 3), 10),
                         1e-5, {"knn": 1, "maxsim": 0}),
        "rerank_window_narrower": ("hyb", _rerank(
            _hybrid(q2, "linear", (1.0, 1.0), size=12), _vec(14, 2), 5),
            1e-5, {"knn": 1, "maxsim": 0}),
        "rerank_pq": ("hyq", _rerank(_hybrid(q3, ann=False), _vec(15, 4),
                                     10, pq=True), 1e-5,
                      {"knn": 1, "adc": 0, "maxsim": 1}),
        "rerank_pq_follows_mapping": ("hyq", _rerank(
            _hybrid(q1, ann=False, size=20), _vec(16, 3), 20), 1e-5,
            {"knn": 1, "maxsim": 1}),
        "rerank_two_shards": ("hym", _rerank(_hybrid(q2, nc=40),
                                             _vec(17, 2), 10), 1e-5,
                              {"knn": 2, "maxsim": 0}),
    }


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _scores(resp):
    return np.array([h["_score"] for h in resp["hits"]["hits"]], np.float64)


def _check(r, p, rtol):
    assert p["hits"]["total"] == r["hits"]["total"]
    assert _ids(p) == _ids(r)
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=rtol)
    assert p.get("hybrid") == r.get("hybrid")
    if r["hits"]["max_score"] is None:
        assert p["hits"]["max_score"] is None
    else:
        np.testing.assert_allclose(p["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=rtol)


def _counting(monkeypatch):
    """Count the port's calls of the B2, B3 and B4 wrappers on the
    search path (their plain twins run here)."""
    calls = {"knn": 0, "adc": 0, "maxsim": 0}
    for mod, attr, key in ((port_queries, "knn_topk", "knn"),
                           (port_ivf, "adc_scores", "adc"),
                           (port_hybrid, "maxsim_adc", "maxsim")):
        real = getattr(mod, attr)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("name", sorted(_cases()))
def test_hybrid_matches_reference(nodes, monkeypatch, name):
    ref, port = nodes
    index, body, rtol, launches = _cases()[name]
    calls = _counting(monkeypatch)
    p = port.search(index, copy.deepcopy(body))
    r = ref.search(index, copy.deepcopy(body))
    assert p["hits"]["hits"], "expected hits"
    for key, n in launches.items():
        assert calls[key] == n, (key, calls)
    _check(r, p, rtol)
    if "rerank" in body["query"].get("hybrid", {}):
        spec = body["query"]["hybrid"]["rerank"]
        assert p["hybrid"]["rerank"] == "applied"
        assert p["hybrid"]["window"] <= spec["window_size"] * len(
            port.get_index(index).shards)


@pytest.mark.parametrize("method", ["rrf", "linear"])
def test_ties_rank_by_doc_id(nodes, method):
    """40 identical docs tie on both engines: doc ids 0-9, as the
    reference's tie test requires, and the same scores."""
    ref, port = nodes
    body = _hybrid([1.0] * DIMS, method, lex="same", nc=40)
    p, r = port.search("ties", copy.deepcopy(body)), ref.search(
        "ties", copy.deepcopy(body))
    assert _ids(p) == [str(i) for i in range(10)]
    _check(r, p, 1e-6)


def test_rerank_breaker_denial_keeps_stage1(nodes):
    """A request-breaker denial on the port Node answers the typed
    "declined" status (equal to the reference's), the stage-1 hits
    untouched, and counts a decline."""
    ref, port = nodes
    body = _hybrid(_vec(21))
    stage1 = port.search("hyb", copy.deepcopy(body))
    rr = _rerank(body, _vec(22, 2), 10)
    ref_br = ref_resources.BREAKERS.breaker("request")
    port_br = port.breakers.breaker("request")
    # the reference's breakers are process-wide, and its mesh executor
    # keeps its prepared rounds charged to ``request`` for as long as
    # they are cached, whichever test searched first: the reason string
    # reports the used bytes, so the reference's count starts from zero
    old = (ref_br.limit, port_br.limit, ref_br.used)
    ref_br.limit = port_br.limit = 1
    ref_br.used = 0
    declines = port_hybrid.RERANK_DECISIONS["decline"]
    try:
        p = port.search("hyb", copy.deepcopy(rr))
        r = ref.search("hyb", copy.deepcopy(rr))
    finally:
        ref_br.limit, port_br.limit, ref_br.used = old
    assert p["hybrid"]["rerank"] == "declined"
    assert p["hybrid"]["degraded_to"] == "stage1"
    assert p["hybrid"]["reason"]["type"] == "circuit_breaking_exception"
    assert p["hybrid"] == r["hybrid"]
    assert _ids(p) == _ids(stage1)
    np.testing.assert_array_equal(_scores(p), _scores(stage1))
    assert port_hybrid.RERANK_DECISIONS["decline"] == declines + 1
    assert port_br.used == 0


def test_rerank_admission_counter_ticks(nodes):
    _ref, port = nodes
    admits = port_hybrid.RERANK_DECISIONS["admit"]
    port.search("hyb", _rerank(_hybrid(_vec(23)), _vec(24, 2), 10))
    assert port_hybrid.RERANK_DECISIONS["admit"] == admits + 1
    assert port.breakers.breaker("request").used == 0


@pytest.mark.parametrize("where", ["rerank", "knn"])
def test_dims_mismatch_is_typed_400(nodes, where):
    ref, port = nodes
    body = _hybrid([1.0] * DIMS)
    if where == "rerank":
        body = _rerank(body, [[1.0] * (DIMS + 1)], 5)
    else:
        body["query"]["hybrid"]["knn"]["query_vector"] = [1.0] * (DIMS + 1)
    with pytest.raises(QueryParsingException, match="dims"):
        port.search("hyb", copy.deepcopy(body))
    from elasticsearch_tpu.utils.errors import \
        QueryParsingException as RefQueryParsingException

    with pytest.raises(RefQueryParsingException):
        ref.search("hyb", copy.deepcopy(body))


_BAD = {  # tests/unit/test_hybrid.py::TestParse's bodies
    "missing_knn": {"query": {"match_all": {}}},
    "missing_query": {"knn": {"field": "e", "query_vector": [1.0]}},
    "knn_without_vector": {"query": {"match_all": {}},
                           "knn": {"field": "e"}},
    "unknown_method": {"query": {"match_all": {}},
                       "knn": {"field": "e", "query_vector": [1.0]},
                       "fusion": {"method": "zap"}},
    "negative_weight": {"query": {"match_all": {}},
                        "knn": {"field": "e", "query_vector": [1.0]},
                        "fusion": {"weights": [1.0, -2.0]}},
    "rerank_without_vectors": {"query": {"match_all": {}},
                               "knn": {"field": "e", "query_vector": [1.0]},
                               "rerank": {"window_size": 3}},
    "rerank_window_zero": {"query": {"match_all": {}},
                           "knn": {"field": "e", "query_vector": [1.0]},
                           "rerank": {"query_vectors": [[1.0]],
                                      "window_size": 0}},
    "token_matrix_in_knn": {"query": {"match_all": {}},
                            "knn": {"field": "e",
                                    "query_vectors": [[1.0], [2.0]]}},
}


@pytest.mark.parametrize("name", sorted(_BAD))
def test_malformed_bodies_raise_typed(name):
    from elasticsearch_tpu.search.hybrid import parse_hybrid as ref_parse
    from elasticsearch_tpu.utils.errors import \
        QueryParsingException as RefQueryParsingException

    with pytest.raises(QueryParsingException):
        port_queries.parse_query({"hybrid": copy.deepcopy(_BAD[name])})
    with pytest.raises(RefQueryParsingException):
        ref_parse(copy.deepcopy(_BAD[name]))


def test_weights_and_rrf_k_aliases():
    from elasticsearch_tpu.search.hybrid import parse_hybrid as ref_parse

    body = {"lexical": {"match_all": {}},
            "vector": {"field": "e", "vector": [1.0, 2.0]},
            "fusion": {"rrf_k": 11}}
    q, rq = port_hybrid.parse_hybrid(copy.deepcopy(body)), ref_parse(body)
    assert (q.rank_constant, q.weights, q.method) == \
        (rq.rank_constant, rq.weights, rq.method) == (11.0, (1.0, 1.0), "rrf")
    assert q.knn.field == "e" and q.knn.tokens.tolist() == [[1.0, 2.0]]


def _rescore_bodies():
    tokens = _vec(31, 3)
    knn = {"knn": {"field": "emb", "query_vectors": tokens, "k": 10}}
    return {
        "query_total_wider": {
            "query": {"match": {"body": "alpha"}}, "size": 10,
            "rescore": {"window_size": 25, "query": {
                "rescore_query": {"match": {"body": "beta"}},
                "query_weight": 0.7, "rescore_query_weight": 1.2}}},
        "query_multiply_narrower": {
            "query": {"match": {"body": "alpha"}}, "size": 10,
            "rescore": {"window_size": 5, "query": {
                "rescore_query": {"match": {"body": "beta"}},
                "score_mode": "multiply"}}},
        "query_chained": {
            "query": {"match": {"body": "beta"}}, "size": 8,
            "rescore": [
                {"window_size": 12, "query": {
                    "rescore_query": {"match": {"body": "alpha"}},
                    "score_mode": "max"}},
                {"window_size": 6, "query": {
                    "rescore_query": {"match": {"body": "gamma"}},
                    "score_mode": "avg", "rescore_query_weight": 3.0}}]},
        "knn_maxsim": {
            "query": {"match": {"body": "alpha"}}, "size": 10,
            "rescore": {"window_size": 10, "query": {
                "rescore_query": knn, "query_weight": 0.0,
                "rescore_query_weight": 1.0}}},
        "knn_single_vector_boost": {
            "query": {"match": {"body": "beta"}}, "size": 10,
            "rescore": {"window_size": 15, "query": {
                "rescore_query": {"knn": {"field": "emb",
                                          "query_vector": _vec(32),
                                          "boost": 2.0}},
                "score_mode": "total"}}},
    }


@pytest.mark.parametrize("name", sorted(_rescore_bodies()))
def test_rescore_matches_reference(nodes, name):
    ref, port = nodes
    body = _rescore_bodies()[name]
    p = port.search("hyb", copy.deepcopy(body))
    r = ref.search("hyb", copy.deepcopy(body))
    assert p["hits"]["hits"]
    _check(r, p, 1e-5)
    plain = port.search("hyb", {"query": body["query"],
                                "size": body["size"]})
    assert not np.array_equal(_scores(p), _scores(plain)), "no rescore"


def test_knn_rescore_under_denial_keeps_order(nodes):
    ref, port = nodes
    body = _rescore_bodies()["knn_maxsim"]
    base = port.search("hyb", {"query": body["query"], "size": 10})
    ref_br = ref_resources.BREAKERS.breaker("request")
    port_br = port.breakers.breaker("request")
    old = (ref_br.limit, port_br.limit)
    ref_br.limit = port_br.limit = 1
    try:
        p = port.search("hyb", copy.deepcopy(body))
        r = ref.search("hyb", copy.deepcopy(body))
    finally:
        ref_br.limit, port_br.limit = old
    # the query phase's order stands; its scores are the generic f32 ones
    # (a rescored request skips B1, whose bf16 scores the plain search has)
    assert _ids(p) == _ids(base)
    _check(r, p, 1e-5)


def test_segment_without_vectors_serves_the_lexical_side():
    """A segment where no doc has the vector field: the knn side matches
    nothing and RRF ranks the lexical matches alone. The reference raises
    a TypeError here (its fusion receives no vector scores; ROADMAP
    section C)."""
    body = {"settings": _settings(), "mappings": _mapping()}
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    try:
        for node in (ref, port):
            node.create_index("novec", copy.deepcopy(body))
            for i in range(12):
                node.indices["novec"].index_doc(
                    str(i), {"body": "alpha beta" if i % 3 else "alpha"})
            node.indices["novec"].refresh()
        q = _hybrid([1.0] * DIMS, lex="alpha beta")
        p = port.search("novec", copy.deepcopy(q))
        lexical = port.search("novec", {"query": q["query"]["hybrid"]["query"],
                                        "size": 10})
        assert _ids(p) == _ids(lexical) and p["hits"]["total"] == 12
        np.testing.assert_array_equal(
            _scores(p), np.float32(1.0) / (np.float32(61.0)
                                           + np.arange(10, dtype=np.float32)))
        with pytest.raises(TypeError):
            ref.search("novec", copy.deepcopy(q))
    finally:
        ref.close()
        port.close()
