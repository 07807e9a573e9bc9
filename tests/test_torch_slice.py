"""The port's first slice end to end: the same seeded corpus indexed into a
JAX-package Node (host search loop, ``search.mesh: false``) and a port
Node on the CPU, then the same ``_search`` bodies through both.

Bars. Generic-path queries: the same ids in the same order, scores at
rtol 1e-5 (scatter sums may run in another order), ``hits.total`` exact.
Fused-path queries (pure disjunctive term groups on dense impact rows):
``hits.total`` exact, scores at rtol 5e-3 and recall@k >= 0.95. The
reference on the CPU takes its fallback, an f32 HIGHEST product, while
the port computes what the TPU kernel computes, a bf16 product with f32
accumulation; 5e-3 and 0.95 are the reference's own bar for its kernel
(tests/unit/test_pallas_kernels.py::test_pallas_bm25_dense_topk_matches_xla).
"""
import copy

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import queries as port_queries

from _torch_parity import MAPPING, corpus

SETTINGS = {"index": {"number_of_shards": 2, "search": {"mesh": "false"}}}
N_DOCS = 900


def _make_nodes(ref_path=None, port_path=None):
    ref = RefNode(name="ref", data_path=ref_path)
    port = Node(name="port", data_path=port_path, device="cpu")
    body = {"settings": SETTINGS, "mappings": MAPPING}
    ref.create_index("docs", copy.deepcopy(body))
    port.create_index("docs", copy.deepcopy(body))
    return ref, port


@pytest.fixture(scope="module")
def nodes():
    ref, port = _make_nodes()
    for doc_id, src in corpus(N_DOCS, seed=4):
        ref.indices["docs"].index_doc(doc_id, src)
        port.index("docs", doc_id, src)
    ref.indices["docs"].refresh()
    port.refresh("docs")
    yield ref, port
    ref.close()
    port.close()


GENERIC = {
    "match_and": {"query": {"match": {"body": {"query": "quick fox river",
                                               "operator": "and"}}}},
    "match_msm": {"query": {"match": {"body": {
        "query": "lazy dog ocean desert", "minimum_should_match": "50%"}}}},
    "match_tail": {"query": {"match": {"body": "zulu yankee island"}},
                   "size": 5},
    "term_keyword": {"query": {"term": {"tag": "t3"}}, "size": 20},
    "terms": {"query": {"terms": {"tag": ["t1", "t5"]}}, "size": 7},
    "bool": {"query": {"bool": {
        "must": [{"match": {"body": "brown dog"}}],
        "should": [{"match": {"body": "river"}}, {"term": {"tag": "t2"}}],
        "must_not": [{"term": {"tag": "t4"}}],
        "filter": [{"range": {"price": {"gte": 10, "lt": 80}}}]}},
        "size": 15},
    "bool_msm": {"query": {"bool": {
        "should": [{"match": {"body": "quick"}}, {"match": {"body": "lazy"}},
                   {"match": {"body": "mountain"}}],
        "minimum_should_match": 2}}, "size": 12},
    "range_long": {"query": {"range": {"n": {"gt": 100_000_300,
                                             "lte": 700_002_100}}}},
    "range_double": {"query": {"range": {"price": {"gte": 25.5,
                                                   "lte": 60}}}},
    "ids": {"query": {"ids": {"values": ["d3", "d77", "d500", "nope"]}}},
    "exists": {"query": {"exists": {"field": "n"}}, "size": 30},
    "constant_score": {"query": {"constant_score": {
        "filter": {"term": {"tag": "t6"}}, "boost": 2.5}}, "size": 9},
    "match_all": {"query": {"match_all": {}}, "size": 25},
    "paged": {"query": {"match": {"body": "engine shard mountain"}},
              "from": 10, "size": 10},
    "no_source_version": {"query": {"term": {"tag": "t0"}}, "size": 5,
                          "_source": False, "version": True},
}

FUSED = {
    "match_or": {"query": {"match": {"body": "quick brown fox"}}},
    "match_or_k50": {"query": {"match": {"body": "foxes jumping"}},
                     "size": 50},
    "term_text": {"query": {"term": {"body": "fox"}}, "size": 20},
    "paged": {"query": {"match": {"body": "brown jumps"}}, "from": 20,
              "size": 10},
}


def _search(node, body):
    return node.search("docs", copy.deepcopy(body))


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _scores(resp):
    return np.array([h["_score"] for h in resp["hits"]["hits"]], np.float64)


def _check_generic(r, p):
    assert p["hits"]["total"] == r["hits"]["total"]
    assert p["_shards"] == r["_shards"]
    assert _ids(p) == _ids(r)
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=1e-5)
    for hp, hr in zip(p["hits"]["hits"], r["hits"]["hits"]):
        # the reference reads `version: true` but emits no _version (a
        # reference fault, ROADMAP section C); the port emits it
        assert set(hp) - {"_version"} == set(hr)
        assert hp.get("_source") == hr.get("_source")
        assert (hp["_index"], hp["_type"]) == (hr["_index"], hr["_type"])
    if r["hits"]["max_score"] is None:
        assert p["hits"]["max_score"] is None
    else:
        np.testing.assert_allclose(p["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_path_matches_reference(nodes, name):
    ref, port = nodes
    before = port_queries.FUSED_CALLS
    p = _search(port, GENERIC[name])
    assert port_queries.FUSED_CALLS == before, "expected the generic path"
    _check_generic(_search(ref, GENERIC[name]), p)
    if GENERIC[name].get("version"):
        for h in p["hits"]["hits"]:
            assert h["_version"] == \
                ref.indices["docs"].get_doc(h["_id"])["_version"]


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_path_matches_reference(nodes, name):
    ref, port = nodes
    before = port_queries.FUSED_CALLS
    p = _search(port, FUSED[name])
    assert port_queries.FUSED_CALLS > before, "expected the fused path"
    r = _search(ref, FUSED[name])
    assert p["hits"]["total"] == r["hits"]["total"]
    assert len(_ids(p)) == len(_ids(r))
    # recall@k over the whole top k = from + size; a page is its slice
    frm = FUSED[name].get("from", 0)
    top = dict(FUSED[name], size=frm + FUSED[name].get("size", 10), **{
        "from": 0})
    rid, pid = _ids(_search(ref, top)), _ids(_search(port, top))
    assert len(set(pid) & set(rid)) / max(len(rid), 1) >= 0.95
    assert _ids(p) == pid[frm:]
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=5e-3)
    np.testing.assert_allclose(p["hits"]["max_score"],
                               r["hits"]["max_score"], rtol=5e-3)
    assert np.all(np.diff(_scores(p)) <= 0)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_path_reads_the_query_rows_of_the_whole_block(nodes, name,
                                                           monkeypatch):
    """The fused caller hands B1 the segment's whole dense block, the
    query's real rows only (no pad), and asks for the count in the packed
    result, so that one copy brings the hits and the total back."""
    _ref, port = nodes
    calls = []
    real = port_queries.bm25_dense_topk

    def spy(qw, impact, mask, **kw):
        calls.append((qw.shape, impact.shape, mask.shape[0], kw))
        return real(qw, impact, mask, **kw)

    monkeypatch.setattr(port_queries, "bm25_dense_topk", spy)
    _search(port, FUSED[name])
    assert calls
    for (Q, R), (F, D), n_mask, kw in calls:
        rows = kw["rows"]
        assert Q == 1 and rows.shape == (R,) and D == n_mask
        assert ((rows >= 0) & (rows < F)).all()
        assert len(set(rows.tolist())) == R  # each query row once
        assert kw["count"] and kw["packed"]


def test_delete_then_search(nodes):
    ref, port = nodes
    body = {"query": {"match": {"body": "zulu yankee island"}}, "size": 3}
    victim = _ids(_search(port, body))[0]
    rd = ref.indices["docs"].delete_doc(victim)
    pd = port.delete("docs", victim)
    assert (pd["_version"], pd["result"]) == (rd["_version"], rd["result"])
    ref.indices["docs"].refresh()
    port.refresh("docs")
    r, p = _search(ref, body), _search(port, body)
    assert victim not in _ids(p)
    _check_generic(r, p)
    assert port.get("docs", victim)["found"] is False


def test_index_get_versions(nodes):
    ref, port = nodes
    src = {"body": "fresh river stone", "tag": "t9", "n": 5}
    for _ in range(2):
        rr = ref.indices["docs"].index_doc("new1", src)
        pr = port.index("docs", "new1", src)
        assert (pr["_version"], pr["result"], pr["_seq_no"] >= 0) == \
            (rr["_version"], rr["result"], True)
    g = port.get("docs", "new1")  # realtime: visible before refresh
    assert g["found"] and g["_version"] == 2 and g["_source"] == src


def _write_ops(index_doc, delete_doc):
    docs = corpus(60, seed=9)
    for doc_id, src in docs:
        index_doc(doc_id, src)
    index_doc("d5", {"body": "rewritten quick fox", "tag": "t1", "n": 1})
    delete_doc("d7")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_translog_replays_across_packages(tmp_path, writer):
    """A translog one package writes replays in the other: same docs,
    versions and search results. The reader's gateway reopens the index
    from the ``_meta.json`` beside the shards (both packages write it)."""
    wdir, rdir = str(tmp_path / "w"), str(tmp_path / "w")
    if writer == "port":
        w = Node(name="w", data_path=wdir, device="cpu")
        w.create_index("docs", {"settings": SETTINGS, "mappings": MAPPING})
        _write_ops(lambda i, s: w.index("docs", i, s),
                   lambda i: w.delete("docs", i))
        w.close()
        reader = RefNode(name="r", data_path=rdir)
        svc = reader.indices["docs"]
        get = svc.get_doc
    else:
        w = RefNode(name="w", data_path=wdir)
        w.create_index("docs", {"settings": SETTINGS, "mappings": MAPPING})
        svc = w.indices["docs"]
        _write_ops(svc.index_doc, svc.delete_doc)
        w.close()
        reader = Node(name="r", data_path=rdir, device="cpu")
        get = lambda i: reader.get("docs", i)  # noqa: E731
    try:
        assert get("d7")["found"] is False
        d5 = get("d5")
        assert d5["_version"] == 2 and d5["_source"]["body"] == \
            "rewritten quick fox"
        assert get("d0")["_version"] == 1
        resp = reader.search("docs", {"query": {"match_all": {}}})
        assert resp["hits"]["total"] == 59
    finally:
        reader.close()


# -- knn: the second slice ---------------------------------------------------
#
# Four vector indices over the same seeded clustered corpus: brute force
# (no index_options), IVF and IVF-PQ, and an l2_norm IVF-PQ index. The
# port writes the brute-force index itself (write path, freeze). The IVF
# indices carry the reference's frozen segments across through
# segment_from_arrays, with the reference's quantizer and PQ codes, so
# query-time parity does not hang on two k-means runs agreeing. Bar: the
# same hit ids in the same order, hits.total exact, scores at rtol 1e-5
# (f32 sums in other orders).

VEC_DIMS = 16
VEC_DOCS = 600


def _vec_body(opts, similarity="cosine"):
    v = {"type": "dense_vector", "dims": VEC_DIMS, "similarity": similarity}
    if opts:
        v["index_options"] = opts
    return {"settings": SETTINGS, "mappings": {"properties": {
        "v": v, "bucket": {"type": "long"}, "tag": {"type": "keyword"}}}}


def _vec_docs():
    from _torch_parity import clustered

    x = clustered(VEC_DOCS, VEC_DIMS, 12, seed=21)
    docs = []
    for i in range(VEC_DOCS):
        src = {"bucket": i % 50, "tag": f"t{i % 7}"}
        if i % 29:  # a few docs without a vector
            src["v"] = [float(a) for a in x[i]]
        docs.append((f"v{i}", src))
    return x, docs


@pytest.fixture(scope="module")
def vec_nodes():
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    from _torch_parity import reference_arrays

    ref = RefNode(name="ref")
    port = Node(name="port", device="cpu")
    x, docs = _vec_docs()
    for name, opts, sim in (("vb", None, "cosine"),
                            ("vi", {"type": "ivf"}, "cosine"),
                            ("vp", {"type": "ivf_pq"}, "cosine"),
                            ("vl", {"type": "ivf_pq"}, "l2_norm")):
        ref.create_index(name, _vec_body(opts, sim))
        port.create_index(name, _vec_body(opts, sim))
        for doc_id, src in docs:
            ref.indices[name].index_doc(doc_id, src)
            if name == "vb":
                port.index(name, doc_id, src)
        ref.indices[name].refresh()
        if name == "vb":
            port.refresh(name)
            continue
        for s, shard in enumerate(ref.indices[name].shards):
            for seg in shard.engine.segments:
                port.get_index(name).shards[s].engine.add_segment(
                    segment_from_arrays(reference_arrays(seg),
                                        port.residency))
    yield ref, port, x
    ref.close()
    port.close()


def _q(x, i, noise=0.05):
    rng = np.random.default_rng(i)
    return [float(a) for a in x[i] + noise * rng.standard_normal(VEC_DIMS)]


def _knn_bodies(x):
    q, q2 = _q(x, 5), _q(x, 40)
    knn = {"field": "v", "query_vector": q}
    knn_far = {"field": "v", "query_vector": _q(x, 9, noise=1.0)}
    sel = {"range": {"bucket": {"lt": 2}}}  # 24 of 600 docs
    return {
        # (index, body, brute force expected to run)
        "brute": ("vb", {"query": {"knn": dict(knn)}}, True),
        "brute_k_size": ("vb", {"query": {"knn": dict(
            knn, k=20, num_candidates=50)}, "size": 20}, True),
        "brute_filter": ("vb", {"query": {"knn": dict(
            knn, filter={"term": {"tag": "t3"}})}, "size": 15}, True),
        "brute_in_bool": ("vb", {"query": {"bool": {
            "must": [{"knn": dict(knn)}],
            "filter": [{"range": {"bucket": {"gte": 10}}}]}}}, True),
        "maxsim": ("vb", {"query": {"knn": {
            "field": "v", "query_vectors": [q, q2, _q(x, 77)]}},
            "size": 12}, True),
        "maxsim_nested_filter": ("vb", {"query": {"knn": {
            "field": "v", "query_vector": [q, q2],
            "filter": {"term": {"tag": "t1"}}}}}, True),
        "ivf": ("vi", {"query": {"knn": dict(knn, num_candidates=60)}},
                False),
        "ivf_filter": ("vi", {"query": {"knn": dict(
            knn, num_candidates=60, filter={"term": {"tag": "t2"}})}},
            False),
        "ivf_starved": ("vi", {"query": {"knn": dict(
            knn, num_candidates=10, filter=sel)}}, True),
        "ivf_forced_brute": ("vi", {"query": {"knn": dict(
            knn, ann=False)}}, True),
        "ivf_pq": ("vp", {"query": {"knn": dict(knn, num_candidates=60)}},
                   False),
        "ivf_pq_filter": ("vp", {"query": {"knn": dict(
            knn, num_candidates=60, filter={"term": {"tag": "t2"}})}},
            False),
        "ivf_pq_starved": ("vp", {"query": {"knn": dict(
            knn, num_candidates=10, filter=sel)}}, True),
        # l2_norm: B2's norm expansion, the l2 quantizer and LUT. Both
        # packages score l2 as 1 / (1 + |q|^2 - 2 q.v + |v|^2), which
        # cancels near a duplicate (|q|^2 ~ 150 here): a query at
        # distance ~4 keeps every score well inside rtol 1e-5
        "l2_ivf_pq": ("vl", {"query": {"knn": dict(
            knn_far, num_candidates=60)}}, False),
        "l2_brute_filter": ("vl", {"query": {"knn": dict(
            knn_far, ann=False, filter={"term": {"tag": "t4"}})}}, True),
    }


_KNN_CASES = sorted(_knn_bodies(np.zeros((VEC_DOCS, VEC_DIMS))))


@pytest.mark.parametrize("name", _KNN_CASES)
def test_knn_matches_reference(vec_nodes, monkeypatch, name):
    ref, port, x = vec_nodes
    index, body, brute = _knn_bodies(x)[name]
    calls = []
    real = port_queries.knn_topk
    monkeypatch.setattr(port_queries, "knn_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    p = port.search(index, copy.deepcopy(body))
    r = ref.search(index, copy.deepcopy(body))
    assert p["hits"]["hits"], "expected hits"
    assert bool(calls) == brute, "brute force ran" if calls else "no brute"
    _check_generic(r, p)


def test_knn_dims_mismatch_raises_typed(vec_nodes):
    from elasticsearch_tpu_torch.utils.errors import QueryParsingException

    _ref, port, _x = vec_nodes
    with pytest.raises(QueryParsingException, match="dims"):
        port.search("vb", {"query": {"knn": {"field": "v",
                                             "query_vector": [1.0, 2.0]}}})


def test_knn_own_ivf_pq_build_recall(vec_nodes):
    """The port's own IVF-PQ build (write path, freeze) against its own
    exact brute force on the same index: recall@10 >= 0.95, the
    reference's floor for its ANN paths."""
    _ref, _port, x = vec_nodes
    _x, docs = _vec_docs()
    node = Node(name="own", device="cpu")
    try:
        node.create_index("own", _vec_body({"type": "ivf_pq"}))
        for doc_id, src in docs:
            node.index("own", doc_id, src)
        node.refresh("own")
        hits = 0
        for i in range(10):
            knn = {"field": "v", "query_vector": _q(x, 30 * i + 1),
                   "num_candidates": 100}
            ann = node.search("own", {"query": {"knn": knn}})
            exact = node.search("own", {"query": {"knn": dict(knn,
                                                              ann=False)}})
            hits += len(set(_ids(ann)) & set(_ids(exact)))
        assert hits / 100 >= 0.95
    finally:
        node.close()
