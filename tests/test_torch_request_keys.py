"""The request keys served since the port's A6c slice, each on each
route it takes, against the reference's ``Node``:

- ``fields`` / ``stored_fields`` (stored values, dotted ``_source``
  paths, a fields list dropping ``_source``), on the mesh and the host
  loop;
- ``search_type: dfs_query_then_fetch`` on one index (the mesh and the
  host loop; a dfs round never reads or fills the prepared-query memo,
  and the coalescer never takes it) and over several indices (the host
  loop, the statistics summed over every searched index);
- ``_query_cache`` and ``index.cache.query.enable``: hit, miss, the
  invalidation by a write, a refresh and a merge, a size-0 body after
  ``force_merge`` equal to an uncached one;
- multi-index ``Node.search``: comma lists, wildcards, ``_all``, ``*``
  and None, ``indices_boost``, ``_msearch`` headers;
- the keys still refused, each naming the ROADMAP item that brings it.

Bars: the generic route's (the same ids in order, ``hits.total`` exact,
scores within 1e-5); responses of the port's two routes and of the
request cache identical apart from ``took``.
"""
import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import (IndexNotFoundException,
                                                  SearchParseException)

from _torch_parity import MAPPING, corpus

STORED_MAPPING = {"properties": dict(
    MAPPING["properties"], tag={"type": "keyword", "store": True})}
INDICES = {"logs-a": (2, 0, 240), "logs-b": (3, 240, 330),
           "other": (1, 330, 400)}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _docs(lo, hi):
    docs = corpus(400, seed=5)[lo: hi]
    out = []
    for i, (doc_id, src) in enumerate(docs):
        src = dict(src)
        if i % 3 == 0:
            src["meta"] = {"host": f"h{i % 4}", "codes": [i, i + 1]}
        out.append((doc_id, src))
    return out


def _load(node, name, shards, docs, settings=None):
    idx = {"number_of_shards": shards}
    idx.update(settings or {})
    node.create_index(name, {"settings": {"index": idx},
                             "mappings": copy.deepcopy(STORED_MAPPING)})
    svc = node.indices[name]
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if (j + 1) % 40 == 0:
            svc.refresh()
    svc.refresh()


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for name, (shards, lo, hi) in INDICES.items():
            for node in (ref, port):
                _load(node, name, shards, _docs(lo, hi))
    yield ref, port
    ref.close()
    port.close()


def _search(node, index, body, host=False, monkeypatch=None):
    if host:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    try:
        return node.search(index, copy.deepcopy(body))
    finally:
        if host:
            monkeypatch.delenv("ESTPU_DISABLE_MESH")


def _hold(got, want, what):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"], what
    assert [(h["_index"], h["_id"]) for h in gh] == \
        [(h["_index"], h["_id"]) for h in wh], what
    gs = [h["_score"] for h in gh]
    ws = [h["_score"] for h in wh]
    if None in gs + ws:
        assert gs == ws, what
    else:
        np.testing.assert_allclose(gs, ws, rtol=1e-5, err_msg=what)
    assert got["_shards"] == want["_shards"], what
    for g, w in zip(gh, wh):
        for key in ("_source", "fields", "matched_queries"):
            assert g.get(key) == w.get(key), (what, key, g["_id"])


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


QUERY = {"match": {"body": "fox river dog"}}

# -- fields / stored_fields ------------------------------------------------

FIELDS = {
    "stored_keyword": {"fields": ["tag"]},
    "source_leaves": {"stored_fields": ["n", "price", "body"]},
    "dotted": {"fields": ["meta.host", "meta.codes", "meta"]},
    "missing": {"fields": ["nope", "meta.nope"]},
    "with_source": {"fields": ["tag", "_source"]},
    "source_key": {"fields": ["n"], "_source": ["tag"]},
    "string": {"fields": "price"},
}


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("route", ["mesh", "host"])
def test_fields_match_the_reference(nodes, name, route, monkeypatch):
    ref, port = nodes
    body = dict(FIELDS[name], query=QUERY, size=15)
    host = route == "host"
    kernels.reset()
    got = _search(port, "logs-a", body, host, monkeypatch)
    assert bool(kernels.snapshot().get("mesh_search")) == (not host)
    _hold(got, _search(ref, "logs-a", body, host, monkeypatch), name)
    if not host:
        assert _strip(got) == _strip(_search(port, "logs-a", body, True,
                                             monkeypatch))


# -- dfs_query_then_fetch --------------------------------------------------

DFS = {"match": {"query": {"match": {"body": "fox river dog"}}, "size": 20},
       "term": {"query": {"term": {"tag": "t3"}}, "size": 20},
       "bool": {"query": {"bool": {
           "must": [{"match": {"body": "lazy"}}],
           "should": [{"term": {"tag": "t1"}}]}}, "size": 20}}


@pytest.mark.parametrize("name", sorted(DFS))
@pytest.mark.parametrize("route", ["mesh", "host"])
def test_dfs_on_one_index_matches_the_reference(nodes, name, route,
                                                monkeypatch):
    ref, port = nodes
    body = dict(DFS[name], search_type="dfs_query_then_fetch")
    host = route == "host"
    got = _search(port, "logs-b", body, host, monkeypatch)
    _hold(got, _search(ref, "logs-b", body, host, monkeypatch), name)
    plain = _search(port, "logs-b", DFS[name], host, monkeypatch)
    assert [h["_score"] for h in plain["hits"]["hits"]] != \
        [h["_score"] for h in got["hits"]["hits"]]


def test_dfs_routes_agree_and_skip_the_memo(nodes, monkeypatch):
    _ref, port = nodes
    body = dict(DFS["match"], search_type="dfs_query_then_fetch")
    ex = port.indices["logs-b"].mesh_executor()
    for _ in range(2):
        kernels.reset()
        got = _search(port, "logs-b", body)
        snap = kernels.snapshot()
        assert snap.get("mesh_search") == 1
        assert not snap.get("executor_prep_hit")
        assert not snap.get("executor_prep_miss")
    assert not any(b"dfs_query_then_fetch" in k[0] for k in ex._prep)
    want = _search(port, "logs-b", body, True, monkeypatch)
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    np.testing.assert_allclose([h["_score"] for h in got["hits"]["hits"]],
                               [h["_score"] for h in want["hits"]["hits"]],
                               rtol=1e-5)


def test_the_coalescer_never_takes_a_dfs_body(nodes, monkeypatch):
    _ref, port = nodes
    seen = []
    real = port.serving.coalescer.execute
    monkeypatch.setattr(port.serving.coalescer, "execute",
                        lambda svc, body, run: seen.append(body)
                        or real(svc, body, run))
    body = dict(DFS["match"], search_type="dfs_query_then_fetch")
    port.search("logs-a", copy.deepcopy(body))
    port.search("logs-a", copy.deepcopy(DFS["match"]))
    assert seen == [DFS["match"]]


@pytest.mark.parametrize("expr", ["logs-a,logs-b", "logs-*", "_all"])
@pytest.mark.parametrize("name", sorted(DFS))
def test_dfs_over_several_indices_matches_the_reference(nodes, expr, name):
    ref, port = nodes
    body = dict(DFS[name], search_type="dfs_query_then_fetch")
    kernels.reset()
    got = _search(port, expr, body)
    assert not kernels.snapshot().get("mesh_search")
    _hold(got, _search(ref, expr, body), f"{expr} {name}")


# -- the request cache -----------------------------------------------------

AGG = {"size": 0, "query": {"match": {"body": "fox dog"}},
       "aggs": {"t": {"terms": {"field": "tag"}},
                "p": {"avg": {"field": "price"}},
                "top": {"top_hits": {"size": 2}}}}


def _cache_pair(settings=None):
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    for node in (ref, port):
        _load(node, "c", 2, _docs(0, 160), settings)
    return ref, port


def _stats(node):
    return dict(node.indices["c"].query_cache_stats)


def _same_aggs(got, want):
    """The terms and top_hits exactly, the avg at the aggregation tests'
    rtol 1e-5 (its sums run in another order)."""
    g, w = got["aggregations"], want["aggregations"]
    assert g["t"] == w["t"] and g["top"] == w["top"]
    np.testing.assert_allclose(g["p"]["value"], w["p"]["value"], rtol=1e-5)


def test_query_cache_hit_miss_and_invalidation():
    ref, port = _cache_pair()
    body = dict(AGG, _query_cache=True)
    try:
        steps = []
        for step in ("miss", "hit", "write", "after_write", "refresh",
                     "after_refresh", "merge", "after_merge", "off",
                     "uncacheable"):
            for node in (ref, port):
                svc = node.indices["c"]
                if step == "write":
                    svc.index_doc("new", {"body": "fox fox", "tag": "t0"})
                    continue
                if step == "refresh":
                    svc.refresh()
                    continue
                if step == "merge":
                    for j in range(24):  # one shard reaches 8 a tier
                        svc.index_doc(f"m{j}", {"body": "dog", "tag": "t2"})
                        svc.refresh()
                    continue
                b = dict(body, _query_cache=False) if step == "off" \
                    else dict(body, size=1) if step == "uncacheable" \
                    else body
                node.search("c", copy.deepcopy(b))
            steps.append((step, _stats(ref), _stats(port)))
        for step, r, p in steps:
            assert r == p, step
        assert steps[-1][2] == {"hits": 1, "misses": 4, "evictions": 0}
        assert sum(s.engine.stats.merge_total
                   for s in port.indices["c"].shards) > 0
        got = port.search("c", copy.deepcopy(body))
        want = ref.search("c", copy.deepcopy(body))
        _hold(got, want, "cached")
        _same_aggs(got, want)
    finally:
        ref.close()
        port.close()


def test_a_cache_hit_is_a_deep_copy_equal_to_the_first_answer():
    _ref, port = _cache_pair()
    try:
        first = port.search("c", dict(AGG, _query_cache=True))
        first["hits"]["total"] = -1
        second = port.search("c", dict(AGG, _query_cache=True))
        third = port.search("c", dict(AGG, _query_cache=True))
        assert second["hits"]["total"] != -1
        assert _strip(second) == _strip(third)
        assert _stats(port) == {"hits": 2, "misses": 1, "evictions": 0}
    finally:
        _ref.close()
        port.close()


def test_cache_enabled_by_the_index_setting_and_its_exclusions():
    ref, port = _cache_pair({"cache.query.enable": True})
    try:
        bodies = [AGG, AGG, dict(AGG, profile=True),
                  dict(AGG, search_type="dfs_query_then_fetch"),
                  dict(AGG, query={"match": {"body": "now-1d fox"}}),
                  dict(AGG, query={"match": {"body": "nowhere"}}),
                  dict(AGG, query={"match": {"body": "nowhere"}})]
        for b in bodies:
            for node in (ref, port):
                node.search("c", copy.deepcopy(b))
        assert _stats(port) == _stats(ref) == {
            "hits": 2, "misses": 2, "evictions": 0}
    finally:
        ref.close()
        port.close()


def test_cache_evicts_past_its_cap(monkeypatch):
    _ref, port = _cache_pair()
    svc = port.indices["c"]
    monkeypatch.setattr(svc, "QUERY_CACHE_CAP", 2)
    try:
        for w in ("fox", "dog", "river", "fox"):
            port.search("c", dict(AGG, query={"match": {"body": w}},
                                  _query_cache=True))
        assert _stats(port) == {"hits": 0, "misses": 4, "evictions": 2}
    finally:
        _ref.close()
        port.close()


def test_cached_size_zero_after_force_merge_equals_uncached():
    """A force merge moves the cache key's merge counter: the ``size: 0``
    answer after it is computed anew and equals an uncached one, the avg's
    last bits included (one merged segment sums in another order than
    the segments it folded)."""
    _ref, port = _cache_pair()
    try:
        before = port.search("c", dict(AGG, _query_cache=True))
        port.indices["c"].force_merge(1)
        got = port.search("c", dict(AGG, _query_cache=True))
        assert _stats(port) == {"hits": 0, "misses": 2, "evictions": 0}
        again = port.search("c", dict(AGG, _query_cache=True))
        assert _stats(port) == {"hits": 1, "misses": 2, "evictions": 0}
        fresh = port.search("c", dict(AGG, _query_cache=False))
        assert _strip(got) == _strip(fresh) == _strip(again)
        assert before["aggregations"]["t"] == got["aggregations"]["t"]
        assert before["aggregations"]["top"] == got["aggregations"]["top"]
    finally:
        _ref.close()
        port.close()


def test_reference_cache_serves_a_pre_merge_answer():
    """Reference fault (ROADMAP C): the reference's cache key holds no
    merge counter, so after ``force_merge`` it serves the avg summed over
    the old segments, which differs in its last bits from the answer of
    the merged segment."""
    ref, _port = _cache_pair()
    try:
        ref.search("c", dict(AGG, _query_cache=True))
        ref.indices["c"].force_merge(1)
        cached = ref.search("c", dict(AGG, _query_cache=True))
        assert _stats(ref) == {"hits": 1, "misses": 1, "evictions": 0}
        fresh = ref.search("c", dict(AGG, _query_cache=False))
        assert cached["aggregations"]["p"] != fresh["aggregations"]["p"]
        assert cached["aggregations"]["t"] == fresh["aggregations"]["t"]
    finally:
        ref.close()
        _port.close()


# -- multi-index search ----------------------------------------------------

EXPRS = ["logs-a,logs-b", "logs-*", "logs-a,other,logs-b", "_all", "*",
         None, "l*-b,logs-a", "logs-a,logs-a"]


@pytest.mark.parametrize("expr", EXPRS, ids=str)
def test_index_expressions_match_the_reference(nodes, expr):
    ref, port = nodes
    body = {"query": QUERY, "size": 25}
    kernels.reset()
    got = _search(port, expr, body)
    if len(port.resolve_indices(expr)) > 1:
        assert not kernels.snapshot().get("mesh_search")
    _hold(got, _search(ref, expr, body), str(expr))


@pytest.mark.parametrize("boost", [
    {"logs-a": 2.0}, [{"logs-*": 0.5}, {"other": 3}],
    {"logs-b": 1.0, "o*": 0.25}], ids=str)
def test_indices_boost_matches_the_reference(nodes, boost):
    ref, port = nodes
    body = {"query": QUERY, "size": 30, "indices_boost": boost}
    _hold(_search(port, "logs-a,logs-b,other", body),
          _search(ref, "logs-a,logs-b,other", body), str(boost))


def test_indices_boost_keeps_one_index_on_the_host_loop(nodes):
    ref, port = nodes
    body = {"query": QUERY, "size": 10, "indices_boost": {"logs-a": 3}}
    kernels.reset()
    got = _search(port, "logs-a", body)
    assert kernels.snapshot().get("mesh_fallback_total") == 1
    _hold(got, _search(ref, "logs-a", body), "one index")


def test_multi_index_scroll_and_sort(nodes):
    ref, port = nodes
    for body in ({"query": QUERY, "sort": ["n"], "size": 12},
                 {"query": QUERY, "size": 7, "from": 5,
                  "indices_boost": {"other": 2}},
                 {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}}):
        got = _search(port, "logs-b,other", body)
        want = _search(ref, "logs-b,other", body)
        _hold(got, want, json.dumps(body))
        assert got.get("aggregations") == want.get("aggregations")


def test_unknown_name_answers_404(nodes):
    """A name that is no index answers 404 alone and inside a comma list
    (ES 2.0); the reference drops it inside a comma list."""
    ref, port = nodes
    with pytest.raises(IndexNotFoundException):
        port.search("nope", {"query": QUERY})
    with pytest.raises(IndexNotFoundException):
        port.search("logs-a,nope", {"query": QUERY})
    want = ref.search("logs-a", {"query": QUERY})
    assert ref.search("logs-a,nope", {"query": QUERY})["hits"]["total"] \
        == want["hits"]["total"]


def test_msearch_batches_one_resolved_index_only(nodes, monkeypatch):
    from elasticsearch_tpu_torch.search import batch

    ref, port = nodes
    bodies = [{"query": {"match": {"body": w}}, "size": 5}
              for w in ("fox", "river", "dog")]
    real = batch.execute_batch
    for header, batched in (("logs-a", True), ("logs-*", False),
                            ("l*-a", True), ("logs-a,logs-b", False)):
        calls = []
        monkeypatch.setattr(batch, "execute_batch",
                            lambda svc, bs, *a, **kw: calls.append(1)
                            or real(svc, bs, *a, **kw))
        got = port.msearch([({"index": header}, copy.deepcopy(b))
                            for b in bodies])["responses"]
        assert bool(calls) == batched, header
        want = ref.msearch([({"index": header}, copy.deepcopy(b))
                            for b in bodies])["responses"]
        for b, g, w in zip(bodies, got, want):
            _hold(g, w, f"{header} {b}")


# -- still refused -----------------------------------------------------------

@pytest.mark.parametrize("key, value, item", [
    ("stats", ["group"], None), ("post_filter", {"term": {"tag": "t1"}},
                                 "A6c"),
    ("explain", True, "A6c"), ("track_scores", True, "A6c")])
@pytest.mark.parametrize("expr", ["logs-a", "logs-a,logs-b"])
def test_remaining_keys_name_their_item(nodes, key, value, item, expr):
    """A refused key names its queue item; ``stats`` (item None) is
    served since A10b and answers as the reference does."""
    ref, port = nodes
    body = {"query": QUERY, key: value}
    if item is None:
        _hold(port.search(expr, copy.deepcopy(body)),
              ref.search(expr, copy.deepcopy(body)), f"{expr} {key}")
        return
    with pytest.raises(SearchParseException) as e:
        port.search(expr, body)
    assert f"ROADMAP {item}" in str(e.value) and key in str(e.value)
