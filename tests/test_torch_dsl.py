"""The full-text query DSL of the port (ROADMAP A9a) against the
reference's ``Node``: every new query type on one and two shards, on the
port's mesh route and its host loop, each against the reference's answer
for the same writes and body.

Mirrors ``tests/unit/test_queries.py`` (prefix/wildcard/regexp/fuzzy,
match_phrase and its stopword gap, dis_max, filtered, multi_match,
query_string, more_like_this and its liked id across shards, boosting)
and ``test_rescore_templates.py``'s template rendering, plus ``_name`` on
each new type, phrase highlighting, a phrase under
``dfs_query_then_fetch`` over two indices, a phrase on merged segments,
``max_expansions`` caps, the routes the mesh takes and declines, and
the joins and geo types on an index without nested or geo fields (A9b's
function_score, script and span types and A9c's joins and geo are tested
in ``test_torch_function_score.py``, ``test_torch_spans.py``,
``test_torch_joins.py`` and ``test_torch_geo.py``).
One reference difference is
pinned (ROADMAP C6): ``match`` with ``type: phrase``.

Bars: the same ids in the same order, ``hits.total`` exact, scores within
rtol 1e-5 (f32 paths), ``_source``, ``matched_queries`` and
``highlight`` equal; the port's two routes byte-identical apart from
``took``.
"""
import base64
import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.positional import positional_bytes
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

from _torch_parity import MAPPING, corpus

DSL_MAPPING = {"properties": dict(MAPPING["properties"],
                                  title={"type": "text"})}
# (shards, first doc, end doc) of each index; refreshes every 60 docs
INDICES = {"one": (1, 0, 240), "two": (2, 240, 480)}
UNIT_DOCS = [
    {"title": "quick brown fox",
     "body": "the quick brown fox jumps over the lazy dog", "tag": "animal"},
    {"title": "lazy dog sleeps", "body": "a lazy dog sleeps all day long",
     "tag": "animal"},
    {"title": "fast cars", "body": "quick fast cars drive on roads",
     "tag": "vehicle"},
    {"title": "slow trains", "body": "trains are never quick but always on "
     "rails", "tag": "vehicle"},
    {"title": "brown bears", "body": "brown bears fish in quick rivers",
     "tag": "animal"},
]
UNIT_MAPPING = {"properties": {"title": {"type": "text"},
                               "body": {"type": "text"},
                               "tag": {"type": "keyword"}}}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _docs(lo, hi):
    out = []
    for doc_id, src in corpus(480, seed=7)[lo:hi]:
        src = dict(src, title=" ".join(src["body"].split()[:3]))
        out.append((doc_id, src))
    return out


def _load(node, name, shards, docs, mapping=DSL_MAPPING, every=60):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})
    svc = node.indices[name]
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for node in (ref, port):
            for name, (shards, lo, hi) in INDICES.items():
                _load(node, name, shards, _docs(lo, hi))
            _load(node, "unit", 1, [(str(i), d) for i, d in
                                    enumerate(UNIT_DOCS)], UNIT_MAPPING)
            # one 400-doc segment: its head terms get dense impact rows
            _load(node, "dense", 1, corpus(400, seed=5), MAPPING, every=400)
    yield ref, port
    ref.close()
    port.close()


_REF_CACHE = {}


def _ref(ref, index, body):
    key = (index, json.dumps(body, sort_keys=True))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = ref.search(index, copy.deepcopy(body))
    return _REF_CACHE[key]


def _port(port, index, body, host, monkeypatch):
    if host:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    try:
        return port.search(index, copy.deepcopy(body))
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
    np.testing.assert_allclose(gs, ws, rtol=1e-5, err_msg=what)
    for g, w in zip(gh, wh):
        for key in ("_source", "matched_queries", "highlight"):
            assert g.get(key) == w.get(key), (what, key, g["_id"])


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def _check(nodes, monkeypatch, index, body, what=""):
    """The port's two routes against the reference and each other;
    returns the reference's response."""
    ref, port = nodes
    want = _ref(ref, index, body)
    mesh = _port(port, index, body, False, monkeypatch)
    host = _port(port, index, body, True, monkeypatch)
    _hold(mesh, want, f"{what} {index} mesh")
    _hold(host, want, f"{what} {index} host")
    assert _strip(mesh) == _strip(host), f"{what} {index}: routes differ"
    return want


# -- every new type, on one and two shards, both routes -----------------------

BODIES = {
    "prefix": {"prefix": {"body": "ri"}},
    "prefix_boost": {"prefix": {"body": {"value": "s"}, "boost": 2.5}},
    "wildcard": {"wildcard": {"body": "r*r"}},
    "wildcard_q": {"wildcard": {"body": {"value": "?ox"}}},
    "regexp": {"regexp": {"body": "qu.ck|ri.*"}},
    "fuzzy": {"fuzzy": {"body": "quik"}},
    "fuzzy_cap": {"fuzzy": {"body": {"value": "rivr", "fuzziness": 2,
                                     "max_expansions": 1}}},
    "phrase": {"match_phrase": {"body": "quick brown"}},
    "phrase_3": {"match_phrase": {"body": "quick brown quick"}},
    "phrase_repeat": {"match_phrase": {"body": "brown brown jumps"}},
    "phrase_rev": {"match_phrase": {"body": "brown quick"}},
    "phrase_slop1": {"match_phrase": {"body": {"query": "quick fox",
                                               "slop": 1}}},
    "phrase_slop3": {"match_phrase": {"body": {"query": "fox quick dog",
                                               "slop": 3, "boost": 2}}},
    "phrase_one": {"match_phrase": {"body": "river"}},
    "phrase_absent": {"match_phrase": {"body": "quick zzzz"}},
    "phrase_title": {"match_phrase": {"title": "the quick"}},
    "phrase_prefix": {"match_phrase_prefix": {"body": "quick bro"}},
    "phrase_prefix_cap": {"match_phrase_prefix": {"body": {
        "query": "the r", "max_expansions": 2}}},
    "dis_max": {"dis_max": {"queries": [{"match": {"title": "fox"}},
                                        {"match": {"body": "fox river"}}]}},
    "dis_max_tie": {"dis_max": {"tie_breaker": 0.3, "boost": 1.5,
                                "queries": [
                                    {"match_phrase": {"body": "quick brown"}},
                                    {"prefix": {"title": "qu"}},
                                    {"term": {"tag": "t3"}}]}},
    "dis_max_empty": {"dis_max": {"queries": []}},
    "boosting": {"boosting": {"positive": {"match": {"body": "quick"}},
                              "negative": {"term": {"tag": "t2"}},
                              "negative_boost": 0.1}},
    "boosting_phrase": {"boosting": {
        "positive": {"match_phrase": {"body": {"query": "lazy dog",
                                               "slop": 2}}},
        "negative": {"wildcard": {"title": "r*"}}}},
    "match_none": {"match_none": {}},
    "missing": {"missing": {"field": "n"}},
    "filtered": {"filtered": {"query": {"match": {"body": "quick"}},
                              "filter": {"term": {"tag": "t1"}}}},
    "filtered_bare": {"filtered": {"filter": {"term": {"tag": "t4"}}}},
    "multi_match": {"multi_match": {"query": "fox river",
                                    "fields": ["title", "body"]}},
    "multi_match_tie": {"multi_match": {"query": "quick dog",
                                        "fields": ["title^2", "body"],
                                        "tie_breaker": 0.3}},
    "multi_match_most": {"multi_match": {"query": "quick dog",
                                         "type": "most_fields",
                                         "fields": ["title", "body"]}},
    "multi_match_and": {"multi_match": {"query": "quick brown",
                                        "operator": "and",
                                        "fields": ["title", "body"]}},
    "common": {"common": {"body": {"query": "the quick fox river",
                                   "cutoff_frequency": 0.05}}},
    "common_and": {"common": {"body": {"query": "the brown dog",
                                       "cutoff_frequency": 0.1,
                                       "low_freq_operator": "and"}}},
    "common_all_high": {"common": {"body": {"query": "the quick",
                                            "cutoff_frequency": 0.001}}},
    "common_msm": {"common": {"body": {
        "query": "the quick brown fox dog", "cutoff_frequency": 0.2,
        "minimum_should_match": {"low_freq": 2}}}},
    "query_string": {"query_string": {"query": "tag:t1 AND body:quick"}},
    "query_string_not": {"query_string": {"query": "quick -dog",
                                          "default_field": "body"}},
    "query_string_mix": {"query_string": {
        "query": '"lazy dog" OR ri* AND fox', "default_field": "body"}},
    "query_string_fuzzy": {"query_string": {"query": "quik~ +river",
                                            "default_field": "body"}},
    "query_string_fields": {"query_string": {"query": "fox",
                                             "fields": ["title", "body"]}},
    "simple_query_string": {"simple_query_string": {
        "query": "lazy dog", "fields": ["body"],
        "default_operator": "and"}},
    "match_fuzzy": {"match": {"body": {"query": "quik rivr",
                                       "fuzziness": "AUTO"}}},
    "match_fuzzy_and": {"match": {"body": {"query": "quik browm",
                                           "fuzziness": 1,
                                           "operator": "and"}}},
    "match_fuzzy_cap": {"match": {"body": {"query": "rivr", "fuzziness": 2,
                                           "max_expansions": 1}}},
    "mlt_text": {"more_like_this": {"fields": ["body"],
                                    "like": ["quick brown fox dog"],
                                    "min_term_freq": 1, "min_doc_freq": 1}},
    "mlt_id": {"more_like_this": {"fields": ["body", "title"],
                                  "like": [{"_id": "d250"}],
                                  "min_term_freq": 1, "min_doc_freq": 1,
                                  "max_query_terms": 4}},
    "indices": {"indices": {"indices": ["one"],
                            "query": {"match": {"body": "fox"}},
                            "no_match_query": {"match": {"body": "dog"}}}},
    "indices_none": {"indices": {"indices": ["tw*"],
                                 "query": {"match_phrase": {
                                     "body": "quick brown"}},
                                 "no_match_query": "none"}},
    "template": {"template": {"query": {"match": {"body": "{{q}}"}},
                              "params": {"q": "river fox"}}},
    "wrapper": {"wrapper": {"query": base64.b64encode(json.dumps(
        {"match_phrase": {"body": "lazy dog"}}).encode()).decode()}},
    "bool_mix": {"bool": {
        "must": [{"match_phrase": {"body": {"query": "quick fox",
                                            "slop": 2}}}],
        "should": [{"fuzzy": {"title": "quik"}},
                   {"dis_max": {"queries": [{"prefix": {"body": "ri"}}]}}],
        "must_not": [{"regexp": {"tag": "t[56]"}}]}},
}


@pytest.mark.parametrize("index", sorted(INDICES))
@pytest.mark.parametrize("name", sorted(BODIES))
def test_query_type_matches_reference(nodes, monkeypatch, name, index):
    want = _check(nodes, monkeypatch, index,
                  {"query": BODIES[name], "size": 25}, name)
    # the liked doc lives in "two"; "one" has no doc to like
    if name not in ("match_none", "phrase_absent", "dis_max_empty",
                    "indices_none", "phrase_prefix_cap") \
            and (name, index) not in (("mlt_id", "one"),
                                      ("phrase_repeat", "one")):
        assert want["hits"]["total"] > 0, name


def test_deep_page_and_from(nodes, monkeypatch):
    for name in ("phrase_slop3", "wildcard", "common"):
        _check(nodes, monkeypatch, "two",
               {"query": BODIES[name], "from": 5, "size": 60}, name)


# -- the reference's unit cases, on its own five docs --------------------------

UNIT_CASES = [
    ({"prefix": {"body": "rail"}}, ["3"]),
    ({"wildcard": {"body": "r*s"}}, ["2", "3", "4"]),
    ({"regexp": {"body": "qu.ck"}}, ["0", "2", "3", "4"]),
    ({"fuzzy": {"body": "quik"}}, ["0", "2", "3", "4"]),
    ({"match_phrase": {"body": "quick brown fox"}}, ["0"]),
    ({"match_phrase": {"body": "brown quick"}}, []),
    ({"match_phrase": {"body": {"query": "quick fox", "slop": 1}}}, ["0"]),
    ({"match_phrase": {"body": "jumps over the lazy dog"}}, ["0"]),
    ({"dis_max": {"queries": [{"match": {"title": "fox"}},
                              {"match": {"body": "fox"}}]}}, ["0"]),
    ({"filtered": {"query": {"match": {"body": "quick"}},
                   "filter": {"term": {"tag": "vehicle"}}}}, ["2", "3"]),
    ({"multi_match": {"query": "fox sleeps", "fields": ["title", "body"]}},
     ["0", "1"]),
    ({"query_string": {"query": "tag:animal AND body:quick"}}, ["0", "4"]),
    ({"query_string": {"query": "quick -dog", "default_field": "body"}},
     ["2", "3", "4"]),
    ({"query_string": {"query": 'body:"quick brown fox"'}}, ["0"]),
    ({"more_like_this": {"fields": ["body"], "like": ["quick brown fox dog"],
                         "min_term_freq": 1, "min_doc_freq": 1}},
     ["0", "1", "2", "3", "4"]),
    ({"boosting": {"positive": {"match": {"body": "quick"}},
                   "negative": {"term": {"tag": "vehicle"}},
                   "negative_boost": 0.1}}, ["0", "2", "3", "4"]),
]


@pytest.mark.parametrize("case", range(len(UNIT_CASES)))
def test_reference_unit_case(nodes, monkeypatch, case):
    body, ids = UNIT_CASES[case]
    want = _check(nodes, monkeypatch, "unit", {"query": body}, str(body))
    assert sorted(h["_id"] for h in want["hits"]["hits"]) == ids


def test_boosting_demotes_and_mlt_ranks_the_like_text_first(nodes,
                                                            monkeypatch):
    r = _check(nodes, monkeypatch, "unit", {"query": UNIT_CASES[-1][0]})
    score = {h["_id"]: h["_score"] for h in r["hits"]["hits"]}
    assert score["2"] < score["0"]
    r = _check(nodes, monkeypatch, "unit", {"query": UNIT_CASES[-2][0]})
    assert r["hits"]["hits"][0]["_id"] == "0"


# -- _name, highlight, dfs, merges ----------------------------------------------

NAMED = {
    "phrase": {"match_phrase": {"body": {"query": "quick brown",
                                         "_name": "ph"}}},
    "prefix": {"prefix": {"title": "qu", "_name": "pre"}},
    "wildcard": {"wildcard": {"body": {"value": "r*r", "_name": "wc"}}},
    "regexp": {"regexp": {"body": {"value": "do.", "_name": "rx"}}},
    "fuzzy": {"fuzzy": {"body": {"value": "quik", "_name": "fz"}}},
    "dis_max": {"dis_max": {"queries": [{"match": {"body": "lazy"}}],
                            "_name": "dm"}},
    "boosting": {"boosting": {"positive": {"match": {"body": "fox"}},
                              "negative": {"match": {"body": "dog"}},
                              "_name": "bo"}},
    "multi_match": {"multi_match": {"query": "river", "_name": "mm",
                                    "fields": ["title", "body"]}},
    "common": {"common": {"body": {"query": "the ocean",
                                   "cutoff_frequency": 0.05,
                                   "_name": "co"}}},
    "query_string": {"query_string": {"query": "forest", "_name": "qs",
                                      "default_field": "body"}},
    "match_none": {"match_none": {"_name": "none"}},
    "inside": {"dis_max": {"queries": [
        {"match": {"body": {"query": "ocean", "_name": "in_dm"}}},
        {"boosting": {"positive": {"prefix": {"title": {
            "value": "l", "_name": "in_pos"}}},
            "negative": {"term": {"tag": {"value": "t1",
                                          "_name": "in_neg"}}}}}]}},
    "phrase_prefix": {"match_phrase_prefix": {"body": {"query": "lazy d",
                                                       "_name": "pp"}}},
}


@pytest.mark.parametrize("index", sorted(INDICES))
def test_name_on_each_new_type(nodes, monkeypatch, index):
    body = {"query": {"bool": {"should": list(NAMED.values())}}, "size": 60}
    want = _check(nodes, monkeypatch, index, body, "named")
    seen = {n for h in want["hits"]["hits"]
            for n in h.get("matched_queries", [])}
    assert seen >= {"ph", "pre", "wc", "fz", "dm", "bo", "mm", "qs",
                    "in_dm", "in_pos", "in_neg"}, seen


@pytest.mark.parametrize("query", [
    {"match_phrase": {"body": "quick brown"}},
    {"match_phrase_prefix": {"body": "lazy d"}},
    {"prefix": {"body": "ri"}},
    {"fuzzy": {"body": "quik"}},
    {"wildcard": {"body": "r*r"}},
    {"multi_match": {"query": "fox river", "fields": ["title", "body"]}},
    {"dis_max": {"queries": [{"match_phrase": {"title": "quick brown"}},
                             {"match": {"body": "dog"}}]}},
])
def test_highlight_of_phrase_and_expansions(nodes, monkeypatch, query):
    body = {"query": query, "size": 8, "highlight": {"fields": {
        "body": {"fragment_size": 40}, "title": {}}}}
    want = _check(nodes, monkeypatch, "one", body, "highlight")
    if not isinstance(query.get("wildcard"), dict) and "wildcard" not in query:
        assert any(h.get("highlight") for h in want["hits"]["hits"])


@pytest.mark.parametrize("query", [
    {"match_phrase": {"body": "quick brown"}},
    {"match_phrase": {"body": {"query": "lazy dog", "slop": 2}}},
    {"fuzzy": {"body": "quik"}},
])
def test_phrase_under_dfs_over_two_indices(nodes, query):
    """One idf over both indices (the phrase's idf_sum included), on the
    multi-index host loop: the reference's answer."""
    ref, port = nodes
    body = {"query": query, "size": 30,
            "search_type": "dfs_query_then_fetch"}
    want = ref.search("one,two", copy.deepcopy(body))
    got = port.search("one,two", copy.deepcopy(body))
    _hold(got, want, f"dfs {query}")
    plain = port.search("one,two", {"query": query, "size": 30})
    assert [h["_score"] for h in plain["hits"]["hits"]] != \
        [h["_score"] for h in got["hits"]["hits"]]


def test_phrase_under_dfs_on_one_index(nodes, monkeypatch):
    body = {"query": {"match_phrase": {"body": "quick brown"}}, "size": 30,
            "search_type": "dfs_query_then_fetch"}
    _check(nodes, monkeypatch, "two", body, "dfs one index")


def test_phrase_on_merged_segments(monkeypatch):
    """After force_merge(1): the phrase answers on the merged segment as
    the reference's does, and the retired segments' positional CSRs are
    released with their other fielddata."""
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    try:
        for node in (ref, port):
            _load(node, "m", 2, _docs(0, 200), every=40)
        bodies = [{"query": {"match_phrase": {"body": "quick brown"}},
                   "size": 20},
                  {"query": {"match_phrase": {"body": {
                      "query": "lazy fox", "slop": 3}}}, "size": 20}]
        fd = port.breakers.breaker("fielddata")
        svc = port.indices["m"]
        for body in bodies:
            _hold(port.search("m", copy.deepcopy(body)),
                  ref.search("m", copy.deepcopy(body)), "before merge")
        before = [seg for s in svc.shards for seg in s.segments]
        assert len(before) > 2
        assert sum(positional_bytes(seg.inverted["body"])
                   for seg in before) > 0
        for node in (ref, port):
            node.indices["m"].force_merge(1)
        after = [seg for s in svc.shards for seg in s.segments]
        assert len(after) == 2
        ex = svc._mesh_executor
        assert fd.used == sum(s.fielddata_bytes() for s in after) + \
            ex.data_bytes() + sum(rd.nbytes for rd in ex._prep.values())
        for body in bodies:
            want = ref.search("m", copy.deepcopy(body))
            for host in (False, True):
                _hold(_port(port, "m", body, host, monkeypatch), want,
                      f"after merge host={host}")
        assert fd.used == sum(s.fielddata_bytes() for s in after) + \
            ex.data_bytes() + sum(rd.nbytes for rd in ex._prep.values())
        assert all(positional_bytes(seg.inverted["body"]) > 0
                   for seg in after)
    finally:
        ref.close()
        port.close()
    assert port.breakers.breaker("fielddata").used == 0


def test_mlt_liked_id_resolves_across_shards(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    from elasticsearch_tpu_torch.cluster.routing import shard_id_for

    monkeypatch.setattr(aot, "_ENABLED", False)
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    try:
        for n in (ref, port):
            n.create_index("mlt4", {
                "settings": {"number_of_shards": 4},
                "mappings": {"properties": {"body": {"type": "text"}}}})
            svc = n.indices["mlt4"]
            svc.index_doc("seed", {"body": "quantum entanglement qubits"})
            for i in range(12):
                svc.index_doc(f"sim{i}",
                              {"body": "quantum entanglement qubits lab"})
                svc.index_doc(f"no{i}", {"body": "pasta sauce recipe"})
            svc.refresh()
        body = {"query": {"more_like_this": {
            "fields": ["body"], "like": [{"_id": "seed"}],
            "min_term_freq": 1, "min_doc_freq": 1}}, "size": 30}
        for include in (False, True):
            body["query"]["more_like_this"]["include"] = include
            want = ref.search("mlt4", copy.deepcopy(body))
            got = port.search("mlt4", copy.deepcopy(body))
            _hold(got, want, f"mlt include={include}")
            ids = [h["_id"] for h in got["hits"]["hits"]]
            assert len(ids) == 12 + include and ("seed" in ids) == include
            assert {shard_id_for(i, 4) for i in ids} == {0, 1, 2, 3}
    finally:
        ref.close()
        port.close()


def test_mlt_like_doc_of_another_index(nodes):
    """A liked doc named with ``_index`` resolves through the node."""
    ref, port = nodes
    body = {"query": {"more_like_this": {
        "fields": ["body"], "like": [{"_index": "two", "_id": "d250"}],
        "min_term_freq": 1, "min_doc_freq": 1}}, "size": 20}
    want = ref.search("one", copy.deepcopy(body))
    got = port.search("one", copy.deepcopy(body))
    _hold(got, want, "mlt _index")
    assert got["hits"]["total"] > 0


def test_terms_lookup_resolves_before_the_fan_out(nodes, monkeypatch):
    """``rewrite_mlt_in_body`` also resolves a terms lookup (the terms at
    ``path`` of a doc, any shard); a missing doc matches nothing."""
    ref, port = nodes
    for doc_id in ("d250", "d251", "nope"):
        body = {"query": {"terms": {"tag": {"index": "two", "type": "_doc",
                                            "id": doc_id, "path": "tag"}}},
                "size": 30}
        want = _check(nodes, monkeypatch, "two", body, f"lookup {doc_id}")
        assert (want["hits"]["total"] > 0) == (doc_id != "nope")


# -- routes --------------------------------------------------------------------

MESH_SERVED = ["prefix", "wildcard", "regexp", "fuzzy", "phrase_3",
               "phrase_slop3", "dis_max_tie", "boosting_phrase", "match_none",
               "missing", "filtered", "wrapper", "template", "bool_mix"]
HOST_ONLY = ["match_fuzzy", "multi_match", "common", "query_string_mix",
             "mlt_text", "indices", "phrase_prefix"]


def _counts(port, index, body):
    k0 = dict(kernels.snapshot())
    port.search(index, copy.deepcopy(body))
    k1 = kernels.snapshot()
    return {k: k1[k] - k0.get(k, 0) for k in k1}


@pytest.mark.parametrize("name", MESH_SERVED)
def test_mesh_serves(nodes, name):
    _ref, port = nodes
    c = _counts(port, "two", {"query": BODIES[name]})
    assert c.get("mesh_search", 0) == 1 and \
        c.get("mesh_fallback_total", 0) == 0, (name, c)
    if name.startswith("phrase"):
        assert c.get("phrase_program", 0) >= 1


@pytest.mark.parametrize("name", HOST_ONLY)
def test_mesh_declines_to_the_host_loop(nodes, name):
    """What the reference's mesh declines goes to the host loop through a
    typed MeshCompileError (``mesh_fallback_total``), never a wrong
    answer."""
    _ref, port = nodes
    c = _counts(port, "two", {"query": BODIES[name]})
    assert c.get("mesh_fallback_total", 0) == 1 and \
        c.get("mesh_search", 0) == 0, (name, c)


@pytest.mark.parametrize("query", [
    {"fuzzy": {"body": {"value": "quick", "fuzziness": 0}}},
    {"match_phrase": {"body": "quick"}},
    {"match": {"body": {"query": "quick", "fuzziness": 1}}},
    {"match": {"body": {"query": "quick bromn", "fuzziness": 1}}},
])
def test_dense_only_expansion_scores_in_f32_on_the_mesh(nodes, monkeypatch,
                                                        query):
    """A fuzzy query, a one-term phrase or a match with fuzziness that
    lands on dense rows alone scores in f32 on the host loop (a fuzzy
    match's misspelt term expands: "bromn" to "brown"); the mesh keeps
    that, and leaves kernel B1 (bf16) to the match and term queries the
    host loop sends there."""
    _ref, port = nodes
    c = _counts(port, "dense", {"query": query})
    route = "mesh_fallback_total" if "match" in query else "mesh_search"
    assert c.get(route) == 1 and not c.get("bm25_fused_topk"), c
    _check(nodes, monkeypatch, "dense", {"query": query, "size": 25})
    c = _counts(port, "dense", {"query": {"match": {"body": "quick"}}})
    assert c.get("bm25_fused_topk") == 1, c


def test_fuzzy_match_raises_mesh_compile_error(nodes):
    from elasticsearch_tpu_torch.parallel.compiler import (MeshCompileError,
                                                           MeshQueryCompiler)
    from elasticsearch_tpu_torch.search.queries import parse_query

    _ref, port = nodes
    svc = port.indices["one"]
    with pytest.raises(MeshCompileError) as e:
        MeshQueryCompiler(svc.mappings, svc.analysis, D=256).compile(
            parse_query(BODIES["match_fuzzy"]))
    assert not e.value.by_design


# -- the reference difference: match type phrase (ROADMAP C6) -------------------

def test_match_type_phrase_is_a_phrase(nodes, monkeypatch):
    """ES 2.0 runs ``match`` with ``type: phrase`` as a phrase query and
    ``phrase_prefix`` as a phrase prefix; the reference ignores ``type``
    and runs an OR match. The port answers the reference's match_phrase;
    the reference's own answer is pinned as the plain match's."""
    ref, port = nodes
    for typ, phrase_type, extra in (
            ("phrase", "match_phrase", {"slop": 1}),
            ("phrase_prefix", "match_phrase_prefix", {})):
        body = {"query": {"match": {"body": dict(
            {"query": "quick brown", "type": typ}, **extra)}}, "size": 20}
        as_phrase = {"query": {phrase_type: {"body": dict(
            {"query": "quick brown"}, **extra)}}, "size": 20}
        as_match = {"query": {"match": {"body": "quick brown"}}, "size": 20}
        for host in (False, True):
            _hold(_port(port, "two", body, host, monkeypatch),
                  _ref(ref, "two", as_phrase), f"match type {typ}")
        pinned = ref.search("two", copy.deepcopy(body))
        _hold(pinned, _ref(ref, "two", as_match), "reference ignores type")
        assert pinned["hits"]["total"] > \
            _ref(ref, "two", as_phrase)["hits"]["total"]


# -- refusals and parsing --------------------------------------------------------

A9B = {
    "nested": {"nested": {"path": "x", "query": {"match_all": {}}}},
    "has_child": {"has_child": {"type": "c", "query": {"match_all": {}}}},
    "has_parent": {"has_parent": {"type": "p", "query": {"match_all": {}}}},
    "top_children": {"top_children": {"type": "c",
                                      "query": {"match_all": {}}}},
    "geo_distance": {"geo_distance": {"distance": "1km",
                                      "loc": [0, 0]}},
    "geo_bounding_box": {"geo_bounding_box": {"loc": {
        "top_left": [-10, 10], "bottom_right": [10, -10]}}},
    "geo_polygon": {"geo_polygon": {"loc": {"points": [[0, 0], [1, 1],
                                                       [1, 0]]}}},
    "geo_shape": {"geo_shape": {"loc": {"shape": {
        "type": "envelope", "coordinates": [[-1, 1], [1, -1]]}}}},
}


@pytest.mark.parametrize("name", sorted(A9B))
@pytest.mark.parametrize("host", [False, True])
def test_a9b_types_are_refused(nodes, monkeypatch, name, host):
    """The join and geo types the port once refused (A9c) are served: on
    an index without nested docs, children, parents or points each
    matches nothing on either route, as in the reference (a join with
    ``_type`` matching the whole untyped index: has_parent's default)."""
    ref, port = nodes
    body = {"query": A9B[name], "size": 5}
    _hold(_port(port, "two", body, host, monkeypatch), _ref(ref, "two", body),
          name)


def test_unknown_and_malformed_queries_raise(nodes):
    _ref, port = nodes
    with pytest.raises(QueryParsingException, match="unknown query type"):
        port.search("one", {"query": {"frobnicate": {}}})
    with pytest.raises(QueryParsingException, match="invalid regexp"):
        port.search("one", {"query": {"regexp": {"body": "(unclosed"}}})
    with pytest.raises(QueryParsingException):
        port.search("one", {"query": {"match_phrase": {"body": "a",
                                                       "title": "b"}}})


# -- templates -------------------------------------------------------------------

TEMPLATE_CASES = [
    ({"query": {"match": {"{{field}}": "{{value}}"}}, "size": "{{size}}"},
     {"field": "body", "value": "quick fox", "size": 5}),
    ('{"query": {"terms": {"tag": "{{#toJson}}tags{{/toJson}}"}}}',
     {"tags": ["a", "b"]}),
    ({"query": {"match": {"f": "{{q}}"}}}, {"q": "literal {{x}} text"}),
    ({"query": {"match": {"f": "{{a.b}}"}}, "from": "{{n}}"},
     {"a": {"b": 'quo"te'}, "n": 3}),
]


@pytest.mark.parametrize("case", range(len(TEMPLATE_CASES)))
def test_render_template_matches_reference(case):
    from elasticsearch_tpu.search.templates import render_template as ref_r
    from elasticsearch_tpu_torch.search.templates import render_template

    tmpl, params = TEMPLATE_CASES[case]
    assert render_template(tmpl, params) == ref_r(tmpl, params)


def test_render_template_errors():
    from elasticsearch_tpu_torch.search.templates import render_template
    from elasticsearch_tpu_torch.utils.errors import SearchParseException

    with pytest.raises(SearchParseException, match="missing template"):
        render_template({"q": "{{nope}}"}, {})
    with pytest.raises(SearchParseException, match="invalid JSON"):
        render_template('{"q": {{v}}', {"v": 1})
