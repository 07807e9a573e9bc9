"""The percolator of the port (``search/percolator.py``, the percolator
side of ``IndexService``) against the reference on the CPU.

Every case of ``tests/unit/test_percolator.py`` runs on both packages
with its stated answers (translog recovery included), then: a seeded
registry of 240 queries in eight shapes (term, match, match_phrase, a
bool of a term and a range, conjunctive matches, bools with should,
must_not and minimum_should_match, terms and numeric terms, nested
bools and an empty one) against 24 docs one at a time and as one
batch, the ``percolator`` mapping type, updates of a percolator doc (a
script update refused, a partial update re-registered, an invalid
merged query refused before the write), the breaker bytes back at
their starting values after each call, and a device error that is not
typed raising instead of matching nothing. All comparisons are exact.
"""
import copy

import numpy as np
import pytest

from elasticsearch_tpu.index.index_service import IndexService as RefService
from elasticsearch_tpu.search.percolator import percolate as ref_percolate
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import queries as Q
from elasticsearch_tpu_torch.search.percolator import (PERCOLATOR_TYPE,
                                                       percolate)
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  IllegalArgumentException)

from _torch_parity import WORDS

ALERTS = {"properties": {"message": {"type": "text"},
                         "level": {"type": "keyword"},
                         "value": {"type": "long"}}}
ALERT_QUERIES = [
    ("q-error", {"query": {"match": {"message": "error"}}}),
    ("q-critical", {"query": {"bool": {"must": [
        {"match": {"message": "error"}},
        {"term": {"level": "critical"}}]}}}),
    ("q-range", {"query": {"range": {"value": {"gte": 100}}}}),
]


def port_service(name, mapping=None, data_path=None, node=None):
    """The port's index ``name``: created, or reopened by the gateway of a
    node over a data path that holds it."""
    node = node or Node(name="port", device="cpu", data_path=data_path)
    if name not in node.indices:
        node.create_index(name, {"mappings": mapping or {}})
    return node, node.indices[name]


@pytest.fixture()
def both():
    """The unit test's ``alerts`` index on each package."""
    ref = RefService("alerts", mappings_json=ALERTS)
    node, port = port_service("alerts", ALERTS)
    for svc in (ref, port):
        for qid, src in ALERT_QUERIES:
            svc.index_doc(qid, copy.deepcopy(src), doc_type=PERCOLATOR_TYPE)
    yield ref, port
    ref.close()
    node.close()


def _ids(r):
    return [m["_id"] for m in r["matches"]]


def _same(ref, port, body):
    want, got = ref.percolate(copy.deepcopy(body)), \
        port.percolate(copy.deepcopy(body))
    assert got == want
    return got


# -- tests/unit/test_percolator.py, case by case --------------------------------

def test_percolate_matches_subset(both):
    ref, port = both
    r = _same(ref, port, {"doc": {"message": "an error occurred",
                                  "level": "info"}})
    assert r["total"] == 1 and _ids(r) == ["q-error"]
    r = _same(ref, port, {"doc": {"message": "error!", "level": "critical",
                                  "value": 250}})
    assert sorted(_ids(r)) == ["q-critical", "q-error", "q-range"]


def test_percolate_no_match(both):
    ref, port = both
    r = _same(ref, port, {"doc": {"message": "all fine", "level": "info"}})
    assert r["total"] == 0 and r["matches"] == []


def test_percolator_unregister_on_delete(both):
    ref, port = both
    for svc in (ref, port):
        svc.delete_doc("q-error")
    assert _ids(_same(ref, port, {"doc": {"message": "error"}})) == []


def test_percolator_reregister_overwrites(both):
    ref, port = both
    for svc in (ref, port):
        svc.index_doc("q-error", {"query": {"match": {"message": "failure"}}},
                      doc_type=PERCOLATOR_TYPE)
    assert _same(ref, port, {"doc": {"message": "error"}})["total"] == 0
    assert _ids(_same(ref, port, {"doc": {"message": "failure"}})) == \
        ["q-error"]


def test_percolate_batch_multiple_docs(both):
    ref, port = both
    docs = [{"message": "error"}, {"message": "ok"}, {"value": 500}]
    want = ref_percolate(ref.percolator, docs, ref.mappings, ref.analysis)
    got = percolate(port.percolator, docs, port.mappings, port.analysis,
                    port.residency)
    assert got == want == ([["q-error"], [], ["q-range"]], 3)


def test_percolator_recovers_from_translog(tmp_path):
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    s = RefService("recov", data_path=str(rdir))
    node, p = port_service("recov", data_path=str(pdir))
    for svc in (s, p):
        svc.index_doc("q1", {"query": {"match": {"msg": "boom"}}},
                      doc_type=PERCOLATOR_TYPE)
        svc.index_doc("d1", {"msg": "hello"})
    s.close()
    node.close()
    s2 = RefService("recov", data_path=str(rdir))
    node2, p2 = port_service("recov", data_path=str(pdir))
    body = {"doc": {"msg": "boom town"}}
    assert _ids(_same(s2, p2, body)) == ["q1"]
    assert len(p2.percolator) == 1
    s2.close()
    node2.close()


def test_percolate_restricting_query():
    mapping = {"properties": {"msg": {"type": "text"},
                              "prio": {"type": "keyword"}}}
    ref = RefService("scoped", mappings_json=mapping)
    node, port = port_service("scoped", mapping)
    for svc in (ref, port):
        svc.index_doc("hi", {"query": {"match": {"msg": "error"}},
                             "prio": "high"}, doc_type=PERCOLATOR_TYPE)
        svc.index_doc("lo", {"query": {"match": {"msg": "error"}},
                             "prio": "low"}, doc_type=PERCOLATOR_TYPE)
        svc.refresh()
    r = _same(ref, port, {"doc": {"msg": "error here"}})
    assert sorted(_ids(r)) == ["hi", "lo"]
    r = _same(ref, port, {"doc": {"msg": "error here"},
                          "filter": {"term": {"prio": "high"}}})
    assert _ids(r) == ["hi"] and r["total"] == 1
    r = _same(ref, port, {"doc": {"msg": "error here"},
                          "query": {"term": {"prio": "low"}}})
    assert _ids(r) == ["lo"]
    r = _same(ref, port, {"doc": {"msg": "error here"}, "size": 1})
    assert r["total"] == 2 and _ids(r) == ["hi"]
    ref.close()
    node.close()


def test_percolate_aggregations_over_matched_queries():
    mapping = {"properties": {"msg": {"type": "text"},
                              "team": {"type": "keyword"}}}
    ref = RefService("paggs", mappings_json=mapping)
    node, port = port_service("paggs", mapping)
    for svc in (ref, port):
        for qid, word, team in (("a1", "error", "ops"), ("a2", "error", "ops"),
                                ("b1", "error", "dev"),
                                ("c1", "warning", "dev")):
            svc.index_doc(qid, {"query": {"match": {"msg": word}},
                                "team": team}, doc_type=PERCOLATOR_TYPE)
        svc.refresh()
    r = _same(ref, port, {"doc": {"msg": "an error happened"},
                          "aggs": {"teams": {"terms": {"field": "team"}}}})
    assert r["total"] == 3
    assert {b["key"]: b["doc_count"] for b in
            r["aggregations"]["teams"]["buckets"]} == {"ops": 2, "dev": 1}
    ref.close()
    node.close()


def test_percolate_highlight_per_match():
    mapping = {"properties": {"msg": {"type": "text"}}}
    ref = RefService("phl", mappings_json=mapping)
    node, port = port_service("phl", mapping)
    for svc in (ref, port):
        svc.index_doc("q_err", {"query": {"match": {"msg": "error"}}},
                      doc_type=PERCOLATOR_TYPE)
        svc.index_doc("q_disk", {"query": {"match": {"msg": "disk"}}},
                      doc_type=PERCOLATOR_TYPE)
        svc.refresh()
    r = _same(ref, port, {"doc": {"msg": "disk error on node"},
                          "highlight": {"fields": {"msg": {}}}})
    hl = {m["_id"]: m["highlight"]["msg"][0] for m in r["matches"]}
    assert "<em>error</em>" in hl["q_err"] and "<em>disk</em>" not in hl["q_err"]
    assert "<em>disk</em>" in hl["q_disk"] and \
        "<em>error</em>" not in hl["q_disk"]
    r2 = _same(ref, port, {"doc": {"msg": "disk error on node"},
                           "highlight": {"fields": {"msg": {
                               "highlight_query": {"match": {"msg": "node"}}}},
                               "pre_tags": ["<b>"], "post_tags": ["</b>"]}})
    for m in r2["matches"]:
        assert "<b>node</b>" in m["highlight"]["msg"][0]
    ref.close()
    node.close()


# -- beyond the unit cases --------------------------------------------------------

def test_percolator_mapping_type_is_served():
    mapping = {"properties": {"query": {"type": "percolator"},
                              "msg": {"type": "text"}}}
    ref = RefService("pm", mappings_json=mapping)
    node, port = port_service("pm", mapping)
    for svc in (ref, port):
        assert svc.mappings.get("query").type == "percolator"
        svc.index_doc("q", {"query": {"match": {"msg": "x"}}},
                      doc_type=PERCOLATOR_TYPE)
    assert _ids(_same(ref, port, {"doc": {"msg": "x y"}})) == ["q"]
    ref.close()
    node.close()


def test_invalid_query_never_reaches_the_translog(tmp_path, both):
    ref, port = both
    for svc in (ref, port):
        with pytest.raises(Exception, match="requires a \\[query\\]"):
            svc.index_doc("bad", {"nope": 1}, doc_type=PERCOLATOR_TYPE)
        with pytest.raises(Exception, match="unknown query"):
            svc.index_doc("bad", {"query": {"zap": {}}},
                          doc_type=PERCOLATOR_TYPE)
        assert svc.get_doc("bad")["found"] is False
    assert len(port.percolator) == len(ref.percolator) == 3


def test_percolator_updates(both):
    """A script update of a percolator doc is refused; a partial update
    re-registers the merged query; an update whose merged query does not
    parse is refused before the write, leaving the doc as it was."""
    ref, port = both
    for svc in (ref, port):
        with pytest.raises(Exception, match="cannot be script-updated"):
            svc.update_doc("q-error", {"script": "ctx._source.x = 1"})
        svc.update_doc("q-error", {"doc": {"query": {"match": {
            "message": "meltdown"}}}})
    port_err = None
    try:
        port.update_doc("q-error", {"script": "ctx._source.x = 1"})
    except IllegalArgumentException as e:
        port_err = e
    assert port_err is not None
    assert _same(ref, port, {"doc": {"message": "error"}})["total"] == 0
    assert _ids(_same(ref, port, {"doc": {"message": "meltdown"}})) == \
        ["q-error"]
    for svc in (ref, port):
        with pytest.raises(Exception, match="single-key query object"):
            svc.update_doc("q-range", {"doc": {"query": {"zap": {}}}})
        assert svc.get_doc("q-range")["_version"] == 1
    body = {"doc": {"message": "x", "value": 101}}
    assert _ids(_same(ref, port, body)) == ["q-range"]
    # the port's stored doc is as it was written; the reference merged the
    # refused query into the stored source in place (ROADMAP C11)
    assert port.get_doc("q-range")["_source"] == ALERT_QUERIES[2][1]
    assert ref.get_doc("q-range")["_source"] == {"query": {
        "range": {"value": {"gte": 100}}, "zap": {}}}


def test_breaker_bytes_return_after_percolate(both):
    """The percolate segment is charged while it lives and freed after:
    the node's breakers read as before, also after a phrase query placed
    the segment's positional CSR and a range read its numeric column."""
    ref, port = both
    port.index_doc("q-phrase", {"query": {"match_phrase": {
        "message": "disk error"}}}, doc_type=PERCOLATOR_TYPE)
    br = port.residency.breakers
    before = {n: br.breaker(n).used for n in ("segments", "fielddata")}
    peak = {}
    orig = Q.MatchPhraseQuery.execute

    def spy(self, ctx):
        peak.update({n: br.breaker(n).used for n in ("segments",
                                                     "fielddata")})
        return orig(self, ctx)

    Q.MatchPhraseQuery.execute = spy
    try:
        r = port.percolate({"doc": {"message": "disk error", "value": 300}})
    finally:
        Q.MatchPhraseQuery.execute = orig
    assert sorted(_ids(r)) == ["q-error", "q-phrase", "q-range"]
    assert peak["segments"] > before["segments"]
    assert peak["fielddata"] > before["fielddata"]
    assert {n: br.breaker(n).used for n in ("segments", "fielddata")} \
        == before


def test_a_device_error_raises(both, monkeypatch):
    """Only a typed error of a query means "no match"; anything else
    (a CUDA fault, say) fails the call."""
    _ref, port = both

    def boom(self, ctx):
        raise RuntimeError("device fault")

    monkeypatch.setattr(Q.RangeQuery, "execute", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        port.percolate({"doc": {"message": "error", "value": 5}})
    br = port.residency.breakers
    assert br.breaker("segments").used == 0


def test_a_typed_error_is_no_match(both, monkeypatch):
    _ref, port = both

    def typed(self, ctx):
        raise ElasticsearchTpuException("unmapped")

    monkeypatch.setattr(Q.RangeQuery, "execute", typed)
    r = port.percolate({"doc": {"message": "error", "value": 500}})
    assert _ids(r) == ["q-error"]


# -- a seeded registry ------------------------------------------------------------

SEEDED = {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"},
                         "n": {"type": "long"}, "shape": {"type": "keyword"}}}


def seeded_queries(rng, n):
    words = WORDS[:40]
    out = []
    w = lambda: str(rng.choice(words))
    for i in range(n):
        shape = i % 8
        if shape == 0:
            q = {"term": {"body": w()}}
        elif shape == 1:
            k = int(rng.integers(2, 4))
            q = {"match": {"body": " ".join(rng.choice(words, size=k))}}
        elif shape == 2:
            q = {"match_phrase": {"body": " ".join(rng.choice(words[:12],
                                                              size=2))}}
        elif shape == 3:
            q = {"bool": {"must": [{"term": {"body": w()}},
                                   {"range": {"n": {
                                       "gte": int(rng.integers(0, 50))}}}]}}
        elif shape == 4:  # conjunctions and counts take their own programs
            q = {"match": {"body": {"query": f"{w()} {w()} {w()}",
                                    "operator": "and" if i % 16 < 8
                                    else "or",
                                    **({} if i % 16 < 8 else
                                       {"minimum_should_match": 2})}}}
        elif shape == 5:
            q = {"bool": {"should": [{"term": {"body": w()}},
                                     {"match": {"body": f"{w()} {w()}"}},
                                     {"term": {"n": int(rng.integers(0, 9))}}],
                          "must_not": [{"term": {"body": w()}}],
                          **({"minimum_should_match": 2} if i % 16 < 8
                             else {})}}
        elif shape == 6:
            q = {"constant_score": {"filter": {"terms": {
                "body": [w(), w()]}}}} if i % 16 < 8 else \
                {"term": {"n": int(rng.integers(0, 9))}}
        else:
            q = {"bool": {"filter": [{"bool": {"must": [
                {"match": {"body": w()}}]}}], "must": [{"term": {
                    "tag": f"t{int(rng.integers(0, 3))}"}}]}} \
                if i % 16 < 8 else {"bool": {}}
        out.append((f"q{i:03d}", {"query": q, "tag": f"s{shape}"}))
    return out


def seeded_docs(rng, n):
    words = WORDS[:40]
    return [{"body": " ".join(rng.choice(words[:12] if i % 2 else words,
                                         size=int(rng.integers(3, 12)))),
             "n": int(rng.integers(0, 100)) if i % 3 else i % 9,
             "tag": f"t{i % 3}"} for i in range(n)]


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(11)
    queries = seeded_queries(rng, 240)
    docs = seeded_docs(rng, 24)
    ref = RefService("seeded", mappings_json=SEEDED)
    node, port = port_service("seeded", SEEDED)
    for svc in (ref, port):
        for qid, src in queries:
            svc.index_doc(qid, copy.deepcopy(src), doc_type=PERCOLATOR_TYPE)
        svc.refresh()
    yield ref, port, docs
    ref.close()
    node.close()


def test_seeded_one_at_a_time_and_batched(seeded):
    ref, port, docs = seeded
    one = []
    for d in docs:
        r = _same(ref, port, {"doc": d})
        one.append(_ids(r))
    assert sum(map(len, one)) > 100
    got, total = percolate(port.percolator, docs, port.mappings,
                           port.analysis, port.residency)
    want = ref_percolate(ref.percolator, docs, ref.mappings, ref.analysis)
    assert (got, total) == want and total == 240
    assert got == one


@pytest.mark.parametrize("extra", [
    {"size": 3}, {"query": {"term": {"tag": "s2"}}},
    {"filter": {"term": {"tag": "s0"}}, "size": 2},
    {"aggs": {"shapes": {"terms": {"field": "tag"}}}},
    {"highlight": {"fields": {"body": {}}}}])
def test_seeded_request_options(seeded, extra):
    ref, port, docs = seeded
    for d in docs[:6]:
        _same(ref, port, dict(copy.deepcopy(extra), doc=d))


def test_bools_run_their_own_mask(seeded, monkeypatch):
    """The registered bools combine the batched term leaves' masks by
    ``BoolQuery._combine``, the code search's ``BoolQuery.execute`` runs
    (one version of bool semantics), and the registered trees stay as
    they were."""
    ref, port, docs = seeded
    before = {qid: (raw, type(q), [list(getattr(q, n, ())) for n in
                                   ("must", "filter", "must_not", "should")])
              for qid, (raw, q) in port.percolator.items()}
    real, runs = Q.BoolQuery._combine, []

    def spy(self, ctx, *masks):
        runs.append(1)
        return real(self, ctx, *masks)

    monkeypatch.setattr(Q.BoolQuery, "_combine", spy)
    r = _same(ref, port, {"doc": docs[0]})
    assert r["total"] > 0
    bools = sum(1 for _qid, (raw, _q) in port.percolator.items()
                if "bool" in raw)
    assert len(runs) >= bools > 0
    after = {qid: (raw, type(q), [list(getattr(q, n, ())) for n in
                                  ("must", "filter", "must_not", "should")])
             for qid, (raw, q) in port.percolator.items()}
    assert after == before


def test_percolate_without_doc_is_typed(both):
    ref, port = both
    for svc in (ref, port):
        with pytest.raises(Exception, match="_percolate requires"):
            svc.percolate({})
