"""The joins of the port (``search/joins.py``; the block arrays of
``index/segment.py``; the nested, reverse_nested and children aggs)
against the reference's ``Node`` on the CPU.

Every case of ``tests/unit/test_joins.py`` with its stated answers, then
seeded corpora: 200 questions with 0-6 nested answers (the shape of
Rally's ``nested`` track) and the same questions as ``question`` parents
of ``answer`` children (``_parent``), each over 2 shards and several
refreshes. Also: a multi-level nested path, a delete cascade, merges of
nested segments (``force_merge(1)`` equal to a one-refresh rebuild), a
reference segment carried across by ``index/convert.py``, roots only in
totals, aggs, sorts and scrolls, no B1 launch on a nested segment, the
``_msearch`` tiers' decline, the mesh's decline counter and the
``RoutingMissingException``.

Bars: the same ids in the same order, ``hits.total`` exact, scores
within rtol 1e-6 (``max``, ``min`` and ``none`` exact), agg buckets and
counts exact; the port's mesh route (which declines) and host loop
byte-identical.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.index.convert import segment_from_arrays
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.search import queries as Q
from elasticsearch_tpu_torch.utils.errors import RoutingMissingException

from _torch_parity import WORDS, reference_arrays

POSTS_MAPPING = {"properties": {
    "title": {"type": "text"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"},
        "stars": {"type": "integer"},
        "text": {"type": "text"},
    }},
}}
POSTS = [
    ("1", {"title": "post one", "comments": [
        {"author": "alice", "stars": 5, "text": "great stuff"},
        {"author": "bob", "stars": 1, "text": "terrible"}]}),
    ("2", {"title": "post two", "comments": [
        {"author": "alice", "stars": 1, "text": "meh"},
        {"author": "carol", "stars": 5, "text": "wonderful"}]}),
    ("3", {"title": "post three no comments"}),
]
DEEP_MAPPING = {"properties": {
    "a": {"type": "nested", "properties": {
        "name": {"type": "keyword"},
        "b": {"type": "nested", "properties": {"v": {"type": "integer"}}},
    }},
}}
DEEP = [("1", {"a": [{"name": "x", "b": [{"v": 1}, {"v": 2}]},
                     {"name": "y", "b": [{"v": 3}]}]}),
        ("2", {"a": [{"name": "z", "b": [{"v": 9}]}]})]
SHOP_MAPPING = {"store": {"properties": {"name": {"type": "text"}}},
                "product": {"_parent": {"type": "store"},
                            "properties": {"item": {"type": "text"}}}}
# (id, source, type, parent)
SHOP = [("p1", {"name": "store one"}, "store", None),
        ("p2", {"name": "store two"}, "store", None),
        ("c1", {"item": "red shoe"}, "product", "p1"),
        ("c2", {"item": "blue shoe"}, "product", "p1"),
        ("c3", {"item": "red hat"}, "product", "p2")]

ANSWER = {"user": {"type": "keyword"}, "date": {"type": "date"},
          "score": {"type": "long"}, "text": {"type": "text"}}
QA_MAPPING = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "votes": {"type": "long"},
    "answers": {"type": "nested", "properties": ANSWER}}}
QAPC_MAPPING = {
    "question": {"properties": {"title": {"type": "text"},
                                "tag": {"type": "keyword"},
                                "votes": {"type": "long"}}},
    "answer": {"_parent": {"type": "question"}, "properties": ANSWER}}
DAY_MS = 86_400_000
T0 = 1_420_070_400_000  # 2015-01-01


def questions(n: int, seed: int = 7):
    """[(id, source)]: a title, a Zipf tag, votes and 0-6 answers, each a
    Zipf user, a date over 90 days, a score and a few words."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    users = 1.0 / np.arange(1, 41) ** 1.2
    users /= users.sum()
    out = []
    for i in range(n):
        src = {"title": " ".join(rng.choice(WORDS, 6, p=p)),
               "tag": f"t{min(int(rng.zipf(1.6)), 9)}",
               "votes": int(rng.integers(0, 50))}
        k = int(rng.integers(0, 7))
        if k:
            src["answers"] = [{
                "user": f"u{int(rng.choice(40, p=users))}",
                "date": T0 + int(rng.integers(0, 90)) * DAY_MS,
                "score": int(rng.integers(-3, 20)),
                "text": " ".join(rng.choice(WORDS, 4, p=p))}
                for _ in range(k)]
        out.append((f"q{i}", src))
    return out


def _create(node, name, mapping, shards=1):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})
    return node.indices[name]


def _load_nested(node, name, docs, mapping, shards=1, every=None):
    svc = _create(node, name, mapping, shards)
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if every and (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


def _load_pc(node, name, rows, mapping, shards=1, every=None):
    """rows: (id, source, type, parent); a child routes by its parent."""
    svc = _create(node, name, mapping, shards)
    for j, (doc_id, src, typ, parent) in enumerate(rows):
        kw = {"doc_type": typ}
        if parent is not None:
            kw.update(parent=parent, routing=parent)
        svc.index_doc(doc_id, copy.deepcopy(src), **kw)
        if every and (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


def qa_pc_rows(docs):
    """The questions as parents, each answer a child of its question."""
    rows = []
    for qid, src in docs:
        rows.append((qid, {k: v for k, v in src.items() if k != "answers"},
                     "question", None))
        for j, a in enumerate(src.get("answers", [])):
            rows.append((f"{qid}a{j}", a, "answer", qid))
    return rows


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    qa = questions(200)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for node in (ref, port):
            _load_nested(node, "posts", POSTS, POSTS_MAPPING)
            _load_nested(node, "deep", DEEP, DEEP_MAPPING)
            _load_pc(node, "shop", SHOP, SHOP_MAPPING, shards=2)
            _load_nested(node, "qa", qa, QA_MAPPING, shards=2, every=40)
            _load_pc(node, "qapc", qa_pc_rows(qa), QAPC_MAPPING, shards=2,
                     every=90)
    yield ref, port
    ref.close()
    port.close()


def fresh_pair(name, docs, mapping):
    ref, port = RefNode(name="ref2"), Node(name="port2", device="cpu")
    for node in (ref, port):
        _load_nested(node, name, docs, mapping)
    return ref, port


def _host(port, index, body):
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        return port.search(index, copy.deepcopy(body))
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def _same(got, want, rtol, where="$"):
    """Equal structures; floats within ``rtol`` (0: exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, got, want)
        for k in want:
            _same(got[k], want[k], rtol, f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rtol, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), (where, got, want)
        if rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=where)
        else:
            assert got == want, (where, got, want)
    else:
        assert got == want, (where, got, want)


def check(nodes, index, body, rtol=1e-6, route="mesh_fallback_total"):
    """The port's two routes byte for byte (the mesh declining, or with
    ``route="mesh_search"`` serving), and the host loop's response
    against the reference's (``took`` aside)."""
    ref, port = nodes
    want = ref.search(index, copy.deepcopy(body))
    kernels.reset()
    mesh = port.search(index, copy.deepcopy(body))
    snap = kernels.snapshot()
    got = _host(port, index, body)
    assert snap.get(route) == 1, snap
    assert _strip(mesh) == _strip(got)
    got, want = dict(got), dict(want)
    got.pop("took")
    want.pop("took")
    _same(got, want, rtol)
    return got


def ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


# -- tests/unit/test_joins.py, case by case -----------------------------------

def test_nested_per_object_semantics(nodes):
    q = {"nested": {"path": "comments", "query": {"bool": {"must": [
        {"term": {"comments.author": "alice"}},
        {"term": {"comments.stars": 5}}]}}}}
    assert ids(check(nodes, "posts", {"query": q})) == ["1"]


def test_nested_children_hidden_from_toplevel(nodes):
    resp = check(nodes, "posts", {"query": {"match_all": {}}, "size": 50})
    assert ids(resp) == ["1", "2", "3"]
    assert resp["hits"]["total"] == 3


@pytest.mark.parametrize("mode", ["avg", "sum", "max", "min", "none"])
def test_nested_score_modes(nodes, mode):
    q = {"nested": {"path": "comments", "score_mode": mode,
                    "query": {"match": {"comments.text": "great wonderful"}}}}
    resp = check(nodes, "posts", {"query": q},
                 rtol=1e-6 if mode in ("avg", "sum") else 0)
    assert resp["hits"]["total"] == 2
    if mode == "none":
        assert all(h["_score"] == 1.0 for h in resp["hits"]["hits"])
    else:
        assert all(h["_score"] > 0 for h in resp["hits"]["hits"])


def test_nested_inner_hits(nodes):
    q = {"nested": {"path": "comments",
                    "query": {"term": {"comments.author": "alice"}},
                    "inner_hits": {}}}
    resp = check(nodes, "posts", {"query": q})
    assert resp["hits"]["total"] == 2
    for h in resp["hits"]["hits"]:
        ih = h["inner_hits"]["comments"]["hits"]
        assert ih["total"] == 1
        assert ih["hits"][0]["_source"]["author"] == "alice"
        assert ih["hits"][0]["_nested"]["field"] == "comments"
    doc1 = next(h for h in resp["hits"]["hits"] if h["_id"] == "1")
    assert doc1["inner_hits"]["comments"]["hits"]["hits"][0][
        "_nested"]["offset"] == 0


def test_nested_agg_and_reverse(nodes):
    body = {"size": 0, "aggs": {"c": {"nested": {"path": "comments"},
                                      "aggs": {
        "by_author": {"terms": {"field": "comments.author"}, "aggs": {
            "back": {"reverse_nested": {}}}},
        "avg_stars": {"avg": {"field": "comments.stars"}}}}}}
    agg = check(nodes, "posts", body)["aggregations"]["c"]
    assert agg["doc_count"] == 4
    assert agg["avg_stars"]["value"] == pytest.approx(3.0)
    buckets = {b["key"]: b for b in agg["by_author"]["buckets"]}
    assert buckets["alice"]["doc_count"] == 2
    assert buckets["alice"]["back"]["doc_count"] == 2


def test_nested_delete_cascades():
    ref, port = fresh_pair("posts", POSTS, POSTS_MAPPING)
    try:
        for node in (ref, port):
            node.indices["posts"].delete_doc("1")
        seg = port.indices["posts"].shards[0].engine.segments[0]
        # the device mirror holds the cascade: the root and both comments
        assert int(seg.live.sum()) == seg.num_docs - 3
        assert seg.deleted_count == 3
        for node in (ref, port):
            node.indices["posts"].refresh()
        q = {"nested": {"path": "comments",
                        "query": {"term": {"comments.author": "bob"}}}}
        assert ids(check((ref, port), "posts", {"query": q})) == []
        body = {"size": 0, "aggs": {"c": {"nested": {"path": "comments"}}}}
        assert check((ref, port), "posts", body)[
            "aggregations"]["c"]["doc_count"] == 2
    finally:
        ref.close()
        port.close()


def test_nested_survives_merge():
    ref, port = fresh_pair("posts", POSTS, POSTS_MAPPING)
    try:
        for node in (ref, port):
            node.indices["posts"].index_doc("4", copy.deepcopy(POSTS[0][1]))
            node.indices["posts"].refresh()
            node.indices["posts"].force_merge(1)
        assert len(port.indices["posts"].shards[0].engine.segments) == 1
        q = {"nested": {"path": "comments", "query": {"bool": {"must": [
            {"term": {"comments.author": "alice"}},
            {"term": {"comments.stars": 5}}]}}}}
        assert ids(check((ref, port), "posts", {"query": q})) == ["1", "4"]
    finally:
        ref.close()
        port.close()


def test_multilevel_nested_path_joins_to_root(nodes):
    q = {"nested": {"path": "a.b", "query": {"term": {"a.b.v": 3}}}}
    assert ids(check(nodes, "deep", {"query": q})) == ["1"]
    q = {"nested": {"path": "a", "query": {"bool": {"must": [
        {"term": {"a.name": "x"}},
        {"nested": {"path": "a.b", "query": {"term": {"a.b.v": 2}}}}]}}}}
    assert ids(check(nodes, "deep", {"query": q})) == ["1"]
    q = {"nested": {"path": "a", "query": {"bool": {"must": [
        {"term": {"a.name": "y"}},
        {"nested": {"path": "a.b", "query": {"term": {"a.b.v": 2}}}}]}}}}
    assert ids(check(nodes, "deep", {"query": q})) == []
    body = {"size": 0, "aggs": {"l1": {"nested": {"path": "a"}, "aggs": {
        "l2": {"nested": {"path": "a.b"}, "aggs": {
            "back": {"reverse_nested": {}},
            "up": {"reverse_nested": {"path": "a"}}}}}}}}
    agg = check(nodes, "deep", body)["aggregations"]["l1"]
    assert agg["doc_count"] == 3
    assert agg["l2"]["doc_count"] == 4
    assert agg["l2"]["back"]["doc_count"] == 2
    assert agg["l2"]["up"]["doc_count"] == 3


# test_bulk_preserves_parent_and_update_preserves_join drives Node.bulk
# and IndexService.update_doc, which the port does not have until ROADMAP
# A10 (the write path); it is left out here until then.


def test_has_child_inside_filter_agg(nodes):
    body = {"size": 0, "aggs": {"f": {"filter": {"has_child": {
        "type": "product", "query": {"match": {"item": "shoe"}}}}}}}
    # a match_all with aggs rides the mesh's mask route: its collectors
    # prepare the filter's join over the whole shard, as the host loop's
    assert check(nodes, "shop", body, route="mesh_search")[
        "aggregations"]["f"]["doc_count"] == 1


def test_has_child(nodes):
    q = {"has_child": {"type": "product", "query": {"match": {"item": "red"}}}}
    assert ids(check(nodes, "shop", {"query": q})) == ["p1", "p2"]
    q = {"has_child": {"type": "product",
                       "query": {"match": {"item": "blue"}}}}
    assert ids(check(nodes, "shop", {"query": q})) == ["p1"]


def test_has_child_min_children(nodes):
    q = {"has_child": {"type": "product", "min_children": 2,
                       "query": {"match": {"item": "shoe"}}}}
    assert ids(check(nodes, "shop", {"query": q})) == ["p1"]


def test_has_child_score_mode_sum(nodes):
    q = {"has_child": {"type": "product", "score_mode": "sum",
                       "query": {"match": {"item": "shoe"}}}}
    resp = check(nodes, "shop", {"query": q})
    assert [h["_id"] for h in resp["hits"]["hits"]] == ["p1"]
    assert resp["hits"]["hits"][0]["_score"] > 0


def test_has_parent(nodes):
    q = {"has_parent": {"parent_type": "store",
                        "query": {"match": {"name": "one"}}}}
    assert ids(check(nodes, "shop", {"query": q})) == ["c1", "c2"]


def test_children_agg(nodes):
    body = {"size": 0, "query": {"term": {"_type": "store"}},
            "aggs": {"kids": {"children": {"type": "product"}}}}
    assert check(nodes, "shop", body, route="mesh_search")[
        "aggregations"]["kids"]["doc_count"] == 3


# -- seeded corpora --------------------------------------------------------------

NESTED_BODIES = {
    # Rally nested's randomized-nested-queries shape
    "user_and_date": lambda mode: {"nested": {
        "path": "answers", "score_mode": mode, "query": {"bool": {
            "must": [{"term": {"answers.user": "u1"}}],
            "filter": [{"range": {"answers.date": {
                "gte": T0 + 10 * DAY_MS, "lt": T0 + 60 * DAY_MS}}}]}}}},
    "text": lambda mode: {"nested": {
        "path": "answers", "score_mode": mode,
        "query": {"match": {"answers.text": "quick fox search"}}}},
    "in_bool": lambda mode: {"bool": {
        "must": [{"match": {"title": "the brown"}}],
        "should": [{"nested": {"path": "answers", "score_mode": mode,
                               "query": {"range": {"answers.score": {
                                   "gte": 10}}}}}]}},
}


@pytest.mark.parametrize("mode", ["avg", "sum", "max", "min", "none"])
@pytest.mark.parametrize("name", sorted(NESTED_BODIES))
def test_seeded_nested_queries(nodes, name, mode):
    body = {"query": NESTED_BODIES[name](mode), "size": 30}
    resp = check(nodes, "qa", body,
                 rtol=1e-6 if mode in ("avg", "sum") else 0)
    assert resp["hits"]["total"] > 0


def test_seeded_inner_hits_and_roots_only(nodes):
    q = {"nested": {"path": "answers", "score_mode": "max",
                    "query": {"match": {"answers.text": "quick fox"}},
                    "inner_hits": {"size": 2, "from": 1, "name": "best"}}}
    resp = check(nodes, "qa", {"query": q, "size": 20})
    assert any(h.get("inner_hits") for h in resp["hits"]["hits"])
    # a term on a root field: roots only in hits and in the total
    resp = check(nodes, "qa", {"query": {"match_all": {}}, "size": 500})
    assert resp["hits"]["total"] == 200
    assert all(h["_id"].startswith("q") and "|" not in h["_id"]
               for h in resp["hits"]["hits"])


def test_seeded_nested_aggs(nodes):
    body = {"size": 0, "query": {"term": {"tag": "t1"}}, "aggs": {
        "tags": {"terms": {"field": "tag"}},
        "answers": {"nested": {"path": "answers"}, "aggs": {
            "users": {"terms": {"field": "answers.user", "size": 5},
                      "aggs": {"questions": {"reverse_nested": {}},
                               "top": {"max": {"field": "answers.score"}}}},
            # Rally nested's nested-date-histo
            "per_week": {"date_histogram": {"field": "answers.date",
                                            "interval": "week"}},
            "scores": {"stats": {"field": "answers.score"}}}}}}
    check(nodes, "qa", body)


def test_seeded_nested_sort_and_scroll_roots_only(nodes):
    ref, port = nodes
    q = {"nested": {"path": "answers",
                    "query": {"term": {"answers.user": "u0"}}}}
    check(nodes, "qa", {"query": q, "sort": [{"votes": "desc"}],
                        "size": 15})
    body = {"query": q, "size": 7, "scroll": "1m"}
    want = ref.search("qa", copy.deepcopy(body))
    got = port.search("qa", copy.deepcopy(body))
    assert got["hits"]["total"] == want["hits"]["total"]
    from elasticsearch_tpu.search import service as RS
    from elasticsearch_tpu_torch.search import service as PS

    seen_r, seen_p = [], []
    for r, sid, mod, out in ((want, want["_scroll_id"], RS, seen_r),
                             (got, got["_scroll_id"], PS, seen_p)):
        page = r
        while page["hits"]["hits"]:
            out += [h["_id"] for h in page["hits"]["hits"]]
            page = mod.scroll_next(sid)
        mod.clear_scroll(sid)
    assert seen_p == seen_r
    assert len(seen_p) == got["hits"]["total"]


def test_seeded_terminate_after_and_min_score_roots_only(nodes):
    q = {"nested": {"path": "answers", "score_mode": "sum",
                    "query": {"match": {"answers.text": "the"}}}}
    check(nodes, "qa", {"query": q, "min_score": 1.0, "size": 50})
    check(nodes, "qa", {"query": {"match_all": {}}, "terminate_after": 30,
                        "size": 5})


def test_nested_segment_takes_no_b1_launch(nodes):
    """A pure-dense match on a nested segment runs the generic route with
    its roots-only mask (B1 would score every doc)."""
    _ref, port = nodes
    before = Q.FUSED_CALLS
    check(nodes, "qa", {"query": {"match": {"title": "the"}}, "size": 10})
    assert Q.FUSED_CALLS == before


def test_msearch_declines_a_nested_index(nodes):
    ref, port = nodes
    bodies = [{"query": {"match": {"title": w}}, "size": 5}
              for w in ("the", "quick brown", "fox", "search index")]
    pairs = [({"index": "qa"}, b) for b in bodies]
    kernels.reset()
    got = port.msearch(copy.deepcopy(pairs))["responses"]
    snap = kernels.snapshot()
    assert not snap.get("bm25_fused_topk") and not snap.get("bm25_hybrid")
    want = ref.msearch(copy.deepcopy(pairs))["responses"]
    for g, w, b in zip(got, want, bodies):
        seq = _host(port, "qa", b)
        for r in (g, w):
            r.pop("took", None)
        seq.pop("took")
        assert _strip(g) == _strip(seq)
        _same(g, w, 1e-6)


def test_block_arrays_and_convert(nodes):
    """The port's freeze and a carried-across reference segment hold the
    same block arrays as the reference's segment."""
    ref, port = nodes
    for rsh, psh in zip(ref.indices["qa"].shards, port.indices["qa"].shards):
        for rs, ps in zip(rsh.engine.segments, psh.engine.segments):
            conv = segment_from_arrays(reference_arrays(rs),
                                       Residency(torch.device("cpu")))
            for seg in (ps, conv):
                assert seg.has_nested == rs.has_nested
                if not rs.has_nested:
                    continue
                np.testing.assert_array_equal(seg.parent_id_host,
                                              rs.parent_id_host)
                np.testing.assert_array_equal(seg.root_id_host,
                                              rs.root_id_host)
                np.testing.assert_array_equal(seg.roots_host, rs.roots_host)
                np.testing.assert_array_equal(seg.nested_ord_host,
                                              rs.nested_ord_host)
                assert seg.nested_paths == rs.nested_paths
                for c, a in rs.ancestors_host.items():
                    np.testing.assert_array_equal(seg.ancestors_host[c], a)
                    assert torch.equal(seg.ancestors_dev[c],
                                       torch.from_numpy(a))
                assert seg.block_bytes() > 0


def test_block_bytes_charged_and_released():
    port = Node(name="charge", device="cpu")
    _load_nested(port, "qa", questions(60), QA_MAPPING)
    br = port.breakers.breaker("segments")
    segs = port.indices["qa"].shards[0].engine.segments
    assert br.used >= sum(s.block_bytes() for s in segs) > 0
    port.close()
    assert br.used == 0


def test_force_merge_equals_one_refresh_rebuild():
    docs = questions(80, seed=3)
    merged, once = Node(name="m", device="cpu"), Node(name="o", device="cpu")
    try:
        _load_nested(merged, "qa", docs, QA_MAPPING, every=20)
        merged.indices["qa"].force_merge(1)
        _load_nested(once, "qa", docs, QA_MAPPING)
        a = merged.indices["qa"].shards[0].engine.segments
        b = once.indices["qa"].shards[0].engine.segments
        assert len(a) == len(b) == 1
        a, b = a[0], b[0]
        assert a.ids == b.ids
        for name in ("parent_id_host", "root_id_host", "nested_code_host",
                     "nested_ord_host", "roots_host"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for body in ({"query": NESTED_BODIES["text"]("sum"), "size": 20},
                     {"size": 0, "aggs": {"n": {"nested": {
                         "path": "answers"}, "aggs": {"u": {"terms": {
                             "field": "answers.user"}}}}}}):
            ra, rb = (n.search("qa", copy.deepcopy(body))
                      for n in (merged, once))
            assert _strip(ra) == _strip(rb)
    finally:
        merged.close()
        once.close()


# -- parent/child on the seeded corpus -------------------------------------------

PC_BODIES = {
    "has_child_max": {"has_child": {
        "type": "answer", "score_mode": "max", "min_children": 2,
        "query": {"term": {"user": "u1"}}}},
    "has_child_sum": {"has_child": {
        "type": "answer", "score_mode": "sum", "min_children": 2,
        "max_children": 4, "query": {"match": {"text": "quick fox"}}}},
    "has_child_avg": {"has_child": {
        "type": "answer", "score_mode": "avg",
        "query": {"match": {"text": "the"}}}},
    "has_child_min": {"has_child": {
        "type": "answer", "score_mode": "min",
        "query": {"range": {"score": {"gte": 5}}}}},
    "top_children": {"top_children": {
        "type": "answer", "score": "max",
        "query": {"match": {"text": "search"}}}},
    "has_parent": {"has_parent": {
        "parent_type": "question", "score_mode": "score",
        "query": {"match": {"title": "brown fox"}}}},
    "has_parent_filter": {"has_parent": {
        "type": "question", "query": {"term": {"tag": "t1"}}}},
    "both": {"bool": {"should": [
        {"has_child": {"type": "answer", "score_mode": "sum",
                       "query": {"term": {"user": "u2"}}}},
        {"match": {"title": "quick"}}]}},
}


@pytest.mark.parametrize("name", sorted(PC_BODIES))
def test_seeded_parent_child(nodes, name):
    resp = check(nodes, "qapc", {"query": PC_BODIES[name], "size": 25})
    assert resp["hits"]["total"] > 0


def test_seeded_children_agg_under_terms(nodes):
    body = {"size": 0, "query": {"term": {"_type": "question"}},
            "aggs": {"tags": {"terms": {"field": "tag"}, "aggs": {
                "answers": {"children": {"type": "answer"}, "aggs": {
                    "users": {"terms": {"field": "user", "size": 3}}}}}}}}
    check(nodes, "qapc", body, route="mesh_search")


def test_has_child_in_rescore(nodes):
    body = {"query": {"match": {"title": "the"}}, "size": 10,
            "rescore": {"window_size": 20, "query": {"rescore_query": {
                "has_child": {"type": "answer", "score_mode": "max",
                              "query": {"term": {"user": "u0"}}}},
                "rescore_query_weight": 2.0}}}
    check(nodes, "qapc", body)


def test_pure_dense_match_on_a_parent_child_index_rides_the_mesh(nodes):
    """No nested docs there: a match stays on the mesh (and B1)."""
    ref, port = nodes
    body = {"query": {"match": {"title": "the"}}, "size": 10}
    kernels.reset()
    mesh = port.search("qapc", copy.deepcopy(body))
    assert kernels.snapshot().get("mesh_search") == 1
    host = _host(port, "qapc", body)
    want = ref.search("qapc", copy.deepcopy(body))
    assert [h["_id"] for h in mesh["hits"]["hits"]] == \
        [h["_id"] for h in host["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]


def test_child_type_without_routing_raises(nodes):
    ref, port = nodes
    for node, exc in ((port, RoutingMissingException), (ref, Exception)):
        with pytest.raises(exc) as e:
            node.indices["shop"].index_doc("c9", {"item": "x"},
                                           doc_type="product")
        assert type(e.value).__name__ == "RoutingMissingException"
    # a parent satisfies the check, as in the reference
    port.indices["shop"].index_doc("c9", {"item": "x"}, doc_type="product",
                                   parent="p1")
    port.indices["shop"].delete_doc("c9")
