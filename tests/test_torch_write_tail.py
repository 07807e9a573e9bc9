"""The write tail of the port (``Engine.update``, ``IndexService.update_doc``,
``mget``, ``count``, ``find_doc_locations``, ``Node.bulk`` and
``search/byquery.py``) against the reference on the CPU.

The same writes go to the reference's ``Node`` and the port's; every
answer is compared exactly: update results, the stored sources (each
value's Python type too: an update script's int stays an int, a float
from ``Math`` carries f32 rounding on both), versions, the typed errors
(class name and message), count totals, bulk items one by one, and the
by-query totals and the docs left after them. By-query is driven as the
reference's REST handlers drive it (``rest/server.py::_delete_by_query``
and ``_update_by_query``): a delete or an update as ``apply_fn``, past
the scan window (the reference test's ``scan_ids`` patch), over an id
held on several shards by custom routing, and cancelled between docs.
"""
import copy
import json

import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import byquery as ref_bq
from elasticsearch_tpu.tracing import tasks as ref_tasks
from elasticsearch_tpu.utils.errors import \
    ElasticsearchTpuException as RefError
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import byquery as port_bq
from elasticsearch_tpu_torch.tracing import tasks as port_tasks
from elasticsearch_tpu_torch.utils.errors import (
    ElasticsearchTpuException, TaskCancelledException)

from _torch_parity import corpus

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"}, "n": {"type": "long"},
    "price": {"type": "double"}}}
PC_MAPPING = {"q": {"properties": {"t": {"type": "text"}}},
              "a": {"_parent": {"type": "q"},
                    "properties": {"t": {"type": "text"}}}}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def pair(mapping=MAPPING, shards=2, docs=(), every=None, name="w"):
    """A reference Node and a port Node, each holding index ``name`` with
    the same writes (a refresh every ``every`` docs and at the end)."""
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    for node in (ref, port):
        node.create_index(name, {"settings": {"number_of_shards": shards},
                                 "mappings": mapping})
        svc = node.indices[name]
        for i, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, copy.deepcopy(src))
            if every and i % every == every - 1:
                svc.refresh()
        svc.refresh()
    return ref, port


def _typed(v):
    """A value with each leaf's Python type, so 6 and 6.0 differ."""
    if isinstance(v, dict):
        return {k: _typed(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return [type(v).__name__, v]


def _outcome(fn):
    """(\"ok\", result) or (\"error\", class name, message)."""
    try:
        return ("ok", fn())
    except (ElasticsearchTpuException, RefError) as e:
        return ("error", type(e).__name__, str(e), e.status)


def _same_outcome(ref_fn, port_fn):
    want, got = _outcome(ref_fn), _outcome(port_fn)
    assert json.dumps(_typed(got), sort_keys=True) == \
        json.dumps(_typed(want), sort_keys=True), (got, want)
    return got


def _get(svc, doc_id, routing=None):
    got = svc.get_doc(doc_id, routing=routing)
    return {k: got.get(k) for k in ("_id", "_type", "_version", "_source",
                                    "found")}


# -- Engine.update in every form ------------------------------------------------

BASE = {"n": 5, "price": 2.5, "tag": "t1", "body": "quick fox",
        "obj": {"a": 1, "b": {"c": 2}}}

UPDATES = {
    "partial": {"doc": {"tag": "t9", "extra": [1, 2]}},
    "deep_partial": {"doc": {"obj": {"b": {"d": 3}, "e": "x"}}},
    "script_int": {"script": "ctx._source.n = ctx._source.n + 1"},
    "script_two_statements": {"script": "ctx._source.n = ctx._source.n * 2; "
                                        "ctx._source.tag = 'zz'"},
    "script_params": {"script": {"inline": "ctx._source.price = "
                                           "ctx._source.price + params.d",
                                 "params": {"d": 0.1}}},
    "script_groovy_sibling_params": {
        "script": "ctx._source.n = ctx._source.n + inc",
        "params": {"inc": 4}, "lang": "groovy"},
    "script_math": {"script": "ctx._source.price = Math.sqrt(ctx._source.n)"},
    "script_division": {"script": "ctx._source.price = ctx._source.n / 2"},
    "script_float_param": {"script": {"inline": "ctx._source.n = x * 3",
                                      "params": {"x": 1.1}}},
    "script_bad_lang": {"script": {"inline": "ctx._source.n = 1",
                                   "lang": "python"}},
    "script_bad_target": {"script": "n = 3"},
    "script_unsupported": {"script": "ctx._source.n == 3"},
}


@pytest.mark.parametrize("form", sorted(UPDATES))
def test_update_of_an_existing_doc(form):
    ref, port = pair(docs=[("u1", BASE)])
    body = UPDATES[form]
    _same_outcome(lambda: ref.indices["w"].update_doc("u1", copy.deepcopy(body)),
                  lambda: port.indices["w"].update_doc("u1", copy.deepcopy(body)))
    _same_outcome(lambda: _get(ref.indices["w"], "u1"),
                  lambda: _get(port.indices["w"], "u1"))
    ref.close()
    port.close()


MISSING = {
    "no_upsert": {"doc": {"n": 1}},
    "upsert": {"doc": {"n": 1}, "upsert": {"n": 100, "tag": "new"}},
    "scripted_upsert": {"script": {"inline": "ctx._source.n = "
                                             "ctx._source.n + p",
                                   "params": {"p": 7}},
                        "upsert": {"n": 10}, "scripted_upsert": True},
    "script_upsert_not_scripted": {"script": "ctx._source.n = 0",
                                   "upsert": {"n": 10}},
    "doc_as_upsert": {"doc": {"n": 3, "tag": "d"}, "doc_as_upsert": True},
}


@pytest.mark.parametrize("form", sorted(MISSING))
def test_update_of_a_missing_doc(form):
    ref, port = pair()
    body = MISSING[form]
    _same_outcome(lambda: ref.indices["w"].update_doc("m1", copy.deepcopy(body)),
                  lambda: port.indices["w"].update_doc("m1", copy.deepcopy(body)))
    _same_outcome(lambda: _get(ref.indices["w"], "m1"),
                  lambda: _get(port.indices["w"], "m1"))


@pytest.mark.parametrize("case", ["match", "conflict", "missing_with_upsert",
                                  "external"])
def test_update_versions(case):
    ref, port = pair(docs=[("v1", BASE)])
    body = {"doc": {"n": 9}}
    kw = {"match": {"version": 1}, "conflict": {"version": 7},
          "external": {"version": 5, "version_type": "external"}}.get(case)
    doc_id = "v1"
    if case == "missing_with_upsert":
        body, kw, doc_id = dict(body, upsert={"n": 0}), {"version": 1}, "nope"
    _same_outcome(
        lambda: ref.indices["w"].update_doc(doc_id, copy.deepcopy(body), **kw),
        lambda: port.indices["w"].update_doc(doc_id, copy.deepcopy(body),
                                             **kw))
    _same_outcome(lambda: _get(ref.indices["w"], "v1"),
                  lambda: _get(port.indices["w"], "v1"))


@pytest.mark.parametrize("form", ["partial", "script"])
def test_update_keeps_routing_parent_and_type(form):
    """A child's stored ``_type``, ``_parent`` and routing ride the
    re-index: has_child still joins it, on both packages."""
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    body = {"doc": {"t": "blue whale"}} if form == "partial" else \
        {"script": "ctx._source.t = 'blue whale'"}
    for node in (ref, port):
        node.create_index("pc", {"settings": {"number_of_shards": 3},
                                 "mappings": PC_MAPPING})
        svc = node.indices["pc"]
        svc.index_doc("p1", {"t": "parent"}, doc_type="q")
        svc.index_doc("c1", {"t": "red fish"}, doc_type="a", parent="p1",
                      routing="p1")
        svc.refresh()
        svc.update_doc("c1", copy.deepcopy(body), routing="p1")
        svc.refresh()
    q = {"query": {"has_child": {"type": "a", "query": {
        "match": {"t": "whale"}}}}}
    want, got = ref.search("pc", q), port.search("pc", q)
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]] == ["p1"]
    for node in (ref, port):
        loc = node.indices["pc"].find_doc_location("c1")
        assert (loc.doc_type, loc.parent, loc.routing) == ("a", "p1", "p1")
    _same_outcome(lambda: _get(ref.indices["pc"], "c1", routing="p1"),
                  lambda: _get(port.indices["pc"], "c1", routing="p1"))
    ref.close()
    port.close()


SCRIPT_VALUES = ["1 + 2", "7 / 2", "7.0 / 2", "2 * 3.5", "10 % 4",
                 "Math.sqrt(2)", "Math.log(10)", "Math.pow(2, 10)",
                 "Math.max(3, 9)", "Math.abs(-4)", "x + 1", "x * 0.5",
                 "params.y / 3", "'s' + 't'", "true", "1 > 2",
                 "x > 1 ? 10 : 20"]


@pytest.mark.parametrize("rhs", SCRIPT_VALUES)
def test_update_script_values_keep_type_and_value(rhs):
    """An update script's value has the reference's Python type and
    value (an int stays an int; jnp's f32 rounding where it rounds)."""
    ref, port = pair(docs=[("s1", {"n": 2})], shards=1)
    body = {"script": {"inline": f"ctx._source.v = {rhs}",
                       "params": {"x": 3, "y": 1.25}}}
    _same_outcome(lambda: ref.indices["w"].update_doc("s1", copy.deepcopy(body)),
                  lambda: port.indices["w"].update_doc("s1", copy.deepcopy(body)))
    _same_outcome(lambda: _get(ref.indices["w"], "s1"),
                  lambda: _get(port.indices["w"], "s1"))


# -- mget, count, find_doc_locations --------------------------------------------

DOCS = corpus(160)


@pytest.fixture(scope="module")
def loaded():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = pair(docs=DOCS, every=50)
        for node in (ref, port):
            for i in range(0, 160, 9):
                node.indices["w"].delete_doc(f"d{i}")
    yield ref, port
    ref.close()
    port.close()


def test_mget(loaded):
    ref, port = loaded
    ids = ["d1", "d0", "nope", "d59", "d9", "d150"]
    want = ref.indices["w"].mget(ids)
    got = port.indices["w"].mget(ids)
    for g, w in zip(got["docs"], want["docs"]):
        assert {k: g.get(k) for k in ("_id", "_version", "_source", "found")} \
            == {k: w.get(k) for k in ("_id", "_version", "_source", "found")}


COUNT_QUERIES = {
    "none": None,
    "match": {"match": {"body": "fox"}},
    "term_tag": {"term": {"tag": "t3"}},
    "range": {"range": {"n": {"gte": 0, "lt": 400_000_000}}},
    "bool": {"bool": {"must": [{"match": {"body": "quick"}}],
                      "must_not": [{"term": {"tag": "t1"}}]}},
    "phrase": {"match_phrase": {"body": "the quick"}},
    "match_none": {"match_none": {}},
}


@pytest.mark.parametrize("name", sorted(COUNT_QUERIES))
def test_count_after_deletes(loaded, name):
    ref, port = loaded
    q = COUNT_QUERIES[name]
    body = {} if q is None else {"query": q}
    want = ref.indices["w"].count(copy.deepcopy(body))
    got = port.indices["w"].count(copy.deepcopy(body))
    assert got == want
    s = port.search("w", dict(body, size=0))
    assert s["hits"]["total"] == got["count"]


def test_count_sees_roots_only():
    mapping = {"properties": {"c": {"type": "nested", "properties": {
        "w": {"type": "keyword"}}}}}
    docs = [(str(i), {"c": [{"w": "a"}, {"w": "b"}] * (i % 3)})
            for i in range(30)]
    ref, port = pair(mapping=mapping, docs=docs, shards=2)
    for body in ({}, {"query": {"nested": {"path": "c", "query": {
            "term": {"c.w": "a"}}}}}):
        assert port.indices["w"].count(body) == ref.indices["w"].count(body)
    assert port.indices["w"].count({})["count"] == 30


def test_find_doc_locations_over_custom_routing():
    """One id written under two routings lives on two shards: every live
    copy is found, each with its routing."""
    ref, port = pair(shards=4)
    for node in (ref, port):
        svc = node.indices["w"]
        for r in ("r1", "r2", "r3"):
            svc.index_doc("dup", {"tag": r}, routing=r)
    routes = []
    for node in (ref, port):
        locs = node.indices["w"].find_doc_locations("dup")
        routes.append(sorted(loc.routing for loc in locs))
        assert node.indices["w"].find_doc_location("gone") is None
    assert routes[0] == routes[1] and len(routes[0]) >= 2


# -- Node.bulk ---------------------------------------------------------------------

def _bulk_ops():
    ops = []
    for i in range(12):
        ops += [{"index": {"_index": "b", "_id": f"x{i}"}},
                {"tag": f"t{i % 3}", "n": i, "body": "quick brown fox"}]
    ops += [
        {"create": {"_index": "b", "_id": "x1"}}, {"n": 1},  # exists
        {"create": {"_index": "b", "_id": "y1"}}, {"n": 2},
        {"update": {"_index": "b", "_id": "x2"}}, {"doc": {"n": 200}},
        {"update": {"_index": "b", "_id": "x3"}},
        {"script": "ctx._source.n = ctx._source.n + 30"},
        {"update": {"_index": "b", "_id": "ghost"}}, {"doc": {"n": 1}},
        {"update": {"_index": "b", "_id": "ghost2"}},
        {"doc": {"n": 5}, "doc_as_upsert": True},
        {"delete": {"_index": "b", "_id": "x4"}},
        {"delete": {"_index": "b", "_id": "never"}},
        {"index": {"_index": "b", "_id": "x5", "_routing": "k"}}, {"n": 55},
        {"index": {"_index": "auto", "_id": "z"}}, {"n": 1},
        {"index": {"_index": "b", "_id": "x6"}}, {"n": "not a number"},
        {"index": {"_index": "b", "_id": "x7"}}, {"n": 7},
        {"delete": {"_index": "b", "_id": "x7"}},
        {"index": {"_index": "b", "_id": "x7"}}, {"n": 77},
    ]
    return ops


def _item_view(item):
    (op, r), = item.items()
    keep = ("_index", "_id", "_version", "status", "error", "result",
            "created", "_type")
    return {op: {k: r.get(k) for k in keep if k in r}}


def test_bulk_item_by_item():
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    for node in (ref, port):
        node.create_index("b", {"settings": {"number_of_shards": 3},
                                "mappings": {"properties": {
                                    "n": {"type": "long"},
                                    "tag": {"type": "keyword"}}}})
    want = ref.bulk(_bulk_ops())
    got = port.bulk(_bulk_ops())
    assert got["errors"] is want["errors"] is True
    assert len(got["items"]) == len(want["items"])
    for g, w in zip(got["items"], want["items"]):
        assert _item_view(g) == _item_view(w), (g, w)
    assert "auto" in port.indices
    for node in (ref, port):
        node.indices["b"].refresh()
    for i in list(range(8)) + ["y1", "ghost2"]:
        doc_id = f"x{i}" if isinstance(i, int) else i
        routing = "k" if doc_id == "x5" else None
        _same_outcome(lambda: _get(ref.indices["b"], doc_id, routing),
                      lambda: _get(port.indices["b"], doc_id, routing))
    assert port.indices["b"].count({})["count"] == \
        ref.indices["b"].count({})["count"]
    ref.close()
    port.close()


def test_bulk_routes_a_child_by_its_parent():
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    ops = [{"index": {"_index": "pc", "_id": "p1", "_type": "q"}},
           {"t": "parent"},
           {"index": {"_index": "pc", "_id": "c1", "_type": "a",
                      "parent": "p1"}}, {"t": "child"},
           {"index": {"_index": "pc", "_id": "c2", "_type": "a"}},
           {"t": "orphan"}]
    for node in (ref, port):
        node.create_index("pc", {"settings": {"number_of_shards": 3},
                                 "mappings": PC_MAPPING})
    want, got = ref.bulk(copy.deepcopy(ops)), port.bulk(copy.deepcopy(ops))
    assert [_item_view(i) for i in got["items"]] == \
        [_item_view(i) for i in want["items"]]
    assert got["items"][2]["index"]["error"]["type"] == \
        "routing_missing_exception"
    for node in (ref, port):
        node.indices["pc"].refresh()
    q = {"query": {"has_child": {"type": "a", "query": {"match_all": {}}}}}
    assert [h["_id"] for h in port.search("pc", q)["hits"]["hits"]] == \
        [h["_id"] for h in ref.search("pc", q)["hits"]["hits"]] == ["p1"]
    ref.close()
    port.close()


# -- by-query -----------------------------------------------------------------------

def _delete_by_query(svc, bq, query):
    """The reference's REST delete-by-query handler, without its task
    registry: every live copy of each match deleted by its routing."""
    svc.refresh()
    counts = {"deleted": 0}
    failures, processed = [], set()

    def apply(doc_id, loc):
        processed.add(doc_id)
        try:
            svc.delete_doc(doc_id, routing=loc.routing if loc else None)
            counts["deleted"] += 1
        except Exception as e:
            if not hasattr(e, "error_type"):
                raise
            failures.append(bq.failure_entry(svc.name, doc_id, e))

    bq.run_by_query(svc, query, apply)
    return {"deleted": counts["deleted"], "total": len(processed),
            "failures": failures}


def _update_by_query(svc, bq, query, script, params=None):
    svc.refresh()
    counts = {"updated": 0}
    failures, processed = [], set()

    def apply(doc_id, loc):
        processed.add(doc_id)
        try:
            svc.update_doc(doc_id, {"script": script, "params": params},
                           routing=loc.routing if loc else None)
            counts["updated"] += 1
        except Exception as e:
            if not hasattr(e, "error_type"):
                raise
            failures.append(bq.failure_entry(svc.name, doc_id, e))

    bq.run_by_query(svc, query, apply)
    return {"updated": counts["updated"], "total": len(processed),
            "failures": failures}


def _state(node, index):
    svc = node.indices[index]
    svc.refresh()
    r = node.search(index, {"query": {"match_all": {}}, "size": 1000})
    return sorted((h["_id"], json.dumps(h["_source"], sort_keys=True))
                  for h in r["hits"]["hits"]), r["hits"]["total"]


@pytest.mark.parametrize("shards", [1, 3])
def test_delete_by_query(shards):
    ref, port = pair(docs=DOCS, shards=shards, every=40)
    q = {"term": {"tag": "t2"}}
    want = _delete_by_query(ref.indices["w"], ref_bq, q)
    got = _delete_by_query(port.indices["w"], port_bq, q)
    assert got == want and got["deleted"] > 0
    assert _state(port, "w") == _state(ref, "w")
    assert port.indices["w"].count({"query": q})["count"] == 0
    ref.close()
    port.close()


@pytest.mark.parametrize("shards", [1, 3])
def test_update_by_query(shards):
    ref, port = pair(docs=DOCS, shards=shards, every=40)
    q = {"match": {"body": "fox"}}
    script, params = "ctx._source.n = ctx._source.price * k", {"k": 2}
    want = _update_by_query(ref.indices["w"], ref_bq, q, script, params)
    got = _update_by_query(port.indices["w"], port_bq, q, script, params)
    assert got == want and got["updated"] > 0
    assert _state(port, "w") == _state(ref, "w")
    ref.close()
    port.close()


def test_by_query_failures_are_entries():
    """An update that fails on some docs (a script over a missing field)
    reports each as a failure entry, the rest applied."""
    docs = [(f"f{i}", {"n": i} if i % 2 else {"tag": "t"}) for i in range(10)]
    ref, port = pair(docs=docs, shards=2)
    script = "ctx._source.n = ctx._source.n + 1"
    want = _update_by_query(ref.indices["w"], ref_bq, None, script)
    got = _update_by_query(port.indices["w"], port_bq, None, script)
    assert got == want
    assert _state(port, "w") == _state(ref, "w")


def test_by_query_past_the_scan_window(monkeypatch):
    """More matches than one scan page: the loop rescans until dry (the
    reference test's ``scan_ids`` patch, three hits a page)."""
    ref, port = pair(docs=DOCS[:40], shards=2)
    calls = {}

    def tiny(bq):
        def scan(svc, query, seen):
            calls[bq] = calls.get(bq, 0) + 1
            resp = svc.search({"query": query or {"match_all": {}},
                               "size": 3, "_source": False})
            return [h["_id"] for h in resp["hits"]["hits"]
                    if h["_id"] not in seen]
        return scan

    for bq in (ref_bq, port_bq):
        monkeypatch.setattr(bq, "scan_ids", tiny(bq))
    want = _delete_by_query(ref.indices["w"], ref_bq, None)
    got = _delete_by_query(port.indices["w"], port_bq, None)
    assert got == want and got["deleted"] == 40
    assert calls[port_bq] == calls[ref_bq] >= 14
    assert port.indices["w"].num_docs == 0


def test_by_query_over_an_id_on_several_shards():
    ref, port = pair(shards=4)
    for node in (ref, port):
        svc = node.indices["w"]
        for r in ("r1", "r2", "r3", "r4"):
            svc.index_doc("dup", {"tag": "x", "n": 1}, routing=r)
        svc.index_doc("solo", {"tag": "x", "n": 2})
    q = {"term": {"tag": "x"}}
    want = _update_by_query(ref.indices["w"], ref_bq, q,
                            "ctx._source.n = ctx._source.n + 10")
    got = _update_by_query(port.indices["w"], port_bq, q,
                           "ctx._source.n = ctx._source.n + 10")
    assert got == want
    assert _state(port, "w") == _state(ref, "w")
    want = _delete_by_query(ref.indices["w"], ref_bq, q)
    got = _delete_by_query(port.indices["w"], port_bq, q)
    assert got == want and got["total"] == 2
    assert port.indices["w"].num_docs == ref.indices["w"].num_docs == 0


def test_by_query_cancelled_between_docs():
    """A task cancelled inside the third apply stops the loop at the next
    checkpoint: three docs deleted, the rest kept, on both packages."""
    ref, port = pair(docs=DOCS[:30], shards=2)
    out = []
    for node, bq, tasks, exc in (
            (ref, ref_bq, ref_tasks, ref_tasks.TaskCancelledException),
            (port, port_bq, port_tasks, TaskCancelledException)):
        svc = node.indices["w"]
        task = tasks.Task(1, "n", "indices:data/write/delete/byquery")
        done = []

        def apply(doc_id, loc, svc=svc, task=task, done=done):
            svc.delete_doc(doc_id, routing=loc.routing if loc else None)
            done.append(doc_id)
            if len(done) == 3:
                task.cancel()

        token = tasks.set_current(task)
        try:
            with pytest.raises(exc, match="was cancelled"):
                bq.run_by_query(svc, None, apply)
        finally:
            tasks.reset_current(token)
        out.append((done, svc.num_docs))
    assert out[0] == out[1] and out[1][1] == 27
    assert port_tasks.current_task() is None
    port_tasks.check_cancelled()  # no task: a no-op
