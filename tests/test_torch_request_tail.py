"""The request tail of the PyTorch port against the reference, on the CPU:
``min_score``, ``terminate_after``, ``timeout``, ``scroll`` and ``search_type:
scan`` (``scroll_next``, ``clear_scroll``), ``highlight`` and ``profile``.

Inputs: ``tests/_torch_parity.py::corpus`` (a text body, a keyword, a
long and a double), 240 docs indexed by both packages into three shards
of two segments. Responses are compared as whole JSON apart from
``took``, ``_scroll_id`` and the profile's timings; scores at the
generic path's bar (rtol 1e-5, as ``test_torch_mesh.py``). ``timeout``
runs on a clock patched in both packages (each call one second later),
so the segment that is cut is the same every run.
"""
import copy
import json
import threading

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import service as ref_service
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import scoring
from elasticsearch_tpu_torch.parallel import executor as port_executor
from elasticsearch_tpu_torch.search import service
from elasticsearch_tpu_torch.utils.errors import (
    SearchContextMissingException, SearchParseException)

from _torch_parity import MAPPING, corpus

N_DOCS = 240
QUERY = {"match": {"body": "quick brown fox lazy river"}}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _load(ref, port, name, docs, shards=3):
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": MAPPING}
    ref.create_index(name, copy.deepcopy(body))
    port.create_index(name, copy.deepcopy(body))
    half = len(docs) // 2
    for part in (docs[:half], docs[half:]):
        for doc_id, src in part:
            ref.indices[name].index_doc(doc_id, copy.deepcopy(src))
            port.index(name, doc_id, copy.deepcopy(src))
        ref.indices[name].refresh()
        port.refresh(name)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref")
        port = Node(name="port", device="cpu")
        _load(ref, port, "r", corpus(N_DOCS, seed=9))
    yield ref, port
    ref.close()
    port.close()


def _scores(resp):
    return np.array([np.nan if h["_score"] is None else h["_score"]
                     for h in resp["hits"]["hits"]], np.float64)


def _strip(resp):
    """JSON-equal copy without ``took``, ``_scroll_id``, the scores (held
    apart at rtol 1e-5) and the profile's timings."""
    r = json.loads(json.dumps(resp))
    r.pop("took", None)
    r.pop("_scroll_id", None)
    if r["hits"].get("max_score") is not None:
        r["hits"]["max_score"] = 0.0
    for h in r["hits"]["hits"]:
        if h["_score"] is not None:
            h["_score"] = 0.0
    r.pop("profile", None)
    return r


def _same(p, r):
    assert _strip(p) == _strip(r)
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=1e-5)


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _search(node, body, index="r"):
    return node.search(index, copy.deepcopy(body))


# -- min_score, terminate_after, timeout ------------------------------------

HOST_KEYS = {
    "min_score": {"query": QUERY, "min_score": 2.5, "size": 30},
    "min_score_paged": {"query": QUERY, "min_score": 4.0, "size": 8,
                        "from": 4},
    "min_score_sorted": {"query": QUERY, "min_score": 3.0,
                         "sort": [{"n": "desc"}], "size": 12},
    "terminate_after": {"query": QUERY, "terminate_after": 5, "size": 20},
    "terminate_after_unreached": {"query": QUERY, "terminate_after": 5000},
    "terminate_after_sorted": {"terminate_after": 30, "size": 15,
                               "sort": ["tag", {"price": "asc"}]},
}


@pytest.mark.parametrize("name", sorted(HOST_KEYS))
def test_host_loop_keys_match_reference(nodes, name):
    ref, port = nodes
    body = HOST_KEYS[name]
    kernels.reset()
    p = _search(port, body)
    # these keys keep the request on the host loop, as in the reference
    assert kernels.snapshot().get("mesh_fallback_total") == 1
    r = _search(ref, body)
    _same(p, r)
    if name == "terminate_after":
        assert p["terminated_early"] is True and p["hits"]["total"] == 15
    if "min_score" in body:
        assert min(_scores(p), default=np.inf) >= body["min_score"] \
            or "sort" in body


class _Tick:
    """A clock one second later at every call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_timeout_cuts_at_the_second_segment(nodes, monkeypatch):
    """Both clocks patched: every shard checks the clock before each of
    its two segments, so the first runs and the second is cut."""
    ref, port = nodes
    body = {"query": QUERY, "timeout": "1500ms", "size": 50}
    full = _search(port, dict(body, timeout="1h"))
    monkeypatch.setattr(service, "_clock", _Tick())
    p = _search(port, body)

    class _Time:
        perf_counter = staticmethod(_Tick())

    monkeypatch.setattr(ref_service, "time", _Time)
    r = _search(ref, body)
    assert p["timed_out"] is True and not full["timed_out"]
    assert 0 < p["hits"]["total"] < full["hits"]["total"]
    _same(p, r)


# -- scroll and scan ----------------------------------------------------------

def _drain(node, body, scroll_next, index="r", size=None):
    first = node.search(index, copy.deepcopy(body))
    pages = [first]
    for _ in range(200):
        page = scroll_next(first["_scroll_id"], size)
        if not page["hits"]["hits"]:
            break
        pages.append(page)
    return pages


SCROLLS = {
    "scores": {"query": QUERY, "scroll": "1m", "size": 7},
    "scan": {"query": QUERY, "scroll": "1m", "search_type": "scan",
             "size": 11},
    "scan_ignores_sort": {"query": {"match_all": {}}, "scroll": "1m",
                          "search_type": "scan", "sort": ["n"],
                          "size": 40},
    "sorted": {"query": QUERY, "scroll": "1m", "size": 9,
               "sort": ["tag", {"n": "desc"}]},
}


@pytest.mark.parametrize("name", sorted(SCROLLS))
def test_scroll_pages_match_reference_to_the_end(nodes, name):
    ref, port = nodes
    body = SCROLLS[name]
    got = _drain(port, body, service.scroll_next)
    want = _drain(ref, body, ref_service.scroll_next)
    assert len(got) == len(want)
    for p, r in zip(got, want):
        _same(p, r)
    ids = [i for page in got for i in _ids(page)]
    assert len(ids) == len(set(ids)) == got[0]["hits"]["total"]
    if body.get("search_type") == "scan":
        assert got[0]["hits"]["hits"] == []
    service.clear_scroll(got[0]["_scroll_id"])
    ref_service.clear_scroll(want[0]["_scroll_id"])


@pytest.mark.parametrize("sort", [None, ["tag", {"price": "desc"}]])
def test_scroll_is_a_point_in_time(sort):
    """A write and a delete after a scroll opens leave its pages as they
    were: the same as a scroll drained before them."""
    port = Node(name="pit", device="cpu")
    try:
        body = {"settings": {"index": {"number_of_shards": 2}},
                "mappings": MAPPING}
        port.create_index("p", body)
        for doc_id, src in corpus(120, seed=4):
            port.index("p", doc_id, src)
        port.refresh("p")
        q = {"query": QUERY, "scroll": "1m", "size": 6}
        if sort:
            q["sort"] = sort
        before = _drain(port, q, service.scroll_next, index="p")
        opened = port.search("p", copy.deepcopy(q))
        victim = _ids(before[-1])[0]
        port.delete("p", victim)
        port.index("p", "new", {"body": "quick brown fox river lazy",
                                "tag": "t0", "n": 5, "price": 1.0})
        port.refresh("p")
        pages = [opened]
        while True:
            page = service.scroll_next(opened["_scroll_id"])
            if not page["hits"]["hits"]:
                break
            pages.append(page)
        assert [_strip(p) for p in pages] == [_strip(p) for p in before]
        # a new search sees both writes
        now = [i for p in _drain(port, q, service.scroll_next, index="p")
               for i in _ids(p)]
        assert "new" in now and victim not in now
    finally:
        port.close()


def test_clear_scroll(nodes):
    _ref, port = nodes
    first = _search(port, {"query": QUERY, "scroll": "1m", "size": 3})
    sid = first["_scroll_id"]
    assert service.scroll_state(sid)["total"] == first["hits"]["total"]
    assert service.scroll_next(sid, size=2)["hits"]["hits"]
    assert service.clear_scroll(sid) is True
    assert service.scroll_state(sid) is None
    with pytest.raises(SearchContextMissingException):
        service.scroll_next(sid)
    assert service.clear_scroll(sid) is False


# -- highlight ----------------------------------------------------------------

HIGHLIGHTS = {
    "default": {"query": QUERY, "highlight": {"fields": {"body": {}}},
                "size": 12},
    "tags_and_sizes": {"query": {"bool": {
        "must": [{"match": {"body": "river"}}],
        "should": [{"term": {"body": "fox"}}]}}, "highlight": {
            "pre_tags": ["<b>"], "post_tags": ["</b>"],
            "fields": {"body": {"fragment_size": 20,
                                "number_of_fragments": 2}}}, "size": 9},
    "whole_field_sorted": {"query": QUERY, "sort": [{"price": "desc"}],
                           "highlight": {"fields": {
                               "body": {"number_of_fragments": 0},
                               "tag": {}}}, "size": 8},
}


@pytest.mark.parametrize("route", ["mesh", "host"])
@pytest.mark.parametrize("name", sorted(HIGHLIGHTS))
def test_highlight_matches_reference(nodes, name, route, monkeypatch):
    ref, port = nodes
    body = HIGHLIGHTS[name]
    if route == "host":
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    p = _search(port, body)
    assert bool(kernels.snapshot().get("mesh_search")) == (route == "mesh")
    r = _search(ref, body)
    _same(p, r)
    frags = [h.get("highlight") for h in p["hits"]["hits"]]
    assert any(frags) and frags == [h.get("highlight")
                                    for h in r["hits"]["hits"]]


# -- script_fields ---------------------------------------------------------------

SCRIPT_FIELDS = {
    "page": {"query": QUERY, "size": 40, "script_fields": {
        "twice": {"script": "doc['price'].value * 2"},
        "n_k": {"script": {"inline": "doc['n'].value / params.d",
                           "params": {"d": 1000}}}}},
    "paged_from": {"query": QUERY, "size": 10, "from": 25,
                   "script_fields": {"cut": {"script": {
                       "source": "doc['price'].value > 50 ? 1 : 0"}}}},
    "with_fields": {"query": QUERY, "size": 12, "fields": ["tag"],
                    "script_fields": {"len": {"script":
                                              "doc['body'].value + 1"}}},
    "sorted": {"query": QUERY, "size": 15, "sort": [{"price": "desc"}],
               "script_fields": {"ord": {"script": "doc['tag'].value"}}},
    "constant": {"size": 5, "script_fields": {"c": {"script": "2 + 3"},
                                              "b": {"script": "1 > 0"}}},
}


@pytest.mark.parametrize("route", ["mesh", "host"])
@pytest.mark.parametrize("name", sorted(SCRIPT_FIELDS))
def test_script_fields_match_reference(nodes, name, route, monkeypatch):
    """Pages across both segments of each shard; one script run a
    (segment, field), on either route."""
    ref, port = nodes
    body = SCRIPT_FIELDS[name]
    if route == "host":
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    p = _search(port, body)
    assert bool(kernels.snapshot().get("mesh_search")) == (route == "mesh")
    r = _search(ref, body)
    _same(p, r)
    assert all("fields" in h for h in p["hits"]["hits"])
    if name == "page":  # each shard's first and second refresh
        ids = {int(h["_id"][1:]) for h in p["hits"]["hits"]}
        assert min(ids) < N_DOCS // 2 <= max(ids)


# -- profile ------------------------------------------------------------------

def _shape(x):
    """The key structure of a JSON value (lists by their elements')."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return None


@pytest.mark.parametrize("body", [
    {"query": QUERY, "profile": True, "size": 5},
    {"query": QUERY, "profile": True, "sort": ["tag"], "size": 5},
])
def test_profile_envelope_matches_reference(nodes, body):
    ref, port = nodes
    p, r = _search(port, body), _search(ref, body)
    _same(p, r)
    assert _shape(p["profile"]) == _shape(r["profile"])
    for ps, rs in zip(p["profile"]["shards"], r["profile"]["shards"]):
        assert ps["id"] == rs["id"]
        assert ps["tpu"]["segments"] == rs["tpu"]["segments"] == 2
        # first-touch events of the port, jit traces of the reference
        assert isinstance(ps["tpu"]["retraces"], int) \
            and ps["tpu"]["retraces"] >= 0
        assert all(isinstance(v, int) and v >= 0
                   for v in ps["tpu"]["phases"].values())
    assert p["profile"]["shards"][0]["tpu"]["phases"][
        "device_execute_nanos"] > 0


def test_profile_on_a_coalesced_search(nodes):
    """A parked profile body runs on its own thread at the flush; its
    response reports the queue wait, batch size and flush reason."""
    _ref, port = nodes
    port.serving.apply_cluster_settings({
        "serving.coalescer.mode": "always",
        "serving.coalescer.max_wait": "20ms",
        "serving.coalescer.idle_gap": "5ms"})
    try:
        body = {"query": {"match": {"body": "fox"}}, "profile": True,
                "size": 4}
        out = {}

        def run(i):
            out[i] = _search(port, body)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(out) == 3
        for resp in out.values():
            co = resp["profile"]["coalescer"]
            assert set(co) == {"queue_wait_nanos", "batch_size",
                               "flush_reason"}
            assert co["batch_size"] == 1 and co["queue_wait_nanos"] >= 0
            assert co["flush_reason"] in ("full", "deadline", "idle")
            assert _strip(resp) == _strip(_search(port, dict(
                body, profile=False)))
    finally:
        port.serving.apply_cluster_settings({})


# -- refusals and faults --------------------------------------------------------

@pytest.mark.parametrize("body, item", [
    ({"post_filter": {"term": {"tag": "t1"}}}, "A6c"), ({"explain": True}, "A6c"),
    ({"track_scores": True}, "A6c"), ({"stats": ["g"]}, None),
    ({"search_type": "count"}, "A6c"),
    ({"stats": ["g"], "suggest": {}}, None),
])
def test_remaining_keys_are_refused_by_their_queue_item(nodes, body, item):
    """A refused key names its queue item; ``stats`` (item None) is served
    since A10b, with ``suggest`` beside it (A9d): the hits equal the
    reference's and the port's own answer without the key."""
    ref, port = nodes
    if item is None:
        got = _search(port, dict(body, query=QUERY))
        want = _search(ref, dict(body, query=QUERY))
        plain = _search(port, {"query": QUERY})
        for other in (want, plain):
            assert got["hits"]["total"] == other["hits"]["total"]
            assert [h["_id"] for h in got["hits"]["hits"]] == \
                [h["_id"] for h in other["hits"]["hits"]]
        assert ("suggest" in got) == ("suggest" in want)
        return
    with pytest.raises(SearchParseException) as e:
        _search(port, dict(body, query=QUERY))
    assert f"ROADMAP {item}" in str(e.value)
    assert "suggest" not in str(e.value)  # served since A9d


@pytest.mark.parametrize("suggest", [
    {}, {"s": {"text": "quikc", "term": {"field": "body"}}}])
def test_suggest_key_is_served(nodes, suggest):
    """``suggest`` is served (A9d): the response equals the reference's,
    hits and suggestions."""
    ref, port = nodes
    body = {"query": QUERY, "suggest": suggest}
    want, got = _search(ref, body), _search(port, body)
    assert _strip(got) == _strip(want)
    assert got.get("suggest") == want.get("suggest")
    assert ("suggest" in got) == bool(suggest)


@pytest.mark.parametrize("key, value", [
    ("min_score", 0), ("timeout", 0), ("terminate_after", 0),
    ("profile", False), ("search_after", [])])
def test_present_host_keys_keep_the_host_loop(nodes, key, value):
    """A host-only key keeps the request off the mesh when present at all
    (a falsy ``min_score`` still filters); ``profile: false`` does not."""
    _ref, port = nodes
    body = {"query": QUERY, "size": 5, key: value}
    if key == "search_after":
        body["sort"] = ["n"]
    kernels.reset()
    try:
        _search(port, body)
    except SearchParseException:
        assert key == "search_after"  # the host loop's length check
    snap = kernels.snapshot()
    assert bool(snap.get("mesh_search")) == (key == "profile"), snap


def test_scan_needs_a_scroll(nodes):
    _ref, port = nodes
    with pytest.raises(SearchParseException):
        _search(port, {"query": QUERY, "search_type": "scan"})


@pytest.mark.parametrize("route", ["mesh", "host"])
def test_a_device_fault_in_the_sort_selection_raises(nodes, route,
                                                     monkeypatch):
    """A fault inside ``sort_topk`` fails the request on either route:
    the mesh does not retry it on the host loop."""
    _ref, port = nodes
    calls = {"mesh": 0, "host": 0}

    def fault(where):
        def run(*a, **k):
            calls[where] += 1
            raise RuntimeError("device fault in the sort selection")
        return run

    monkeypatch.setattr(port_executor, "sort_topk", fault("mesh"))
    monkeypatch.setattr(scoring, "sort_topk", fault("host"))
    if route == "host":
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    with pytest.raises(RuntimeError, match="device fault"):
        _search(port, {"query": QUERY, "sort": ["tag"], "size": 5})
    assert calls == ({"mesh": 1, "host": 0} if route == "mesh"
                     else {"mesh": 0, "host": 1})
    assert not kernels.snapshot().get("mesh_fallback_total")
