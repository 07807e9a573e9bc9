"""Merges (``index/merge.py``, ``Engine.merge``), the mesh round's cut
and ``_name``: the port against the reference, on both routes.

- The mesh round keeps up to ``min(k, S * kk)`` candidates over its S
  slots, so a deep page past one segment's padded width comes back full.
  The oracle is the reference's host loop; the reference's own mesh keeps
  ``kk`` over all slots and answers short (a reference fault, pinned).
- The same writes and refreshes give both packages the same segment
  layout (the tiered policy's tier merges and delete-reclaim merges, and
  ``force_merge``), so idf, hits and scores agree on both routes.
- A merged shard answers byte for byte as a shard that took the same
  live docs in one refresh, fed in the merged segment's order.
- A merge leaves nothing retired in the mesh executor's caches, and the
  ``segments`` and ``fielddata`` breakers hold the live segments' bytes.
- ``_name`` gives ``matched_queries`` on both routes.

Bars: the generic route's (the same ids in order, ``hits.total`` exact,
scores within 1e-5); port against port, identical responses apart from
``took``.
"""
import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node

from _torch_parity import MAPPING, corpus


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _create(node, name, shards, mapping=MAPPING):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})


def _pair(docs, shards, every=None):
    """A reference and a port node holding ``docs`` in index ``i``, with
    a refresh every ``every`` docs and one at the end."""
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    for node in (ref, port):
        _create(node, "i", shards)
    feed(ref, port, docs, every)
    return ref, port


def feed(ref, port, docs, every=None):
    for j, (doc_id, src) in enumerate(docs):
        ref.indices["i"].index_doc(doc_id, copy.deepcopy(src))
        port.index("i", doc_id, copy.deepcopy(src))
        if every and (j + 1) % every == 0:
            ref.indices["i"].refresh()
            port.refresh("i")
    ref.indices["i"].refresh()
    port.refresh("i")


def _layout(node):
    return [[seg.num_docs for seg in s.segments]
            for s in node.indices["i"].shards]


def _search(node, body, host=False, monkeypatch=None):
    if host:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    try:
        return node.search("i", copy.deepcopy(body))
    finally:
        if host:
            monkeypatch.delenv("ESTPU_DISABLE_MESH")


def _hold(got, want, what):
    """The generic route's bar."""
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"], what
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh], what
    gs = [h["_score"] for h in gh]
    ws = [h["_score"] for h in wh]
    if None not in gs + ws:
        np.testing.assert_allclose(gs, ws, rtol=1e-5, err_msg=what)
    else:
        assert gs == ws, what


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


QUERIES = {"match_all": {"match_all": {}},
           "range": {"range": {"price": {"gte": 0}}}}


# -- C1: the mesh round's cut ------------------------------------------------

@pytest.fixture(scope="module")
def deep():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = _pair(corpus(300), 2)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("frm", [250, 290])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_deep_page_on_the_mesh_is_full(deep, query, frm, monkeypatch):
    ref, port = deep
    body = {"query": QUERIES[query], "from": frm, "size": 10}
    want = _search(ref, body, host=True, monkeypatch=monkeypatch)
    kernels.reset()
    got = _search(port, body)
    assert kernels.snapshot().get("mesh_search") == 1
    _hold(got, want, f"{query} from {frm}")
    assert len(got["hits"]["hits"]) == max(0, min(
        10, got["hits"]["total"] - frm))
    assert _strip(got) == _strip(_search(port, body, host=True,
                                         monkeypatch=monkeypatch))


def test_reference_mesh_cuts_a_deep_page(deep, monkeypatch):
    """Reference fault (ROADMAP C): the reference's mesh keeps
    ``kk = min(k, D)`` candidates over all of a round's slots, so
    ``match_all`` at ``from`` 290 of 300 docs on two shards of 256-doc
    segments comes back empty on its mesh and full on its host loop."""
    ref, _port = deep
    body = {"query": {"match_all": {}}, "from": 290, "size": 10}
    assert len(_search(ref, body)["hits"]["hits"]) == 0
    assert len(_search(ref, body, host=True, monkeypatch=monkeypatch)[
        "hits"]["hits"]) == 10


def test_msearch_deep_page_on_the_mesh_is_full(monkeypatch):
    """``_msearch``'s mesh round (``search_terms``) keeps the same cut."""
    ref, port = _pair(corpus(480), 2)
    try:
        bodies = [{"query": {"match": {"body": q}}, "from": 290, "size": 10}
                  for q in ("quick brown fox jumps",
                            "quick brown fox jumps over lazy",
                            "brown fox jumps over lazy dog search")]
        kernels.reset()
        got = port.msearch([({"index": "i"}, copy.deepcopy(b))
                            for b in bodies])["responses"]
        assert kernels.snapshot().get("mesh_msearch") == 1
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
        want = ref.msearch([({"index": "i"}, copy.deepcopy(b))
                            for b in bodies])["responses"]
        for b, g, w in zip(bodies, got, want):
            assert w["hits"]["total"] > 300, b
            assert len(g["hits"]["hits"]) == 10, b
            _hold(g, w, json.dumps(b))
    finally:
        ref.close()
        port.close()


# -- C2: merges ------------------------------------------------------------

C2_BODIES = {"match": {"query": {"match": {"body": "fox dog"}}, "size": 20},
             "term": {"query": {"term": {"tag": "t1"}}, "size": 20},
             "deep": {"query": {"match": {"body": "river lazy"}},
                      "from": 15, "size": 10}}


def _hold_routes(ref, port, monkeypatch, what):
    for name, body in C2_BODIES.items():
        _hold(_search(port, body), _search(ref, body), f"{what} {name} mesh")
        _hold(_search(port, body, True, monkeypatch),
              _search(ref, body, True, monkeypatch), f"{what} {name} host")


@pytest.fixture(scope="module")
def tiered():
    """corpus(400), two shards, a refresh every 50 docs: eight segments a
    shard, which the tier policy folds into one."""
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = _pair(corpus(400), 2, every=50)
    yield ref, port
    ref.close()
    port.close()


def test_tier_merge_layout_matches_the_reference(tiered):
    ref, port = tiered
    assert _layout(port) == _layout(ref)
    assert all(len(s) == 1 for s in _layout(port))
    for s in port.indices["i"].shards:
        assert s.engine.stats.merge_total == 1


@pytest.mark.parametrize("name", sorted(C2_BODIES))
@pytest.mark.parametrize("route", ["mesh", "host"])
def test_merged_hits_and_scores_match_the_reference(tiered, name, route,
                                                    monkeypatch):
    ref, port = tiered
    host = route == "host"
    body = C2_BODIES[name]
    _hold(_search(port, body, host, monkeypatch),
          _search(ref, body, host, monkeypatch), f"{name} {route}")


def test_delete_reclaim_merge_matches_the_reference(monkeypatch):
    """More than 25% of a segment deleted, then a refresh that freezes a
    segment: the policy folds the deletion-heavy segment with its tier."""
    ref, port = _pair(corpus(120), 1, every=40)
    try:
        assert _layout(port) == _layout(ref) == [[40, 40, 40]]
        for i in range(40, 55):
            ref.indices["i"].delete_doc(f"d{i}")
            port.delete("i", f"d{i}")
        feed(ref, port, [("late", {"body": "late fox", "tag": "t1"})])
        # the deletion-heavy segment merges alone, after the ones kept
        assert _layout(port) == _layout(ref) == [[40, 40, 1, 25]]
        assert port.indices["i"].shards[0].engine.stats.merge_total == 1
        seg = port.indices["i"].shards[0].segments[-1]
        assert seg.deleted_count == 0
        _hold_routes(ref, port, monkeypatch, "reclaim")
    finally:
        ref.close()
        port.close()


def test_a_refresh_of_deletes_alone_reclaims():
    """Deletes alone, then a refresh: the port runs the merge check, as
    Lucene's NRT reopen does once it applied deletes, and folds the
    deletion-heavy segment; the reference's refresh returns before its
    merge check when it freezes nothing (ROADMAP C, reference fault), so
    it reclaims only at the next refresh that freezes a segment. From
    there the two agree again."""
    ref, port = _pair(corpus(80), 1, every=40)
    try:
        for i in range(30):
            ref.indices["i"].delete_doc(f"d{i}")
            port.delete("i", f"d{i}")
        ref.indices["i"].refresh()
        port.refresh("i")
        assert _layout(ref) == [[40, 40]]
        assert _layout(port) == [[40, 10]]
        assert port.indices["i"].shards[0].engine.stats.merge_total == 1
        # a second refresh with nothing pending merges nothing
        port.refresh("i")
        assert port.indices["i"].shards[0].engine.stats.merge_total == 1
        feed(ref, port, [("late", {"body": "late fox", "tag": "t1"})])
        # the same segments; the reference's reclaimed one comes last
        assert _layout(port) == [[40, 10, 1]]
        assert _layout(ref) == [[40, 1, 10]]
        for body in C2_BODIES.values():
            body = dict(body, size=100, **{"from": 0})
            got, want = (_search(n, body)["hits"] for n in (port, ref))
            assert got["total"] == want["total"]
            g = {h["_id"]: h["_score"] for h in got["hits"]}
            w = {h["_id"]: h["_score"] for h in want["hits"]}
            assert sorted(g) == sorted(w)
            np.testing.assert_allclose([g[i] for i in sorted(g)],
                                       [w[i] for i in sorted(w)], rtol=1e-5)
    finally:
        ref.close()
        port.close()


def test_force_merge_matches_the_reference(monkeypatch):
    ref, port = _pair(corpus(300), 2, every=60)
    try:
        for i in range(0, 300, 7):
            ref.indices["i"].delete_doc(f"d{i}")
            port.delete("i", f"d{i}")
        assert _layout(port) == _layout(ref)
        ref.indices["i"].force_merge(1)
        port.indices["i"].force_merge(1)
        assert _layout(port) == _layout(ref)
        assert all(len(s) == 1 for s in _layout(port))
        _hold_routes(ref, port, monkeypatch, "force merge")
    finally:
        ref.close()
        port.close()


def _rebuild_in_merged_order(port):
    """A second port index of the same live docs, each shard's docs fed
    in its (single) segment's order, with one refresh."""
    fresh = Node(name="fresh", device="cpu")
    _create(fresh, "i", port.indices["i"].num_shards)
    for s in port.indices["i"].shards:
        (seg,) = s.segments
        for local, doc_id in enumerate(seg.ids):
            if seg.live_host[local]:
                fresh.index("i", doc_id, copy.deepcopy(seg.sources[local]))
    fresh.refresh("i")
    return fresh


BYTE_BODIES = [
    {"query": {"match": {"body": "fox dog"}}, "size": 30},
    {"query": {"term": {"tag": "t2"}}, "size": 30},
    {"query": {"match": {"body": "the"}}, "from": 20, "size": 20},
    {"query": {"bool": {"must": [{"match": {"body": "quick"}}],
                        "filter": [{"range": {"price": {"gte": 20}}}]}}},
    {"query": {"match_all": {}}, "from": 100, "size": 15},
    {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}},
]


@pytest.mark.parametrize("route", ["mesh", "host"])
def test_merged_shard_equals_a_one_refresh_rebuild(route, monkeypatch):
    _ref, port = None, Node(name="port", device="cpu")
    _create(port, "i", 2)
    docs = corpus(360)
    for j, (doc_id, src) in enumerate(docs):
        port.index("i", doc_id, src)
        if (j + 1) % 40 == 0:
            port.refresh("i")
    for i in range(3, 360, 5):
        port.delete("i", f"d{i}")
    port.indices["i"].force_merge(1)
    fresh = _rebuild_in_merged_order(port)
    try:
        for body in BYTE_BODIES:
            got = _search(port, body, route == "host", monkeypatch)
            want = _search(fresh, body, route == "host", monkeypatch)
            assert _strip(got) == _strip(want), body
    finally:
        port.close()
        fresh.close()


def test_executor_holds_no_retired_segment_after_a_merge():
    port = Node(name="port", device="cpu")
    _create(port, "i", 2)
    svc = port.indices["i"]
    seg_br = port.breakers.breaker("segments")
    fd_br = port.breakers.breaker("fielddata")

    def live_segments():
        return [seg for s in svc.shards for seg in s.segments]

    try:
        for j, (doc_id, src) in enumerate(corpus(240)):
            port.index("i", doc_id, src)
            if (j + 1) % 60 == 0:
                port.refresh("i")
        fd_before = fd_br.used
        assert fd_before == sum(s.fielddata_bytes()
                                for s in live_segments())
        for body in BYTE_BODIES:
            port.search("i", copy.deepcopy(body))
        ex = svc.mesh_executor()
        assert ex.data_bytes() > 0 and ex._prep
        retired = {id(s) for s in live_segments()}
        svc.force_merge(1)
        assert not retired & ex.cached_segments()
        assert ex.data_bytes() == 0 and not ex._prep
        live = live_segments()
        assert seg_br.used == sum(s.memory_bytes() for s in live)
        assert fd_br.used == sum(s.fielddata_bytes() for s in live)
        # the caches refill with the live segments only
        for body in BYTE_BODIES:
            port.search("i", copy.deepcopy(body))
        assert ex.cached_segments() <= {id(s) for s in live}
    finally:
        port.close()


def test_a_tier_merge_drops_the_retired_entries_too():
    port = Node(name="port", device="cpu")
    _create(port, "i", 2)
    svc = port.indices["i"]
    try:
        docs = corpus(400)
        for j, (doc_id, src) in enumerate(docs[:350]):
            port.index("i", doc_id, src)
            if (j + 1) % 50 == 0:
                port.refresh("i")
        for body in BYTE_BODIES:
            port.search("i", copy.deepcopy(body))
        ex = svc.mesh_executor()
        before = {id(s) for s in svc.shards[0].segments}
        assert before & ex.cached_segments()
        for doc_id, src in docs[350:]:
            port.index("i", doc_id, src)
        port.refresh("i")
        assert all(len(s.segments) == 1 for s in svc.shards)
        assert not before & ex.cached_segments()
        assert port.breakers.breaker("fielddata").used == sum(
            seg.fielddata_bytes() for s in svc.shards for seg in s.segments)
    finally:
        port.close()


def test_realtime_get_and_version_survive_a_merge():
    ref, port = _pair(corpus(64), 1, every=8)
    try:
        for node in (ref, port):
            svc = node.indices["i"]
            svc.index_doc("d5", {"body": "updated fox", "tag": "t9"})
            svc.refresh()
            svc.index_doc("d6", {"body": "buffered", "tag": "t8"})
            svc.force_merge(1)
        for doc_id in ("d1", "d5", "d6", "d63"):
            got = port.indices["i"].get_doc(doc_id)
            want = ref.indices["i"].get_doc(doc_id)
            assert got["_version"] == want["_version"], doc_id
            assert got["_source"] == want["_source"], doc_id
        assert port.get("i", "d5")["_version"] == 2
        assert port.get("i", "d6")["_source"]["body"] == "buffered"
    finally:
        ref.close()
        port.close()


def test_refresh_merges_then_retries_a_denied_charge():
    """A refresh whose new segment the ``segments`` breaker denies runs
    the merge check first and charges again: reclaimed deletes make
    room."""
    port = Node(name="port", device="cpu")
    _create(port, "i", 1)
    try:
        for j, (doc_id, src) in enumerate(corpus(120)):
            port.index("i", doc_id, src)
            if (j + 1) % 60 == 0:
                port.refresh("i")
        for i in range(0, 40):
            port.delete("i", f"d{i}")
        br = port.breakers.breaker("segments")
        eng = port.indices["i"].shards[0].engine
        port.index("i", "new", {"body": "new fox", "tag": "t1"})
        br.limit = br.used + 64  # the new segment alone does not fit
        port.refresh("i")
        assert eng.stats.merge_total == 1
        assert port.search("i", {"query": {"ids": {"values": ["new"]}}})[
            "hits"]["total"] == 1
    finally:
        port.close()


# -- C3: _name and matched_queries -------------------------------------------

NAMED = {"query": {"bool": {"should": [
    {"match": {"body": {"query": "fox river", "_name": "q1"}}},
    {"term": {"tag": {"value": "t1", "_name": "q2"}}},
    {"range": {"price": {"gte": 90, "_name": "q3"}}},
    {"term": {"tag": {"value": "nowhere", "_name": "none"}}}],
    "_name": "top"}}, "size": 30}


def _unnamed(q):
    if isinstance(q, dict):
        return {k: _unnamed(v) for k, v in q.items() if k != "_name"}
    if isinstance(q, list):
        return [_unnamed(v) for v in q]
    return q


@pytest.mark.parametrize("route", ["mesh", "host"])
def test_matched_queries_match_the_reference(tiered, route, monkeypatch):
    ref, port = tiered
    host = route == "host"
    got = _search(port, NAMED, host, monkeypatch)
    want = _search(ref, NAMED, host, monkeypatch)
    _hold(got, want, route)
    assert [h.get("matched_queries") for h in got["hits"]["hits"]] == \
        [h.get("matched_queries") for h in want["hits"]["hits"]]
    assert any("q3" in h.get("matched_queries", [])
               for h in got["hits"]["hits"])
    assert not any("none" in h.get("matched_queries", [])
                   for h in got["hits"]["hits"])
    plain = _search(port, _unnamed(NAMED), host, monkeypatch)
    assert [(h["_id"], h["_score"]) for h in plain["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in got["hits"]["hits"]]


def test_named_single_field_spec(tiered, monkeypatch):
    ref, port = tiered
    body = {"query": {"match": {"body": {"query": "dog", "_name": "d"}}},
            "size": 5}
    for host in (False, True):
        got = _search(port, body, host, monkeypatch)
        want = _search(ref, body, host, monkeypatch)
        assert [h.get("matched_queries") for h in got["hits"]["hits"]] == \
            [h.get("matched_queries") for h in want["hits"]["hits"]] == \
            [["d"]] * 5
