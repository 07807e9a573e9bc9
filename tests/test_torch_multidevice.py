"""The port's shard mesh over several devices against the reference's
mesh on its eight virtual CPU devices, and against the port's own
one-device node and host loop.

A port node over a device list (``Node(device=["cpu"] * 8)``) has one
residency registry per entry: shard i lives on mesh device i % min(
shards, devices), each round runs a part on every device, and the parts'
per-slot results merge on the first device (``parallel/executor.py``).
A list that names one device several times runs the code of several
devices on one, as the reference's tests run its mesh on eight virtual
CPU devices (``tests/conftest.py``).

Indices: ``tests/test_torch_mesh.py``'s seeded ``docs`` and ``dense``
(8 shards, over ``["cpu"] * 8``: a device a shard) and ``docs10`` (10
shards over ``["cpu"] * 4``: five shards wrap onto the first two
devices; the reference wraps them over its 8).

Bars, those of ``tests/test_torch_mesh.py``. Generic route: the same ids
in the same order, ``hits.total`` exact, scores within 1e-5. B1 route:
total exact, scores at rtol 5e-3 against the reference and recall@k >=
0.95 (its bf16 products), bit-equal to the port's host loop. Against
the port's one-device node: identical responses apart from ``took``.
The reference's AOT executable cache is patched off (ROADMAP C,
reference note).
"""
import copy

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node

from _torch_parity import MAPPING, corpus
from test_torch_mesh import (DENSE, DENSE_MAPPING, DOCS_MAPPING, FUSED,
                             WRAP, _bodies, _check_generic, _check_host,
                             _dense_docs, _docs, _hits_of, _ids, _load,
                             _port_host, _port_mesh, _ref_mesh, _scores,
                             _search)

_NAMES = sorted(_bodies(np.zeros((320, 8))))


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


@pytest.fixture(scope="module")
def nodes():
    """(reference, port over 8 devices, port over 4 devices, port on one
    device, vectors): ``docs`` and ``dense`` on the first three,
    ``docs10`` on the reference and the four-device port."""
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref")
        eight = Node(name="eight", device=["cpu"] * 8)
        four = Node(name="four", device=["cpu"] * 4)
        one = Node(name="one", device="cpu")
        x, docs = _docs()
        _load(ref, eight, "docs", 8, DOCS_MAPPING, docs, refreshes=2)
        _load(ref, eight, "dense", 8, DENSE_MAPPING, _dense_docs())
        _load(ref, four, "docs10", 10, DOCS_MAPPING, docs)
        for name, mapping, src, refreshes in (
                ("docs", DOCS_MAPPING, docs, 2),
                ("dense", DENSE_MAPPING, _dense_docs(), 1)):
            one.create_index(name, {
                "settings": {"index": {"number_of_shards": 8}},
                "mappings": mapping})
            step = -(-len(src) // refreshes)
            for a in range(0, len(src), step):
                for doc_id, s in src[a: a + step]:
                    one.index(name, doc_id, s)
                one.refresh(name)
    yield ref, eight, four, one, x
    for n in (ref, eight, four, one):
        n.close()


def test_shards_live_on_their_devices(nodes):
    """Shard i and its segments on registry i % min(shards, devices);
    each registry holds only its own shards' bytes."""
    _ref, eight, four, _one, _x = nodes
    svc = eight.get_index("docs")
    members = eight.residency.members
    assert len(members) == 8 and eight.info()["devices"] == ["cpu"] * 8
    ex = svc.mesh_executor()
    assert ex.n_devices == 8 and ex.S == 8
    for i, sh in enumerate(svc.shards):
        assert sh.engine.residency is members[i]
        assert all(seg.residency is members[i] for seg in sh.segments)
    ten = four.get_index("docs10")
    fm = four.residency.members
    assert [sh.engine.residency for sh in ten.shards] == \
        [fm[i % 4] for i in range(10)]
    assert ten.mesh_executor().n_devices == 4
    st = four.residency.stats()
    assert [d["device"] for d in st["devices"]] == ["cpu"] * 4
    assert st["tiers"]["fielddata"]["handles"] == sum(
        d["tiers"]["fielddata"]["handles"] for d in st["devices"])


@pytest.mark.parametrize("name", _NAMES)
def test_eight_devices_match_the_reference_mesh(nodes, name):
    ref, eight, _four, _one, x = nodes
    body = _bodies(x)[name]
    p = _port_mesh(eight, "docs", body)
    assert p["hits"]["hits"]
    _check_generic(p, _ref_mesh(ref, "docs", body))


@pytest.mark.parametrize("name", _NAMES)
def test_eight_devices_match_one_device(nodes, name):
    """The same slots and candidates: identical responses."""
    _ref, eight, _four, one, x = nodes
    body = _bodies(x)[name]
    got = _port_mesh(eight, "docs", body)
    want = _port_mesh(one, "docs", body)
    got.pop("took")
    want.pop("took")
    assert got == want


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_generic_route_over_devices(nodes, name, monkeypatch):
    ref, eight, _four, _one, _x = nodes
    p = _port_mesh(eight, "dense", DENSE[name])
    snap = kernels.snapshot()
    assert snap.get("bm25_hybrid") and not snap.get("bm25_fused_topk"), snap
    _check_generic(p, _ref_mesh(ref, "dense", DENSE[name]))
    _check_host(p, _port_host(eight, "dense", DENSE[name], monkeypatch),
                exact=False)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_dense_b1_route_over_devices(nodes, name, monkeypatch):
    """B1 on each slot's own device: the reference's fused-path bar, the
    port's host loop and one-device node bit for bit."""
    ref, eight, _four, one, _x = nodes
    body = FUSED[name]
    p = _port_mesh(eight, "dense", body)
    snap = kernels.snapshot()
    assert snap.get("bm25_fused_topk") == 8, snap
    assert not snap.get("bm25_hybrid") and not snap.get("bm25_scatter")
    r = _ref_mesh(ref, "dense", body)
    assert p["hits"]["total"] == r["hits"]["total"]
    assert len(_ids(p)) == len(_ids(r))
    frm = body.get("from", 0)
    top = dict(body, size=frm + body.get("size", 10), **{"from": 0})
    rid, pid = _ids(_ref_mesh(ref, "dense", top)), _ids(
        _port_mesh(eight, "dense", top))
    assert len(set(pid) & set(rid)) / len(rid) >= 0.95
    assert _ids(p) == pid[frm:]
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=5e-3)
    _check_host(p, _port_host(eight, "dense", body, monkeypatch), exact=True)
    _check_host(p, _port_mesh(one, "dense", body), exact=True)


@pytest.mark.parametrize("name", WRAP)
def test_ten_shards_on_four_devices_match_the_reference_wrap(nodes, name):
    """Ten slots over four devices (shards 0, 4, 8 on the first) against
    the reference's ten shards wrapped over its eight devices."""
    ref, _eight, four, _one, x = nodes
    body = _bodies(x)[name]
    _check_generic(_port_mesh(four, "docs10", body),
                   _ref_mesh(ref, "docs10", body))


@pytest.mark.parametrize("name", WRAP)
def test_four_devices_through_the_host_loop(nodes, name, monkeypatch):
    """An index spread over four devices also serves through the host
    loop (``index.search.mesh: false``): each segment on its own device,
    the same hits as the mesh."""
    _ref, _eight, four, _one, x = nodes
    body = _bodies(x)[name]
    mesh = _port_mesh(four, "docs10", body)
    svc = four.get_index("docs10")
    svc.settings.setdefault("index", svc.settings)["search"] = {
        "mesh": False}
    try:
        kernels.reset()
        host = _search(four, "docs10", body)
        assert not any(k.startswith("mesh_") for k in kernels.snapshot())
    finally:
        svc.settings["index"]["search"] = {"mesh": True}
    _check_host(mesh, host, exact=False)
    _check_host(mesh, _port_host(four, "docs10", body, monkeypatch),
                exact=False)


@pytest.mark.parametrize("kind", ["knn", "maxsim"])
def test_vector_rounds_over_four_devices(nodes, kind):
    """search_knn / search_maxsim with B2 on each slot's device, the
    slots merged on the first: the reference's executor over the same
    ten shards."""
    from elasticsearch_tpu.parallel.executor import \
        _segments_of as ref_segments_of

    ref, _eight, four, _one, x = nodes
    rng = np.random.default_rng(3)
    if kind == "knn":
        qs = (x[[4, 50, 201]] + 0.05 * rng.standard_normal((3, 8))
              ).astype(np.float32)
    else:
        qs = (x[[[4, 9], [50, 77], [201, 12]]]
              + 0.05 * rng.standard_normal((3, 2, 8))).astype(np.float32)
    rsvc, psvc = ref.indices["docs10"], four.get_index("docs10")
    run = "search_knn" if kind == "knn" else "search_maxsim"
    kernels.reset()
    got = getattr(psvc.mesh_executor(), run)("v", qs, k=10)
    assert kernels.snapshot().get("knn_fused_topk") == 10
    want = getattr(rsvc.mesh_executor(), run)("v", qs, k=10)
    gv, gids = _hits_of(got, lambda s: psvc.shards[s].segments)
    wv, wids = _hits_of(want, lambda s: ref_segments_of(rsvc.shards[s]))
    assert gids == wids
    np.testing.assert_allclose(gv, wv, rtol=1e-5)


def test_msearch_over_four_devices_equals_sequential_searches(nodes):
    """The batched postings round with a part on each device: every
    response as its sequential search's (ids, totals; scores within
    1e-5: the round sums in f32 where a lone search may take B1)."""
    _ref, _eight, four, _one, _x = nodes
    texts = ["quick brown fox", "lazy dog river", "mountain", "zulu fox",
             "engine shard score", "ocean desert island", "nosuchword"]
    bodies = [{"query": {"match": {"body": t}}, "size": 8} for t in texts]
    kernels.reset()
    got = four.msearch([({"index": "docs10"}, copy.deepcopy(b))
                        for b in bodies])["responses"]
    snap = kernels.snapshot()
    assert snap.get("mesh_msearch") == 1, snap
    assert not snap.get("mesh_msearch_fallback"), snap
    for g, b in zip(got, bodies):
        want = _search(four, "docs10", b)
        assert g["hits"]["total"] == want["hits"]["total"]
        assert _ids(g) == _ids(want)
        np.testing.assert_allclose(_scores(g), _scores(want), rtol=1e-5)


def test_one_entry_list_is_the_one_device_node(nodes):
    """``Node(device=["cpu"])`` is ``Node(device="cpu")``: the same
    responses apart from ``took``, the same routes and counters."""
    _ref, _eight, _four, _one, x = nodes
    a = Node(name="a", device="cpu")
    b = Node(name="b", device=["cpu"])
    try:
        _x, docs = _docs()
        for n in (a, b):
            n.create_index("d", {"settings": {"number_of_shards": 3},
                                 "mappings": DOCS_MAPPING})
            for doc_id, src in docs:
                n.index("d", doc_id, src)
            n.refresh("d")
        assert b.info()["devices"] == a.info()["devices"] == ["cpu"]
        assert b.residency.stats() == a.residency.stats()
        bodies = [_bodies(x)[n] for n in _NAMES] + [
            {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}},
                                 "p": {"stats": {"field": "price"}}}},
            {"query": {"match": {"body": "fox"}}, "sort": [{"n": "asc"}],
             "size": 6}]
        for body in bodies:
            kernels.reset()
            ra = _search(a, "d", body)
            sa = kernels.snapshot()
            kernels.reset()
            rb = _search(b, "d", body)
            assert kernels.snapshot() == sa
            ra.pop("took")
            rb.pop("took")
            assert ra == rb
        pairs = [({"index": "d"}, {"query": {"match": {"body": t}}})
                 for t in ("quick fox", "lazy", "river dog")]
        ma = a.msearch(copy.deepcopy(pairs))["responses"]
        mb = b.msearch(copy.deepcopy(pairs))["responses"]
        for r in ma + mb:
            r.pop("took", None)
        assert ma == mb
    finally:
        a.close()
        b.close()


def test_aggs_over_devices_merge_on_the_devices(nodes):
    """Terms (device counts), value_count, avg and stats over eight
    devices: the integer lanes summed across devices (``mesh_psum``),
    the response identical to the one-device node's; against the
    reference mesh, buckets and counts exact, float sums at rtol 1e-5
    (``tests/test_torch_aggs.py``'s bar: f32 sums in another order)."""
    ref, eight, _four, one, _x = nodes
    for aggs in ({"t": {"terms": {"field": "tag"}}},
                 {"t": {"terms": {"field": "tag", "size": 3}},
                  "c": {"value_count": {"field": "n"}},
                  "a": {"avg": {"field": "price"}},
                  "s": {"stats": {"field": "price"}},
                  "e": {"extended_stats": {"field": "price"}}}):
        body = {"query": {"match": {"body": "fox river"}}, "size": 0,
                "aggs": aggs}
        kernels.reset()
        got = _search(eight, "docs", body)
        snap = kernels.snapshot()
        assert snap.get("mesh_search") == 1 and snap.get("mesh_psum") == \
            len(aggs), snap
        kernels.reset()
        want = _search(one, "docs", body)
        assert not kernels.snapshot().get("mesh_psum")  # one device
        assert got["aggregations"] == want["aggregations"]
        r = _search(ref, "docs", body)
        assert got["hits"]["total"] == r["hits"]["total"]
        assert got["aggregations"]["t"] == r["aggregations"]["t"]
        for name in set(aggs) - {"t"}:
            _near(got["aggregations"][name], r["aggregations"][name])


def _near(v, w):
    """Counts and keys exact, floats (f32 sums in another order) at rtol
    1e-5, through nested dicts."""
    if isinstance(v, dict):
        assert v.keys() == w.keys()
        for key in v:
            _near(v[key], w[key])
    elif isinstance(v, float):
        np.testing.assert_allclose(v, w, rtol=1e-5)
    else:
        assert v == w


def test_a_denial_on_one_device_evicts_nothing_on_another():
    """Each registry's LRU evicts only its own device's handles: with
    the fielddata breaker full of device 0's columns, a rehydration on
    device 1 finds nothing of its own to evict and trips (that shard's
    failure entry); device 0's columns stay resident. Device 1's own
    budget refuses the same way."""
    node = Node(name="deny", device=["cpu", "cpu"])
    try:
        node.create_index("r", {"settings": {"index": {
            "number_of_shards": 2, "search": {"mesh": False}}},
            "mappings": MAPPING})
        for doc_id, src in corpus(200, seed=4):
            node.index("r", doc_id, src)
        node.refresh("r")
        body = {"query": {"match_all": {}}, "sort": [{"price": "asc"}],
                "size": 5}
        first = _search(node, "r", body)
        assert first["_shards"]["failed"] == 0
        m0, m1 = node.residency.members
        fd0 = m0.stats()["tiers"]["fielddata"]
        assert fd0["resident_bytes"] > 0
        assert m1.stats()["tiers"]["fielddata"]["resident_bytes"] > 0
        m1.evict_all()
        fd = node.breakers.breaker("fielddata")
        node.breakers.apply_cluster_settings(
            {"indices.breaker.fielddata.limit": fd.used})
        denied = _search(node, "r", body)
        assert denied["_shards"]["failed"] == 1
        assert denied["_shards"]["failures"][0]["shard"] == 1
        assert m0.stats()["tiers"]["fielddata"] == fd0
        node.breakers.apply_cluster_settings({})
        m1.budget = 1
        denied = _search(node, "r", body)
        assert denied["_shards"]["failed"] == 1
        assert "budget" in denied["_shards"]["failures"][0]["reason"][
            "reason"]
        assert m0.stats()["tiers"]["fielddata"] == fd0
        m1.budget = None
        healed = _search(node, "r", body)
        healed.pop("took")
        first.pop("took")
        assert healed == first
    finally:
        node.close()


def test_a_failed_device_merge_raises(nodes, monkeypatch):
    """No catch-all around the cross-device merge: a fault there reaches
    the caller, never a quiet route to the host fold."""
    _ref, eight, _four, _one, _x = nodes
    ex = eight.get_index("docs").mesh_executor()

    def broken(*a, **kw):
        raise RuntimeError("injected merge fault")

    monkeypatch.setattr(ex, "psum_partials", broken)
    with pytest.raises(RuntimeError, match="injected merge fault"):
        _search(eight, "docs", {"size": 0, "aggs": {
            "c": {"value_count": {"field": "n"}}}})


def test_a_round_copies_back_once_after_every_part_launched(nodes,
                                                            monkeypatch):
    """Every device's part of a round is launched before anything of the
    round is copied to the host, and the round copies back once."""
    import torch

    _ref, eight, _four, _one, x = nodes
    ex = eight.get_index("docs").mesh_executor()
    events = []
    real_slot, real_run = ex._slot_results, ex._run_mesh_round
    real_cpu = torch.Tensor.cpu

    def run(mr):
        events.append("[")
        out = real_run(mr)
        events.append("]")
        return out

    monkeypatch.setattr(ex, "_slot_results",
                        lambda rd: events.append("p") or real_slot(rd))
    monkeypatch.setattr(ex, "_run_mesh_round", run)
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **kw: events.append("c")
                        or real_cpu(t, *a, **kw))
    _search(eight, "docs", _bodies(x)["match_or"])
    monkeypatch.undo()
    rounds = "".join(events).replace("]", "]\n").split()
    # two segment rounds over eight devices: eight parts, then one copy
    assert rounds == ["[" + "p" * 8 + "c]"] * 2, rounds


def test_empty_slots_over_devices_answer_as_the_host_loop(monkeypatch):
    """An index without a segment, then six shards over four devices
    with fewer documents than shards (whole devices without a segment in
    a round): every route answers as the host loop."""
    node = Node(name="empty-multi", device=["cpu"] * 4)
    try:
        node.create_index("r", {"settings": {"number_of_shards": 6},
                                "mappings": MAPPING})
        bodies = [{"query": {"match": {"body": "quick fox"}}, "size": 4},
                  {"query": {"match_all": {}}},
                  {"query": {"range": {"price": {"gte": 0}}},
                   "sort": [{"price": "asc"}]},
                  {"size": 0, "aggs": {"t": {"terms": {"field": "tag"}},
                                       "a": {"avg": {"field": "price"}}}}]

        def same(b):
            mesh = _port_mesh(node, "r", b)
            host = _port_host(node, "r", b, monkeypatch)
            mesh.pop("took")
            host.pop("took")
            assert mesh == host

        for b in bodies:
            same(b)
        for doc_id, src in corpus(4, seed=2):
            node.index("r", doc_id, src)
        node.refresh("r")
        assert sum(not sh.segments for sh in node.get_index("r").shards)
        for b in bodies:
            same(b)
    finally:
        node.close()
