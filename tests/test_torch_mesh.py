"""The port's default search path, the mesh (``parallel/``), against the
reference's mesh on its 8-device CPU mesh and against the port's own
host loop (``index.search.mesh: false``).

Indices, the same seeded documents in both packages:
- ``docs``: 8 shards, 320 docs of ``tests/_torch_parity.py``'s corpus
  plus an 8-d vector, refreshed twice (two segments a shard, so two
  segment rounds);
- ``dense``: 8 shards whose segments each carry a dense impact block
  ('common' in every doc), the shape of the reference's ``dense_node``
  (tests/integration/test_mesh_product_path.py), with its tf varied so
  that scores seldom tie;
- ``docs10``: 10 shards of ``docs``'s corpus: the port's 10 slots
  against the reference wrapping 10 shards over 8 devices.

Bars. Generic route: the same ids in the same order, ``hits.total``
exact, scores within 1e-5. B1 route (a pure disjunctive term group on
dense rows): the fused-path bar, total exact, scores at rtol 5e-3 and
recall@k >= 0.95 (ROADMAP C, "By design, fused-path scores"). Port mesh
against port host loop: identical responses apart from ``took`` and the
scores, scores bit-equal on the B1 route and within 1e-5 elsewhere.

The reference's AOT executable cache keys no device layout and serves
executables built for another mesh (ROADMAP C, reference note): every
test here runs with it off, patched at run time.
"""
import copy
import json
import random

import numpy as np
import pytest
import torch

from elasticsearch_tpu.monitor import kernels as ref_kernels
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import scoring as port_scoring
from elasticsearch_tpu_torch.parallel import executor as port_executor

from _torch_parity import MAPPING, clustered, corpus

N_DOCS = 320
DIMS = 8


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _docs():
    x = clustered(N_DOCS, DIMS, 6, seed=17)
    docs = []
    for i, (doc_id, src) in enumerate(corpus(N_DOCS, seed=3)):
        if i % 13:
            src = dict(src, v=[float(a) for a in x[i]])
        docs.append((doc_id, src))
    return x, docs


def _dense_docs():
    rng = random.Random(11)
    rare = ["emu", "ibex", "kiwi", "lynx", "mole", "newt"]
    return [(str(i), {"body": " ".join(["common"] * rng.randint(1, 3)
                                       + rng.choices(rare,
                                                     k=rng.randint(1, 5))),
                      "tag": rng.choice(["x", "y"])})
            for i in range(1536)]


DOCS_MAPPING = {"properties": dict(MAPPING["properties"], v={
    "type": "dense_vector", "dims": DIMS, "similarity": "cosine"})}
DENSE_MAPPING = {"properties": {"body": {"type": "text"},
                                "tag": {"type": "keyword"}}}


def _load(ref, port, name, shards, mapping, docs, refreshes=1):
    body = {"settings": {"index": {"number_of_shards": shards}},
            "mappings": mapping}
    ref.create_index(name, copy.deepcopy(body))
    port.create_index(name, copy.deepcopy(body))
    svc = ref.indices[name]
    step = -(-len(docs) // refreshes)
    for a in range(0, len(docs), step):
        for doc_id, src in docs[a: a + step]:
            svc.index_doc(doc_id, src)
            port.index(name, doc_id, src)
        svc.refresh()
        port.refresh(name)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref")
        port = Node(name="port", device="cpu")
        x, docs = _docs()
        _load(ref, port, "docs", 8, DOCS_MAPPING, docs, refreshes=2)
        _load(ref, port, "dense", 8, DENSE_MAPPING, _dense_docs())
        _load(ref, port, "docs10", 10, DOCS_MAPPING, docs)
    yield ref, port, x
    ref.close()
    port.close()


def _qvec(x, i, noise=0.05):
    rng = np.random.default_rng(i)
    return [float(a) for a in x[i] + noise * rng.standard_normal(DIMS)]


def _bodies(x):
    """One body per compiled query type (and a few shapes of each)."""
    _, docs = _docs()
    n1, n2 = docs[1][1]["n"], docs[40][1]["n"]
    knn = {"field": "v", "query_vector": _qvec(x, 5)}
    return {
        "match_all": {"query": {"match_all": {}}, "size": 25},
        "term_text": {"query": {"term": {"body": "fox"}}, "size": 15},
        "term_keyword": {"query": {"term": {"tag": "t3"}}, "size": 20},
        "term_long": {"query": {"term": {"n": n1}}},
        "terms_keyword": {"query": {"terms": {"tag": ["t1", "t5"]}},
                          "size": 7},
        "terms_long": {"query": {"terms": {"n": [n1, n2, 5]}}},
        "match_or": {"query": {"match": {"body": "quick brown fox"}},
                     "size": 12},
        "match_and": {"query": {"match": {"body": {
            "query": "quick fox river", "operator": "and"}}}},
        "match_msm": {"query": {"match": {"body": {
            "query": "lazy dog ocean desert",
            "minimum_should_match": "50%"}}}},
        "range_long": {"query": {"range": {"n": {"gt": 100_000_300,
                                                 "lte": 700_002_100}}}},
        "range_double": {"query": {"range": {"price": {"gte": 25.5,
                                                       "lte": 60}}}},
        "range_keyword": {"query": {"range": {"tag": {"gte": "t2",
                                                      "lt": "t5"}}},
                          "size": 9},
        "exists": {"query": {"exists": {"field": "n"}}, "size": 30},
        "ids": {"query": {"ids": {"values": ["d3", "d77", "d200",
                                             "nope"]}}},
        "bool": {"query": {"bool": {
            "must": [{"match": {"body": "brown dog"}}],
            "should": [{"match": {"body": "river"}},
                       {"term": {"tag": "t2"}}],
            "must_not": [{"term": {"tag": "t4"}}],
            "filter": [{"range": {"price": {"gte": 10, "lt": 80}}}]}},
            "size": 15},
        "bool_msm": {"query": {"bool": {
            "should": [{"match": {"body": "quick"}},
                       {"match": {"body": "lazy"}},
                       {"match": {"body": "mountain"}}],
            "minimum_should_match": 2}}, "size": 12},
        "constant_score": {"query": {"constant_score": {
            "filter": {"term": {"tag": "t6"}}, "boost": 2.5}}, "size": 9},
        "knn": {"query": {"knn": dict(knn)}},
        "knn_filter": {"query": {"knn": dict(
            knn, k=15, num_candidates=40,
            filter={"term": {"tag": "t2"}})}, "size": 15},
        "knn_in_bool": {"query": {"bool": {
            "must": [{"knn": dict(knn)}],
            "filter": [{"range": {"price": {"gte": 20}}}]}}},
        "paged_no_source": {"query": {"match": {
            "body": "engine shard mountain"}}, "from": 10, "size": 10,
            "_source": False},
    }


DENSE = {
    "hyb_match": {"query": {"match": {"body": "common emu"}}, "size": 6},
    "hyb_match_and": {"query": {"match": {"body": {
        "query": "common lynx", "operator": "and"}}}},
    "hyb_match_msm": {"query": {"match": {"body": {
        "query": "common emu kiwi", "minimum_should_match": 2}}}},
    "hyb_terms": {"query": {"terms": {"body": ["common", "newt"]}},
                  "size": 11},
    "hyb_bool": {"query": {"bool": {
        "must": [{"match": {"body": "mole"}}],
        "filter": [{"term": {"tag": "x"}}],
        "should": [{"match": {"body": "common"}}]}}, "size": 8},
}
# the pure-dense term groups: kernel B1's route on every slot
FUSED = {
    "b1_term": {"query": {"term": {"body": "common"}}, "size": 5},
    "b1_match": {"query": {"match": {"body": "common"}}, "size": 20},
    "b1_paged": {"query": {"match": {"body": "common common"}},
                 "from": 30, "size": 10},
}

_NAMES = sorted(_bodies(np.zeros((N_DOCS, DIMS))))
WRAP = ("match_or", "match_and", "term_keyword", "range_long", "bool",
        "knn", "ids")


def _search(node, index, body):
    return node.search(index, copy.deepcopy(body))


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _scores(resp):
    return np.array([h["_score"] for h in resp["hits"]["hits"]], np.float64)


def _strip_scores(resp):
    """Deep copy with the score fields zeroed and ``took`` removed: the
    rest must be identical (tests/integration/test_mesh_qtf.py)."""
    r = json.loads(json.dumps(resp))
    r.pop("took", None)
    if r["hits"].get("max_score") is not None:
        r["hits"]["max_score"] = 0.0
    for h in r["hits"]["hits"]:
        h["_score"] = 0.0
    return r


def _port_mesh(port, index, body):
    """The port's answer through the mesh, asserting the route."""
    kernels.reset()
    resp = _search(port, index, body)
    snap = kernels.snapshot()
    assert snap.get("mesh_search") == 1, snap
    assert not snap.get("mesh_fallback_total"), snap
    return resp


def _ref_mesh(ref, index, body):
    ref_kernels.reset()
    resp = _search(ref, index, body)
    assert ref_kernels.snapshot().get("mesh_search") == 1
    return resp


def _port_host(port, index, body, monkeypatch):
    monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    resp = _search(port, index, body)
    monkeypatch.delenv("ESTPU_DISABLE_MESH")
    assert not any(k.startswith("mesh_") for k in kernels.snapshot())
    return resp


def _check_generic(p, r):
    assert p["hits"]["total"] == r["hits"]["total"]
    assert p["_shards"] == r["_shards"]
    assert _ids(p) == _ids(r)
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=1e-5)
    for hp, hr in zip(p["hits"]["hits"], r["hits"]["hits"]):
        assert hp == dict(hr, _score=hp["_score"])
    if r["hits"]["max_score"] is None:
        assert p["hits"]["max_score"] is None
    else:
        np.testing.assert_allclose(p["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=1e-5)


def _check_host(mesh, host, exact: bool):
    assert _strip_scores(mesh) == _strip_scores(host)
    if exact:
        np.testing.assert_array_equal(_scores(mesh), _scores(host))
        assert mesh["hits"]["max_score"] == host["hits"]["max_score"]
    else:
        np.testing.assert_allclose(_scores(mesh), _scores(host), rtol=1e-5)


@pytest.mark.parametrize("name", _NAMES)
def test_mesh_matches_reference_mesh(nodes, name):
    ref, port, x = nodes
    body = _bodies(x)[name]
    p = _port_mesh(port, "docs", body)
    assert p["hits"]["hits"]
    _check_generic(p, _ref_mesh(ref, "docs", body))


@pytest.mark.parametrize("name", _NAMES)
def test_mesh_matches_host_loop(nodes, name, monkeypatch):
    _ref, port, x = nodes
    body = _bodies(x)[name]
    _check_host(_port_mesh(port, "docs", body),
                _port_host(port, "docs", body, monkeypatch), exact=False)


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_generic_route(nodes, name, monkeypatch):
    ref, port, _x = nodes
    p = _port_mesh(port, "dense", DENSE[name])
    snap = kernels.snapshot()
    assert snap.get("bm25_hybrid") and not snap.get("bm25_fused_topk"), snap
    _check_generic(p, _ref_mesh(ref, "dense", DENSE[name]))
    _check_host(p, _port_host(port, "dense", DENSE[name], monkeypatch),
                exact=False)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_dense_b1_route(nodes, name, monkeypatch):
    ref, port, _x = nodes
    body = FUSED[name]
    p = _port_mesh(port, "dense", body)
    # B1 on every slot, nothing generic
    snap = kernels.snapshot()
    assert snap.get("bm25_fused_topk") == 8, snap
    assert not snap.get("bm25_hybrid") and not snap.get("bm25_scatter")
    r = _ref_mesh(ref, "dense", body)
    assert p["hits"]["total"] == r["hits"]["total"]
    assert len(_ids(p)) == len(_ids(r))
    frm = body.get("from", 0)
    top = dict(body, size=frm + body.get("size", 10), **{"from": 0})
    rid, pid = _ids(_ref_mesh(ref, "dense", top)), _ids(
        _port_mesh(port, "dense", top))
    assert len(set(pid) & set(rid)) / len(rid) >= 0.95
    assert _ids(p) == pid[frm:]
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=5e-3)
    # the host loop runs B1 on each segment: the same bits
    _check_host(p, _port_host(port, "dense", body, monkeypatch), exact=True)


@pytest.mark.parametrize("name", WRAP)
def test_ten_shards_match_the_reference_wrap(nodes, name):
    """10 slots in the port, 10 shards wrapped over 8 devices in the
    reference: the result does not depend on the layout."""
    ref, port, x = nodes
    body = _bodies(x)[name]
    _check_generic(_port_mesh(port, "docs10", body),
                   _ref_mesh(ref, "docs10", body))


def test_routes_that_decline_the_mesh(nodes, monkeypatch):
    """hybrid, IVF and MaxSim knn decline by design; rescore takes the
    host loop; each still answers as the host loop does."""
    _ref, port, x = nodes
    q = _qvec(x, 9)
    by_design = [
        {"query": {"hybrid": {"query": {"match": {"body": "fox"}},
                              "knn": {"field": "v", "query_vector": q,
                                      "ann": False}}}},
        {"query": {"knn": {"field": "v", "query_vector": q, "ann": True}}},
        {"query": {"knn": {"field": "v",
                           "query_vectors": [q, _qvec(x, 30)]}}},
    ]
    rescore = {"query": {"match": {"body": "quick fox"}}, "rescore": {
        "window_size": 20, "query": {"rescore_query": {
            "match": {"body": "river"}}}}}
    from elasticsearch_tpu_torch.parallel import mesh_service

    keyed = []
    real = mesh_service._canonical
    monkeypatch.setattr(mesh_service, "_canonical",
                        lambda b: keyed.append(1) or real(b))
    for body, counter in [(b, "mesh_host_by_design") for b in by_design] \
            + [(rescore, "mesh_fallback_total")]:
        kernels.reset()
        resp = _search(port, "docs", body)
        snap = kernels.snapshot()
        assert snap.get(counter) == 1 and not snap.get("mesh_search"), snap
        # a declined body is never serialised for the memo
        assert not keyed
        assert resp == dict(_port_host(port, "docs", body, monkeypatch),
                            took=resp["took"])


def _hits_of(out, segs_of):
    vals, shard, local, seg_ord, _ = out
    ids = [[segs_of(int(s))[int(o)].ids[int(lc)] if np.isfinite(v) else None
            for v, s, o, lc in zip(*row)]
           for row in zip(vals, shard, seg_ord, local)]
    return np.asarray(vals), ids


@pytest.mark.parametrize("kind", ["knn", "maxsim"])
def test_vector_rounds_match_the_reference(nodes, kind):
    """search_knn / search_maxsim over the 8 slots (B2 at 4k in bf16,
    the f32 re-rank, MaxSim's per-doc max, the merge) against the
    reference's executor on the same slab."""
    from elasticsearch_tpu.parallel.executor import \
        _segments_of as ref_segments_of

    ref, port, x = nodes
    rng = np.random.default_rng(3)
    if kind == "knn":
        qs = (x[[4, 50, 201]] + 0.05 * rng.standard_normal((3, DIMS))
              ).astype(np.float32)
    else:
        qs = (x[[[4, 9], [50, 77], [201, 12]]]
              + 0.05 * rng.standard_normal((3, 2, DIMS))).astype(np.float32)
    rsvc, psvc = ref.indices["docs"], port.get_index("docs")
    run = "search_knn" if kind == "knn" else "search_maxsim"
    got = getattr(psvc.mesh_executor(), run)("v", qs, k=10)
    want = getattr(rsvc.mesh_executor(), run)("v", qs, k=10)
    gv, gids = _hits_of(got, lambda s: psvc.shards[s].segments)
    wv, wids = _hits_of(want,
                        lambda s: ref_segments_of(rsvc.shards[s]))
    assert gids == wids
    np.testing.assert_allclose(gv, wv, rtol=1e-5)


def test_delete_between_two_searches_misses_the_memo(monkeypatch):
    node = Node(name="del", device="cpu")
    try:
        node.create_index("d", {"settings": {"number_of_shards": 2},
                                "mappings": MAPPING})
        for doc_id, src in corpus(120, seed=8):
            node.index("d", doc_id, src)
        node.refresh("d")
        body = {"query": {"match": {"body": "quick lazy"}}, "size": 5}
        first = _port_mesh(node, "d", body)
        again = _port_mesh(node, "d", body)
        assert kernels.snapshot().get("executor_prep_hit") == 1
        assert _strip_scores(again) == _strip_scores(first)
        victim = _ids(first)[0]
        node.delete("d", victim)
        after = _port_mesh(node, "d", body)
        snap = kernels.snapshot()
        assert snap.get("executor_prep_miss") == 1, snap
        assert not snap.get("executor_prep_hit"), snap
        assert victim not in _ids(after)
        assert after["hits"]["total"] == first["hits"]["total"] - 1
        _check_host(after, _port_host(node, "d", body, monkeypatch),
                    exact=False)
    finally:
        node.close()


def _env_tensors(executor):
    """The tensors each memo entry's round reads, made as a run makes
    them."""
    out = []
    for rd in executor._prep.values():
        env = port_executor._Env(rd.items or [])
        for i in range(len(rd.items or [])):
            for a in env[i]:
                if isinstance(a, list):
                    out += [t for t in a if isinstance(t, torch.Tensor)]
                elif isinstance(a, torch.Tensor):
                    out.append(a)
    return out


def test_one_slot_round_passes_the_segments_own_tensors():
    """At S = 1 a round copies no postings, live mask or dense block:
    its tensors are the segment's own (equal data_ptr), and no
    [1, F, D] block exists; nothing is charged for stacked data."""
    node = Node(name="one", device="cpu")
    try:
        node.create_index("o", {"settings": {"number_of_shards": 1},
                                "mappings": DENSE_MAPPING})
        for doc_id, src in _dense_docs()[:300]:
            node.index("o", doc_id, src)
        node.refresh("o")
        svc = node.get_index("o")
        seg = svc.shards[0].segments[0]
        inv = seg.inverted["body"]
        rows, block = inv.dense_block()
        seg.inverted["tag"].dense_block()  # the filter's field, built too
        fd = node.breakers.breaker("fielddata")
        base = fd.used
        for body in (DENSE["hyb_match"], FUSED["b1_term"],
                     DENSE["hyb_bool"]):
            _port_mesh(node, "o", body)
        ex = svc.mesh_executor()
        tensors = _env_tensors(ex)
        ptrs = {t.data_ptr() for t in tensors}
        for own in (seg.live, inv.doc_ids, inv.tfnorm, block):
            assert own.data_ptr() in ptrs
        assert any(t is block for t in tensors)
        F, D = block.shape
        assert not any(t.dim() == 3 and tuple(t.shape[1:]) == (F, D)
                       for t in tensors)
        # charged: the memo's word buffers only, no stacked data
        assert ex.data_bytes() == 0
        assert fd.used == base + sum(rd.nbytes for rd in ex._prep.values())
    finally:
        node.close()


def _reachable_tensors(obj, depth=6):
    """Tensors reachable from ``obj`` through containers, partials,
    bound methods and closures, stopping at any other object (a segment,
    the executor)."""
    import functools

    if isinstance(obj, torch.Tensor):
        return [obj]
    if depth == 0:
        return []
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _reachable_tensors(o, depth - 1)]
    if isinstance(obj, functools.partial):
        return _reachable_tensors([obj.func, obj.args, obj.keywords],
                                  depth - 1)
    if hasattr(obj, "__self__") and isinstance(obj.__self__, torch.Tensor):
        return [obj.__self__]
    cells = getattr(obj, "__closure__", None) or ()
    return _reachable_tensors([c.cell_contents for c in cells], depth - 1)


def _storages_of(segments):
    """Storage addresses of the segments' own tensors."""
    out = set()
    for seg in segments:
        for v in vars(seg).values():
            objs = list(v.values()) if isinstance(v, dict) else [v]
            for o in objs:
                for t in _reachable_tensors(
                        [o] + list(getattr(o, "__dict__", {}).values()), 3):
                    out.add(t.untyped_storage().data_ptr())
    return out


def _check_memo_pins_no_copy(ex):
    """Every tensor a memo entry reaches is its word buffer or a tensor
    of its own segments: no stacked copy outlives its charge."""
    for rd in ex._prep.values():
        own = _storages_of(rd.refs)
        words = rd.words.untyped_storage().data_ptr()
        for t in _reachable_tensors([rd.items, rd.fused, rd.perm]):
            sp = t.untyped_storage().data_ptr()
            assert sp == words or sp in own, tuple(t.shape)


def test_stacked_copies_are_charged_and_released(monkeypatch):
    node = Node(name="two", device="cpu")
    try:
        node.create_index("t", {"settings": {"number_of_shards": 3},
                                "mappings": MAPPING})
        for doc_id, src in corpus(200, seed=5):
            node.index("t", doc_id, src)
        node.refresh("t")
        fd = node.breakers.breaker("fielddata")
        base = fd.used
        ex = node.get_index("t").mesh_executor()
        fox = {"query": {"match": {"body": "fox"}}}
        _port_mesh(node, "t", fox)
        memo = sum(rd.nbytes for rd in ex._prep.values())
        assert ex.data_bytes() > 0
        assert fd.used == base + ex.data_bytes() + memo
        # an LRU of one entry: each miss evicts and releases the last
        monkeypatch.setattr(port_executor, "_DATA_CACHE_CAP", 1)
        _port_mesh(node, "t", {"query": {"range": {"price": {"lt": 50}}}})
        memo = sum(rd.nbytes for rd in ex._prep.values())
        assert len(ex._data) == 1
        assert fd.used == base + ex.data_bytes() + memo
        # the memo still holds the first body's round, but none of the
        # copies it read: they were released with their charge
        assert len(ex._prep) == 2
        _check_memo_pins_no_copy(ex)
        # run again from the memo, the round makes its copies anew,
        # charged, and answers as before
        kernels.reset()
        again = _port_mesh(node, "t", fox)
        snap = kernels.snapshot()
        assert snap.get("executor_prep_hit") == 1, snap
        assert snap.get("executor_data_miss"), snap
        assert fd.used == base + ex.data_bytes() + memo
        _check_memo_pins_no_copy(ex)
        _check_host(again, _port_host(node, "t", fox, monkeypatch),
                    exact=False)
        node.close()
        # the executor's copies and memo: nothing stays charged. Columns
        # load lazily and stacking reads their host mirrors, so nothing
        # was charged at freeze (``base``), as in the reference
        assert base == 0 and fd.used == 0
    finally:
        node.close()


def test_a_failure_after_launch_raises(nodes, monkeypatch):
    """No except in the mesh path sends a launched round to the host
    loop: a fault in the round's ops reaches the caller."""
    _ref, port, x = nodes

    def broken(*a, **kw):
        raise RuntimeError("injected fault")

    monkeypatch.setattr(port_scoring, "bm25_score_runs", broken)
    kernels.reset()
    with pytest.raises(RuntimeError, match="injected fault"):
        _search(port, "docs", {"query": {"match": {"body": "zulu fox"}}})
    assert not kernels.snapshot().get("mesh_fallback_total")


def _converted_segment(residency, n, seed):
    """A segment built from arrays whose term dictionary holds a term
    with no postings ('ghost'), as a segment carried across from another
    index can."""
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    rng = np.random.default_rng(seed)
    tf = rng.integers(1, 4, n).astype(np.float32)
    rare = np.sort(rng.choice(n, 20, replace=False)).astype(np.int32)
    doc_ids = np.concatenate([np.arange(n, dtype=np.int32), rare])
    tfs = np.concatenate([tf, np.ones(20, np.float32)])
    tfn = (tfs * 2.2 / (tfs + 1.2)).astype(np.float32)
    return segment_from_arrays({
        "num_docs": n, "max_docs": 256, "ids": [f"{seed}-{i}"
                                                for i in range(n)],
        "fields": {"body": {
            "terms": ["common", "rare", "ghost"],
            "df": np.array([n, 20, 0], np.int32),
            "cf": np.array([int(tf.sum()), 20, 0], np.int64),
            "offsets": np.array([0, n, n + 20, n + 20], np.int64),
            "doc_ids_host": doc_ids, "tfnorm_host": tfn, "tf_host": tfs,
            "avg_len": 3.0, "num_docs": n, "total_terms": 3 * n}}},
        residency)


def test_term_without_postings_keeps_the_b1_route(monkeypatch):
    """A present term with an empty run leaves a group pure-dense on both
    paths (fused_bm25_topk's test): both run B1, with the same bits."""
    node = Node(name="ghost", device="cpu")
    try:
        node.create_index("g", {"settings": {"number_of_shards": 2},
                                "mappings": DENSE_MAPPING})
        svc = node.get_index("g")
        for s in range(2):
            svc.shards[s].engine.add_segment(
                _converted_segment(node.residency, 200 + s, seed=s))
        body = {"query": {"match": {"body": "common ghost"}}, "size": 15}
        mesh = _port_mesh(node, "g", body)
        assert kernels.snapshot().get("bm25_fused_topk") == 2
        host = _port_host(node, "g", body, monkeypatch)
        _check_host(mesh, host, exact=True)
        assert mesh["hits"]["total"] == 401
    finally:
        node.close()


def test_empty_slots_answer_as_the_host_loop(monkeypatch):
    """An index without a segment, then one with more shards than
    documents (empty slots in the round): the mesh answers as the host
    loop does."""
    node = Node(name="empty", device="cpu")
    try:
        node.create_index("r", {"settings": {"number_of_shards": 6},
                                "mappings": MAPPING})
        body = {"query": {"match": {"body": "quick fox"}}, "size": 4}
        empty = _port_mesh(node, "r", body)
        assert empty == dict(_port_host(node, "r", body, monkeypatch),
                             took=empty["took"])
        for doc_id, src in corpus(4, seed=2):
            node.index("r", doc_id, src)
        node.refresh("r")
        assert sum(not sh.segments for sh in node.get_index("r").shards)
        for b in (body, {"query": {"match_all": {}}},
                  {"query": {"range": {"price": {"gte": 0}}}}):
            _check_host(_port_mesh(node, "r", b),
                        _port_host(node, "r", b, monkeypatch), exact=False)
    finally:
        node.close()


def test_mixed_round_b1_and_generic_slots(monkeypatch):
    """One round where some slots are pure-dense (B1) and others carry a
    tail term (the generic route): each slot answers as the host loop
    answers its shard, B1's slots with the same bits."""
    node = Node(name="mixed", device="cpu")
    try:
        node.create_index("m", {"settings": {"number_of_shards": 4},
                                "mappings": DENSE_MAPPING})
        docs = _dense_docs()[:600]
        # 'zebra' in two docs: a tail term in at most two shards
        docs[7] = ("7", {"body": "common zebra kiwi", "tag": "x"})
        docs[300] = ("300", {"body": "zebra zebra emu", "tag": "y"})
        for doc_id, src in docs:
            node.index("m", doc_id, src)
        node.refresh("m")
        body = {"query": {"match": {"body": "common zebra"}}, "size": 12}
        mesh = _port_mesh(node, "m", body)
        snap = kernels.snapshot()
        assert 1 <= snap.get("bm25_fused_topk", 0) <= 3, snap
        assert snap.get("bm25_hybrid"), snap
        assert {"7", "300"} <= set(_ids(mesh))
        _check_host(mesh, _port_host(node, "m", body, monkeypatch),
                    exact=False)
    finally:
        node.close()
