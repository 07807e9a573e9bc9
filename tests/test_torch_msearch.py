"""Batched ``_msearch`` in the port (``search/batch.py``) against the
reference's ``Node.msearch`` and against the port's own sequential
``Node.search``, on one seeded corpus indexed by both packages.

Indices (the same documents in both packages, the dense-block df bar
dropped to 8 on both, as ``tests/unit/test_msearch_batch.py`` does, so
that the small corpus has dense rows and rare tail terms):
- ``mx``: two shards pinned to the host tiers (``index.search.mesh:
  false``): tier 1 (kernel B1's batched form) and tier 2 (the f32
  product plus the tails' scatters), segment by segment;
- ``mm``: two shards on the mesh: the batched postings round
  (``executor.search_terms``);
- ``vx``: one shard with a dense_vector field: batched brute-force kNN
  and MaxSim (kernel B2 over every request's tokens), and ``hybrid``
  bodies, which run in sequence.

Bars. Tier 1 against the reference: the fused-path bar (total exact,
scores at rtol 5e-3, recall@k >= 0.95), since the reference's CPU
dispatcher scores in f32 where B1 rounds to bf16 (ROADMAP C, "By
design, fused-path scores"); against the port's sequential path (B1's
rows form): scores within rtol 1e-6, ids equal outside near-ties.
Everything else: the same ids in the same order, exact totals, scores
at rtol 1e-5; pure-dense members of a tier-2 batch against the port's
sequential B1 path at the fused-path bar.

The reference's AOT executable cache is patched off (ROADMAP C,
reference note).
"""
import copy
import functools
import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.monitor import kernels as ref_kernels
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import queries as port_queries
from elasticsearch_tpu_torch.search.batch import (execute_batch,
                                                  knn_topk_fused_batch)

from _torch_parity import clustered

VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"]
DIMS = 8
TEXT = {"properties": {"body": {"type": "text"}}}
VEC = {"properties": {"body": {"type": "text"}, "v": {
    "type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _docs(n=240):
    rng = np.random.default_rng(11)
    x = clustered(n, DIMS, 5, seed=23)
    docs = []
    for i in range(n):
        # frequent head words, a mid word, a rare per-doc tail word
        words = list(rng.choice(VOCAB[:4], size=int(rng.integers(3, 8)))) \
            + [VOCAB[4 + int(rng.integers(0, 6))], f"rare{i % 37}"]
        docs.append((str(i), {"body": " ".join(words)}, x[i]))
    return x, docs


def _load(ref, port, name, shards, mapping, docs, mesh=True, vec=False):
    idx = {"number_of_shards": shards}
    if not mesh:
        idx["search"] = {"mesh": "false"}
    body = {"settings": {"index": idx}, "mappings": mapping}
    ref.create_index(name, copy.deepcopy(body))
    port.create_index(name, copy.deepcopy(body))
    svc = ref.indices[name]
    for doc_id, src, v in docs:
        if vec:
            src = dict(src, v=[float(a) for a in v])
        svc.index_doc(doc_id, src)
        port.index(name, doc_id, src)
    svc.refresh()
    port.refresh(name)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.index import segment as ref_seg
    from elasticsearch_tpu.parallel import aot
    from elasticsearch_tpu_torch.index import segment as port_seg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        for mod in (ref_seg, port_seg):
            mp.setattr(mod, "build_dense_impact", functools.partial(
                mod.build_dense_impact, df_threshold=8))
        ref = RefNode(name="ref")
        port = Node(name="port", device="cpu")
        x, docs = _docs()
        _load(ref, port, "mx", 2, TEXT, docs, mesh=False)
        _load(ref, port, "mm", 2, TEXT, docs)
        _load(ref, port, "vx", 1, VEC, docs, vec=True)
        # first searches build the dense blocks under the patched bar
        for n in (ref, port):
            for name in ("mx", "mm", "vx"):
                n.search(name, {"query": {"match": {"body": "alpha"}}})
    yield ref, port, x
    ref.close()
    port.close()


def _body(q, size=10, **kw):
    return dict({"query": {"match": {"body": q}}, "size": size}, **kw)


TIER1 = [_body("alpha beta"), _body("gamma", 7), _body("beta delta", 5,
                                                        **{"from": 3}),
         _body("alpha gamma delta"), _body("epsilon alpha"),
         _body("zeta eta", 12)]
TIER2 = [_body("alpha rare1"), _body("beta rare5 rare9", 6),
         _body("gamma rare20"), _body("delta rare3 alpha", 4, **{"from": 2}),
         _body("theta"), _body("rare7 iota")]


def _pairs(index, bodies):
    return [({"index": index}, copy.deepcopy(b)) for b in bodies]


def _ids(r):
    return [h["_id"] for h in r["hits"]["hits"]]


def _scores(r):
    return np.array([h["_score"] for h in r["hits"]["hits"]], np.float64)


def _same(p, r, rtol=1e-5):
    """The same ids in the same order, exact totals, scores at rtol, and
    every other field of the response and its hits equal."""
    assert p["hits"]["total"] == r["hits"]["total"]
    assert p["_shards"] == r["_shards"]
    assert _ids(p) == _ids(r)
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=rtol)
    for hp, hr in zip(p["hits"]["hits"], r["hits"]["hits"]):
        assert hp == dict(hr, _score=hp["_score"])
    if r["hits"]["max_score"] is None:
        assert p["hits"]["max_score"] is None
    else:
        np.testing.assert_allclose(p["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=rtol)


def _near(p, r, rtol=1e-6):
    """``chip_smoke.check_hits``'s rule: exact totals, scores at rtol, ids
    equal outside groups of near-equal scores."""
    assert p["hits"]["total"] == r["hits"]["total"]
    assert len(_ids(p)) == len(_ids(r))
    ps, rs = _scores(p), _scores(r)
    np.testing.assert_allclose(ps, rs, rtol=rtol)
    for j, (a, b) in enumerate(zip(_ids(p), _ids(r))):
        tied = any(abs(rs[j] - rs[n]) <= rtol * abs(rs[j])
                   for n in (j - 1, j + 1) if 0 <= n < len(rs))
        assert a == b or tied, (j, a, b)


def _fused_bar(p, r, top_p, top_r):
    """The fused-path bar: exact total, scores at rtol 5e-3, recall of
    the first from+size hits >= 0.95 (``top_*``: the same body at from 0)."""
    assert p["hits"]["total"] == r["hits"]["total"]
    assert len(_ids(p)) == len(_ids(r))
    np.testing.assert_allclose(_scores(p), _scores(r), rtol=5e-3)
    rid = _ids(top_r)
    if rid:
        assert len(set(_ids(top_p)) & set(rid)) / len(rid) >= 0.95


def _top(body):
    return dict(body, size=body.get("from", 0) + body.get("size", 10),
                **{"from": 0})


def _port_msearch(port, index, bodies):
    kernels.reset()
    out = port.msearch(_pairs(index, bodies))["responses"]
    return out, kernels.snapshot()


def _ref_msearch(ref, index, bodies):
    ref_kernels.reset()
    out = ref.msearch(_pairs(index, bodies))["responses"]
    return out, ref_kernels.snapshot()


@pytest.mark.parametrize("i", range(len(TIER1)))
def test_tier1_matches_reference_and_sequential(nodes, i):
    ref, port, _ = nodes
    got, snap = _port_msearch(port, "mx", TIER1)
    # one B1 launch a segment for the whole batch, nothing generic
    assert snap.get("bm25_fused_topk", 0) >= len(TIER1), snap
    assert not snap.get("bm25_hybrid") and not snap.get("bm25_scatter")
    want, rsnap = _ref_msearch(ref, "mx", TIER1)
    assert rsnap.get("bm25_fused_topk", 0) >= len(TIER1), rsnap
    body = TIER1[i]
    tops, _ = _port_msearch(port, "mx", [_top(b) for b in TIER1])
    rtops, _ = _ref_msearch(ref, "mx", [_top(b) for b in TIER1])
    _fused_bar(got[i], want[i], tops[i], rtops[i])
    _near(got[i], port.search("mx", copy.deepcopy(body)))


def test_tier1_is_one_batched_launch_a_segment(nodes, monkeypatch):
    """Tier 1 calls B1's batched form once a segment, all rows of the
    dense block at once with the hit count, and its count is the
    response's total."""
    _ref, port, _ = nodes
    calls = []
    real = port_queries.bm25_dense_topk

    def spy(qw, impact, mask, **kw):
        calls.append((tuple(qw.shape), tuple(impact.shape), kw))
        return real(qw, impact, mask, **kw)

    monkeypatch.setattr(port_queries, "bm25_dense_topk", spy)
    got, _ = _port_msearch(port, "mx", TIER1)
    svc = port.get_index("mx")
    n_segs = sum(len(sh.segments) for sh in svc.shards)
    assert len(calls) == n_segs
    for (Q, F), (F2, _D), kw in calls:
        assert Q == len(TIER1) and F == F2
        assert kw.get("rows") is None and kw["count"] and kw["packed"]
    monkeypatch.undo()
    for b, r in zip(TIER1, got):
        assert r["hits"]["total"] == port.search(
            "mx", copy.deepcopy(b))["hits"]["total"]


@pytest.mark.parametrize("i", range(len(TIER2)))
def test_tier2_matches_reference_and_sequential(nodes, i):
    ref, port, _ = nodes
    got, snap = _port_msearch(port, "mx", TIER2)
    assert snap.get("bm25_hybrid", 0) >= len(TIER2), snap
    assert not snap.get("bm25_fused_topk"), snap
    want, rsnap = _ref_msearch(ref, "mx", TIER2)
    assert rsnap.get("bm25_hybrid", 0) >= len(TIER2), rsnap
    _same(got[i], want[i])
    kernels.reset()
    seq = port.search("mx", copy.deepcopy(TIER2[i]))
    if kernels.snapshot().get("bm25_fused_topk"):
        # pure-dense on a segment ("theta" everywhere): f32 in the batch,
        # B1's bf16 alone
        _fused_bar(got[i], seq, got[i], seq)
    else:
        _same(got[i], seq)


def test_tier2_takes_queries_without_dense_terms(nodes):
    """A query whose terms are all rare rides tier 2 with a zero dense
    row (the reference sends the whole batch to its sequential path);
    the answers are the same."""
    ref, port, _ = nodes
    bodies = TIER2 + [_body("rare11 rare12"), _body("nosuchword")]
    got, snap = _port_msearch(port, "mx", bodies)
    assert snap.get("bm25_hybrid", 0) >= len(bodies), snap
    want, _ = _ref_msearch(ref, "mx", bodies)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[-1]["hits"]["total"] == 0 and not got[-1]["hits"]["hits"]


def test_tier2_refuses_a_tf32_product(nodes, monkeypatch):
    """Tier 2 needs an f32 product: with TF32 on the card's matmul it
    refuses, and the batch runs per request (the same answers)."""
    from elasticsearch_tpu_torch.ops import scoring

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert scoring.f32_matmul_exact("cpu")
    assert not scoring.f32_matmul_exact("cuda")
    monkeypatch.setattr(port_queries, "f32_matmul_exact", lambda d: False)
    _ref, port, _ = nodes
    got, snap = _port_msearch(port, "mx", TIER2)
    assert snap.get("bm25_hybrid_tf32_refused", 0) >= 1, snap
    monkeypatch.undo()
    for b, g in zip(TIER2, got):
        _same(g, port.search("mx", copy.deepcopy(b)), rtol=0)


def test_unbatchable_items_run_sequentially(nodes, monkeypatch):
    from elasticsearch_tpu_torch.search import batch

    ref, port, _ = nodes
    bodies = [_body("alpha", 5),
              {"query": {"match": {"body": {"query": "alpha beta",
                                            "operator": "and"}}},
               "size": 5}]
    calls = []
    monkeypatch.setattr(batch, "execute_batch",
                        lambda *a, **kw: calls.append(a))
    got, _ = _port_msearch(port, "mx", bodies)
    monkeypatch.undo()
    assert not calls  # one eligible item: nothing to batch
    want, _ = _ref_msearch(ref, "mx", bodies)
    for b, g, w in zip(bodies, got, want):
        assert g["hits"]["total"] > 0
        seq = port.search("mx", copy.deepcopy(b))
        _near(g, seq, rtol=0)
        _fused_bar(g, w, g, w) if b is bodies[0] else _same(g, w)


@pytest.mark.parametrize("odd", ["bool", "version"])
def test_partial_batching_around_an_ineligible_item(nodes, odd):
    """An item the batch cannot take (a bool query, a ``version`` key)
    runs on its own; the others still share tier 1."""
    ref, port, _ = nodes
    bodies = TIER1[:3]
    item = ({"query": {"bool": {"must": [{"match": {"body": "alpha"}}],
                                "should": [{"match": {"body": "rare3"}}]}},
             "size": 6} if odd == "bool"
            else dict(_body("gamma", 4), version=True))
    bodies = bodies[:1] + [item] + bodies[1:]
    got, snap = _port_msearch(port, "mx", bodies)
    assert snap.get("bm25_fused_topk", 0) >= 3, snap
    seq = port.search("mx", copy.deepcopy(item))
    assert json.dumps(dict(got[1], took=0)) == json.dumps(dict(seq, took=0))
    if odd == "bool":
        want, _ = _ref_msearch(ref, "mx", bodies)
        _same(got[1], want[1])
    for i in (0, 2, 3):
        _near(got[i], port.search("mx", copy.deepcopy(bodies[i])))


@pytest.mark.parametrize("bad", ["two_keys", "missing_index"])
def test_malformed_item_entries_match_the_reference(nodes, bad):
    ref, port, _ = nodes
    if bad == "two_keys":
        pairs = _pairs("mx", TIER1[:2]) + [({"index": "mx"}, {
            "query": {"match": {"body": "a"}, "term": {"body": "b"}}})]
    else:
        pairs = _pairs("mx", TIER1[:2]) + [({"index": "nope"},
                                            TIER1[0])]
    kernels.reset()
    got = port.msearch(copy.deepcopy(pairs))["responses"]
    want = ref.msearch(copy.deepcopy(pairs))["responses"]
    assert got[2] == want[2]
    assert got[2]["status"] == (400 if bad == "two_keys" else 404)
    # the item alone takes the per-item error path: the same entry
    assert port.msearch(copy.deepcopy(pairs[2:]))["responses"][0] == got[2]
    if bad == "two_keys":
        assert kernels.snapshot().get("bm25_fused_topk", 0) >= 2


MESH = TIER2 + [_body("alpha beta"), _body("kappa rare30", 15)]


@pytest.mark.parametrize("i", range(len(MESH)))
def test_mesh_msearch_matches_reference_mesh_and_host_tiers(nodes, i,
                                                            monkeypatch):
    ref, port, _ = nodes
    got, snap = _port_msearch(port, "mm", MESH)
    assert snap.get("mesh_msearch") == 1, snap
    assert not snap.get("mesh_msearch_fallback"), snap
    assert not snap.get("bm25_fused_topk"), snap  # never B1 on this round
    want, rsnap = _ref_msearch(ref, "mm", MESH)
    assert rsnap.get("mesh_msearch") == 1, rsnap
    _same(got[i], want[i])
    monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    host, hsnap = _port_msearch(port, "mm", MESH)
    monkeypatch.delenv("ESTPU_DISABLE_MESH")
    assert not hsnap.get("mesh_msearch") and hsnap.get("bm25_hybrid")
    _same(got[i], host[i])


def test_mesh_round_agrees_with_per_query_scatter(nodes):
    """The round's compact postings scatter equals each query's BM25 sum
    spelled out in numpy, bit for bit: the same f32 products, added to
    each doc in chunk order."""
    from elasticsearch_tpu_torch.ops.scoring import bm25_score_batch
    from elasticsearch_tpu_torch.parallel.executor import _chunk_table

    _ref, port, _ = nodes
    seg = port.get_index("mm").shards[0].segments[0]
    inv = seg.inverted["body"]
    qterms = [[("alpha", 1.0), ("rare3", 2.0)], [("beta", 1.0)], [],
              [("rare5", 1.0), ("gamma", 1.5), ("nosuch", 1.0)]]
    tabs = [_chunk_table(seg, "body", t) for t in qterms]
    T = max(len(t[0]) for t in tabs) or 1
    st, ln, ws = (np.zeros((len(tabs), T), dt)
                  for dt in (np.int32, np.int32, np.float32))
    for q, (a, b, c) in enumerate(tabs):
        st[q, :len(a)], ln[q, :len(b)], ws[q, :len(c)] = a, b, c
    got = bm25_score_batch(inv.doc_ids, inv.tfnorm, st, ln, ws,
                           D=seg.max_docs)
    docs, tfn = inv.doc_ids.numpy(), inv.tfnorm.numpy()
    for q in range(len(tabs)):
        want = np.zeros(seg.max_docs, np.float32)
        for t in range(T):
            for j in range(st[q, t], st[q, t] + ln[q, t]):
                want[docs[j]] += np.float32(tfn[j] * ws[q, t])
        assert np.array_equal(got[q].numpy(), want)


def _knn_body(x, i, tokens=1, size=10, **kw):
    rng = np.random.default_rng(100 + i)
    v = x[(7 * i) % len(x)] + 0.1 * rng.standard_normal(DIMS)
    if tokens > 1:
        v = [list(map(float, v + 0.2 * rng.standard_normal(DIMS)))
             for _ in range(tokens)]
        return {"query": {"knn": dict({"field": "v", "query_vectors": v},
                                      **kw)}, "size": size}
    return {"query": {"knn": dict({"field": "v", "query_vector": [
        float(a) for a in v]}, **kw)}, "size": size}


@pytest.mark.parametrize("tokens", [1, 2, 8])
def test_knn_batch_matches_reference_and_sequential(nodes, tokens):
    """One B2 pass over every request's tokens: held against the
    reference's ``knn_topk_fused_batch`` on the same segment and against
    the port's sequential path."""
    from elasticsearch_tpu.search.batch import \
        knn_topk_fused_batch as ref_batch
    from elasticsearch_tpu.search.context import \
        SegmentContext as RefContext
    from elasticsearch_tpu.search.queries import parse_query as ref_parse
    from elasticsearch_tpu_torch.search.context import SegmentContext
    from elasticsearch_tpu_torch.search.queries import parse_query

    ref, port, x = nodes
    bodies = [_knn_body(x, i, tokens) for i in range(6)]
    got, snap = _port_msearch(port, "vx", bodies)
    assert snap.get("knn_fused_batch") == len(bodies), snap
    for b, g in zip(bodies, got):
        _same(g, port.search("vx", copy.deepcopy(b)))
    rsvc, psvc = ref.indices["vx"], port.get_index("vx")
    rseg = rsvc.groups[0].copies[0].searcher.segments[0]
    pseg = psvc.shards[0].segments[0]
    want = ref_batch(RefContext(rseg, rsvc.mappings, rsvc.analysis),
                     [ref_parse(b["query"]) for b in bodies], 10)
    mine = knn_topk_fused_batch(
        SegmentContext(pseg, psvc.mappings, psvc.analysis),
        [parse_query(b["query"]) for b in bodies], 10)
    np.testing.assert_array_equal(mine[1], np.asarray(want[1]))
    np.testing.assert_allclose(mine[0], np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(mine[2], np.asarray(want[2]))
    rgot, _ = _ref_msearch(ref, "vx", bodies)
    for g, w in zip(got, rgot):
        _same(g, w)


@pytest.mark.parametrize("tier", ["tier1", "maxsim"])
def test_batches_past_one_launch_match_one_launch(nodes, monkeypatch,
                                                  tier):
    """A batch of more query rows than one launch of B1 or B2 takes (2048
    MaxSim bodies of 32 tokens are 65,536 rows, one past the grid's
    limit) runs in slices: the batch still serves every body, with the
    responses of one launch."""
    from elasticsearch_tpu_torch.utils import shapes

    _ref, port, x = nodes
    if tier == "tier1":
        index, bodies, key = "mx", TIER1, "bm25_fused_topk"
    else:
        index, key = "vx", "knn_fused_batch"
        bodies = [_knn_body(x, i, 8) for i in range(6)]
    whole, _ = _port_msearch(port, index, bodies)
    monkeypatch.setattr(shapes, "MAX_QUERY_ROWS", 4)
    got, snap = _port_msearch(port, index, bodies)
    assert snap.get(key, 0) >= len(bodies), snap
    assert [g["hits"] for g in got] == [w["hits"] for w in whole]


def test_knn_batch_keeps_the_sequential_candidate_count(nodes):
    """A page wider than num_candidates: the batch keeps the knn's own
    kc = max(num_candidates, k), as the sequential path does."""
    _ref, port, x = nodes
    bodies = [_knn_body(x, i, size=30, num_candidates=12) for i in range(3)]
    got, snap = _port_msearch(port, "vx", bodies)
    assert snap.get("knn_fused_batch") == 3, snap
    for b, g in zip(bodies, got):
        seq = port.search("vx", copy.deepcopy(b))
        assert g["hits"]["total"] == 12
        _same(g, seq)


def test_knn_buckets_split_on_num_candidates(nodes):
    _ref, port, x = nodes
    bodies = [_knn_body(x, i) for i in range(3)] + \
        [_knn_body(x, 9, num_candidates=40)]
    got, snap = _port_msearch(port, "vx", bodies)
    assert snap.get("knn_fused_batch") == 3, snap
    for b, g in zip(bodies, got):
        _same(g, port.search("vx", copy.deepcopy(b)))


def test_hybrid_bodies_run_in_sequence(nodes):
    ref, port, x = nodes
    bodies = [{"query": {"hybrid": {
        "query": {"match": {"body": q}},
        "knn": {"field": "v", "query_vector": _knn_body(
            x, i)["query"]["knn"]["query_vector"]}}}, "size": 8}
        for i, q in enumerate(["alpha rare3", "beta", "gamma delta"])]
    got, snap = _port_msearch(port, "vx", bodies)
    assert not snap.get("knn_fused_batch"), snap
    want, _ = _ref_msearch(ref, "vx", bodies)
    for b, g, w in zip(bodies, got, want):
        assert json.dumps(dict(g, took=0)) == json.dumps(dict(
            port.search("vx", copy.deepcopy(b)), took=0))
        _same(g, w, rtol=1e-6)


def test_execute_batch_answers_every_body_in_order(nodes):
    _ref, port, _ = nodes
    svc = port.get_index("mx")
    bodies = TIER1 + TIER1[:2]
    out = execute_batch(svc, copy.deepcopy(bodies))
    assert len(out) == len(bodies)
    assert json.dumps(dict(out[0], took=0)) == json.dumps(
        dict(out[-2], took=0))
    assert execute_batch(svc, [{"query": {"match": {"body": "a"}},
                                "size": 0}]) is None


@pytest.mark.parametrize("fault", ["breaker", "device"])
def test_batch_refusal_and_fault(nodes, monkeypatch, fault):
    """A typed refusal inside the batch (a breaker denial) sends every
    item through its own search; an untyped fault propagates, since a
    fallback would hide it."""
    from elasticsearch_tpu_torch.search import batch
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException

    _ref, port, _ = nodes
    err = (CircuitBreakingException("[request] Data too large")
           if fault == "breaker" else RuntimeError("device fault"))

    def boom(*a, **kw):
        raise err

    monkeypatch.setattr(batch, "execute_batch", boom)
    if fault == "device":
        with pytest.raises(RuntimeError, match="device fault"):
            port.msearch(_pairs("mx", TIER1[:3]))
        return
    got = port.msearch(_pairs("mx", TIER1[:3]))["responses"]
    monkeypatch.undo()
    for b, g in zip(TIER1, got):
        assert json.dumps(dict(g, took=0)) == json.dumps(dict(
            port.search("mx", copy.deepcopy(b)), took=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_stable_is_the_stable_sort_prefix(seed):
    """The batch tiers' key top-k: the first k of a stable descending
    sort, ties by index, -inf last, -0.0 tied with 0.0."""
    from elasticsearch_tpu_torch.ops.scoring import topk_stable

    g = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(7, 5000, generator=g) * 4) / 4  # ties
    x[:, ::5] = float("-inf")
    x[1] = float("-inf")
    x[2, :300] = -0.0
    x[2, 300:] = 0.0
    for k in (1, 10, 100, 5000):
        v, i = topk_stable(x, k)
        sv, si = torch.sort(x + 0.0, dim=1, descending=True, stable=True)
        assert torch.equal(i, si[:, :k].to(torch.int32))
        assert torch.equal(v, sv[:, :k])


def test_mesh_msearch_with_empty_shards():
    """Shards without a segment leave their slots empty: their -inf
    entries never become candidates."""
    port = Node(device="cpu")
    port.create_index("few", {"settings": {"index": {"number_of_shards": 6}},
                              "mappings": TEXT})
    for i, words in enumerate(["alpha beta", "beta", "alpha gamma"]):
        port.index("few", str(i), {"body": words})
    port.refresh("few")
    svc = port.get_index("few")
    assert sum(1 for sh in svc.shards if not sh.segments) >= 3
    bodies = [_body("alpha"), _body("beta gamma"), _body("delta")]
    got, snap = _port_msearch(port, "few", bodies)
    assert snap.get("mesh_msearch") == 1, snap
    for b, g in zip(bodies, got):
        _same(g, port.search("few", copy.deepcopy(b)))
    assert got[2]["hits"]["total"] == 0
    port.close()
