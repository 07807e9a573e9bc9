"""The term-range split of an oversized field's postings
(``parallel/postings_shard.py``), port against reference.

The split threshold is lowered to one posting in both packages, so the
test corpus's ``body`` field is oversized. The reference splits over its
eight virtual CPU devices; the port takes an explicit ``n_devices=8``
(eight slots on one device), built before the first search. The split's
``bounds`` and ``bases`` equal the reference's arrays; searches through
it give the hits and totals of the unsplit port path and of the
reference, scores within the generic BM25 bar (the slots' partials add
in slot order, the unsplit path's chunks in term order).
"""
import numpy as np
import pytest

from elasticsearch_tpu.monitor import kernels as ref_kernels
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.parallel import aot
from elasticsearch_tpu.parallel import placement as ref_placement
from elasticsearch_tpu.parallel import postings_shard as ref_ps
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel import placement, postings_shard

#: tests/test_torch_slice.py's bar for the generic path's scores
SCORE_RTOL = 1e-5

DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "quick thinking wins the race every time",
    "a lazy afternoon by the river bank",
    "dogs and foxes are distant cousins",
    "the race was over before it began",
    "brown bears fish in the river",
    "time and tide wait for no dog",
    "every fox knows the quick paths",
    "banks close early on lazy sundays",
    "cousins of the brown dog race foxes",
] * 6  # 60 docs: several multi-doc posting runs

QUERIES = [
    {"match": {"body": "quick fox"}},
    {"match": {"body": {"query": "lazy dog river", "operator": "and"}}},
    {"match": {"body": {"query": "brown race time",
                        "minimum_should_match": 2}}},
    {"bool": {"must": [{"match": {"body": "fox"}}],
              "must_not": [{"match": {"body": "river"}}]}},
]


def _make(cls, **kw):
    n = cls(**kw)
    n.create_index("ps", {"settings": {"index": {"number_of_shards": 1}},
                          "mappings": {"properties": {
                              "body": {"type": "text"}}}})
    svc = n.indices["ps"]
    for i, t in enumerate(DOCS):
        svc.index_doc(str(i), {"body": t})
    svc.refresh()
    return n


def _inv(node):
    return node.indices["ps"].shards[0].segments[0].inverted["body"]


def _stacked(split):
    """Every range's (doc ids, tfnorm) stacked in slot order, as the
    reference's ``[S, L]`` arrays."""
    parts = [split.slot_arrays(s) for s in range(split.S)]
    return (np.stack([d.cpu().numpy() for d, _ in parts]),
            np.stack([t.cpu().numpy() for _, t in parts]))


@pytest.fixture()
def nodes(monkeypatch):
    """(reference, port) nodes whose ``body`` field is oversized; the
    port's split has eight slots."""
    monkeypatch.setattr(aot, "_ENABLED", False)
    monkeypatch.setattr(ref_ps, "POSTINGS_SHARD_NNZ", 1)
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    ref = _make(RefNode)
    port = _make(Node, device="cpu")
    assert _inv(port).postings_split(n_devices=8) is not None
    yield ref, port
    ref.close()
    port.close()


def test_split_bounds_and_bases_equal_the_references(nodes):
    ref, port = nodes
    rs, ps = _inv(ref).postings_split(), _inv(port).postings_split()
    assert ps.S == rs.S == 8
    np.testing.assert_array_equal(ps.bounds, rs.bounds)
    np.testing.assert_array_equal(ps.bases, rs.bases)
    assert ps.L == rs.L
    sizes = [int(ps.bounds[s + 1] - ps.bounds[s]) for s in range(ps.S)]
    assert sum(sizes) == len(_inv(port).terms)
    # every slot holds its range's postings, padded with the sentinel
    doc_ids, tfnorm = _stacked(ps)
    np.testing.assert_array_equal(doc_ids, np.asarray(rs.doc_ids_sh))
    np.testing.assert_array_equal(tfnorm, np.asarray(rs.tfnorm_sh))


def test_split_search_matches_unsplit_and_reference(nodes, monkeypatch):
    ref, port = nodes
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1 << 30)
    unsplit = _make(Node, device="cpu")
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    try:
        before = kernels.snapshot().get("bm25_postings_sharded", 0)
        ref_before = ref_kernels.snapshot().get("bm25_postings_sharded", 0)
        for q in QUERIES:
            body = {"query": q, "size": 20}
            a = port.search("ps", body)
            r = ref.search("ps", body)
            monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ",
                                1 << 30)
            b = unsplit.search("ps", body)
            monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
            for other in (b, r):
                assert [h["_id"] for h in a["hits"]["hits"]] == \
                    [h["_id"] for h in other["hits"]["hits"]], q
                assert a["hits"]["total"] == other["hits"]["total"], q
                np.testing.assert_allclose(
                    [h["_score"] for h in a["hits"]["hits"]],
                    [h["_score"] for h in other["hits"]["hits"]],
                    rtol=SCORE_RTOL)
        assert kernels.snapshot().get("bm25_postings_sharded", 0) > before
        assert ref_kernels.snapshot().get("bm25_postings_sharded", 0) > \
            ref_before
    finally:
        unsplit.close()


def test_mesh_declines_an_oversized_field(nodes):
    """The mesh's [S, ...] stacking cannot hold a split field: both
    packages serve such an index on the host loop and count a
    fallback."""
    ref, port = nodes
    for node, kmod in ((ref, ref_kernels), (port, kernels)):
        before = kmod.snapshot().get("mesh_fallback_total", 0)
        node.search("ps", {"query": {"match": {"body": "fox"}}})
        assert kmod.snapshot().get("mesh_fallback_total", 0) > before


def test_oversized_freeze_keeps_postings_on_the_host(nodes):
    """The freeze leaves an oversized field's postings on the host; the
    segment's accounting does not place them; a first explicit use
    places and keeps them, as in the reference."""
    ref, port = nodes
    seg = port.indices["ps"].shards[0].segments[0]
    inv = seg.inverted["body"]
    raws = [f"_{nm}_raw" for nm in ("doc_ids", "tf", "tfnorm", "term_ids")]
    for r in raws:
        assert isinstance(inv.__dict__[r], np.ndarray), r
        assert isinstance(_inv(ref).__dict__[r], np.ndarray), r
    assert inv.nnz_pad == _inv(ref).nnz_pad >= inv.nnz
    seg.memory_bytes()
    for r in raws:
        assert isinstance(inv.__dict__[r], np.ndarray), r
    dev = inv.doc_ids
    assert not isinstance(inv.__dict__["_doc_ids_raw"], np.ndarray)
    assert inv.doc_ids is dev
    np.testing.assert_array_equal(dev.numpy(), np.asarray(_inv(ref).doc_ids))


@pytest.mark.parametrize("with_counts,all_positive",
                         [(True, True), (False, True), (False, False)])
def test_split_term_group_numeric_oracle(nodes, with_counts, all_positive):
    """The split's scores and matches equal a numpy BM25 over the same
    postings, and the reference split's."""
    ref, port = nodes
    inv = _inv(port)
    D = port.indices["ps"].shards[0].segments[0].max_docs
    terms = ["fox", "river", "nonesuch"]
    weights = [2.0, 0.5 if all_positive else -0.5, 1.0]
    scores, matched, n_present = inv.postings_split().term_group(
        terms, weights, with_counts=with_counts, all_positive=all_positive,
        D=D)
    rscores, rmatched, rn = _inv(ref).postings_split().term_group(
        terms, weights, with_counts=with_counts, all_positive=all_positive,
        D=D)
    assert n_present == rn == 2
    exp = np.zeros(D, np.float32)
    cnt = np.zeros(D, np.int32)
    for t, w in zip(terms[:2], weights[:2]):
        tid = inv.vocab[t]
        lo, hi = int(inv.offsets[tid]), int(inv.offsets[tid + 1])
        for j in range(lo, hi):
            exp[inv.doc_ids_host[j]] += inv.tfnorm_host[j] * w
            cnt[inv.doc_ids_host[j]] += 1
    np.testing.assert_allclose(scores.numpy(), exp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores),
                               rtol=1e-5, atol=1e-6)
    want = cnt if with_counts else (exp > 0 if all_positive else cnt > 0)
    np.testing.assert_array_equal(matched.numpy(), want)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(rmatched))


def test_one_slot_declines_and_the_host_loop_serves(monkeypatch):
    """Without ``n_devices`` the split takes one slot a card, one on the
    CPU: it declines, as the reference's does on one device, and the host
    loop scores the oversized field from its unsplit postings."""
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    port = _make(Node, device="cpu")
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1 << 30)
    small = _make(Node, device="cpu")
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    try:
        assert _inv(port).postings_split() is None
        assert _inv(port)._pshard is False
        body = {"query": QUERIES[0], "size": 20}
        a = port.search("ps", body)
        monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1 << 30)
        b = small.search("ps", body)
        assert a["hits"] == b["hits"]
    finally:
        port.close()
        small.close()


@pytest.mark.parametrize("shards,replicas,devices",
                         [(5, 1, 1), (5, 1, 2), (3, 2, 4), (8, 0, 3)])
def test_placement_is_the_references(shards, replicas, devices):
    """``parallel/placement.py``: the same round robin with the
    same-shard rule, and the same table."""
    got = placement.allocate("i", shards, replicas, devices)
    want = ref_placement.allocate("i", shards, replicas, devices)
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]
    assert placement.placement_table(got) == \
        ref_placement.placement_table(want)
    if devices > 1:
        primary = {a.shard_id: a.device_ord for a in got if a.replica == 0}
        assert all(a.device_ord != primary[a.shard_id]
                   for a in got if a.replica > 0)


# ---------------------------------------------------------------------------
# the split over a node's devices
# ---------------------------------------------------------------------------

@pytest.fixture()
def four(monkeypatch):
    """(reference, port over ``["cpu"] * 4``, port on one device) whose
    ``body`` field is oversized; the port's splits are built on first
    use, with their default slot count."""
    monkeypatch.setattr(aot, "_ENABLED", False)
    monkeypatch.setattr(ref_ps, "POSTINGS_SHARD_NNZ", 1)
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    nodes = (_make(RefNode), _make(Node, device=["cpu"] * 4),
             _make(Node, device="cpu"))
    yield nodes
    for n in nodes:
        n.close()


def test_a_node_over_four_devices_splits_four_ways(four):
    """No ``n_devices``: one range a registry of the node, with the
    reference's bounds, bases and postings of a four-way split."""
    ref, port, _one = four
    ps = _inv(port).postings_split()
    rinv = _inv(ref)
    rs = ref_ps.build_split(rinv, rinv.max_docs, n_devices=4)
    assert ps.S == rs.S == 4
    np.testing.assert_array_equal(ps.bounds, rs.bounds)
    np.testing.assert_array_equal(ps.bases, rs.bases)
    assert ps.L == rs.L
    doc_ids, tfnorm = _stacked(ps)
    np.testing.assert_array_equal(doc_ids, np.asarray(rs.doc_ids_sh))
    np.testing.assert_array_equal(tfnorm, np.asarray(rs.tfnorm_sh))


def test_one_device_node_declines_by_default(four):
    """A node over one device (a one-entry list too) has one registry:
    one slot, no split, as the reference's on one device."""
    _ref, _port, one = four
    assert _inv(one).postings_split() is None
    node = _make(Node, device=["cpu"])
    try:
        assert _inv(node).postings_split() is None
    finally:
        node.close()


def test_each_range_lives_and_is_charged_on_its_registry(four):
    """Range s on registry s % 4: its postings are that registry's
    handles, charged to its budget and the node's ``fielddata`` breaker;
    ``evict_all`` and the segment's release give every registry's charge
    back, and a search after the eviction rehydrates them."""
    _ref, port, _one = four
    regs = port.residency.members
    inv = _inv(port)
    br = port.breakers.breaker("fielddata")
    held0 = [r._held() for r in regs]
    used0 = br.used
    split = inv.postings_split()
    for s in range(split.S):
        assert split.registry_of(s) is regs[s % 4]
        doc_ids, tfnorm = split.slot_arrays(s)
        assert doc_ids.device == regs[s % 4].device
        # the range's own postings, padded with the sentinel
        lo = int(split.bases[s])
        hi = int(split.bases[s + 1]) if s + 1 < split.S else inv.nnz
        want = np.full(split.L, inv.max_docs, np.int32)
        want[:hi - lo] = inv.doc_ids_host[lo:hi]
        np.testing.assert_array_equal(doc_ids.numpy(), want)
    by_reg = [0] * 4
    for reg, slots, h_doc, h_tfn in split.parts:
        for h in (h_doc, h_tfn):
            assert h._registry is reg and h.resident and h.tier == \
                "fielddata"
            by_reg[regs.index(reg)] += h.nbytes
    assert all(b > 0 for b in by_reg)
    assert [r._held() - h for r, h in zip(regs, held0)] == by_reg
    assert br.used - used0 == sum(by_reg)
    seg = port.indices["ps"].shards[0].segments[0]
    assert set(split.handles()) <= set(seg.fielddata_handles())
    want = port.search("ps", {"query": QUERIES[0], "size": 20})
    port.residency.evict_all()
    assert not any(h.resident for h in split.handles())
    assert [r._held() for r in regs] == held0 and br.used == used0
    assert port.search("ps", {"query": QUERIES[0], "size": 20})["hits"] == \
        want["hits"]
    assert all(h.resident for h in split.handles())
    seg.release_fielddata()
    assert [r._held() for r in regs] == held0 and br.used == used0


def test_split_over_devices_matches_unsplit_and_reference(four,
                                                          monkeypatch):
    """Searches through the four-way split: the hits and totals of the
    unsplit path and the reference's (eight-way) split, scores within the
    generic bar; the split counted."""
    ref, port, _one = four
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1 << 30)
    unsplit = _make(Node, device="cpu")
    monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
    try:
        before = kernels.snapshot().get("bm25_postings_sharded", 0)
        for q in QUERIES:
            body = {"query": q, "size": 20}
            a = port.search("ps", body)
            r = ref.search("ps", body)
            monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ",
                                1 << 30)
            b = unsplit.search("ps", body)
            monkeypatch.setattr(postings_shard, "POSTINGS_SHARD_NNZ", 1)
            for other in (b, r):
                assert [h["_id"] for h in a["hits"]["hits"]] == \
                    [h["_id"] for h in other["hits"]["hits"]], q
                assert a["hits"]["total"] == other["hits"]["total"], q
                np.testing.assert_allclose(
                    [h["_score"] for h in a["hits"]["hits"]],
                    [h["_score"] for h in other["hits"]["hits"]],
                    rtol=SCORE_RTOL)
        assert kernels.snapshot().get("bm25_postings_sharded", 0) > before
        assert _inv(port).postings_split().S == 4
    finally:
        unsplit.close()


def test_a_segment_placed_with_the_node_set_splits_over_its_registries():
    """A segment built with the node's ``ResidencySet`` itself (as
    ``segment_from_arrays`` callers pass ``node.residency``) reaches the
    same registries as one built with a member."""
    node = Node(device=["cpu"] * 3)
    try:
        rs = node.residency
        assert rs.node_registries == rs.members
        for s in range(5):
            assert rs.for_shard(s, 5).node_registries == rs.members
        one = Node(device="cpu")
        try:
            assert one.residency.node_registries == one.residency.members
        finally:
            one.close()
    finally:
        node.close()
