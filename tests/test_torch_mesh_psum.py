"""The cross-device merge of aggregation partials
(``parallel/mesh_service.py::_psum_merge_partials``) against the
reference's, fed the same per-shard partials.

The reference sums the integer lanes with its ``mesh_psum`` collective
over its eight virtual CPU devices (int32, declining past 2^31 to its
host fold); the port sums them in int64 across the devices of a node
over ``["cpu"] * 4`` (``executor.psum_partials``). Float lanes are
folded on the host in partial order by both.

Tolerances. The port's merged partials reduce to exactly the response
its host reduce makes of the unmerged partials. Against the
reference's merged partials and reduced responses: keys, buckets, counts
and every integer lane exact; float lanes (sums, averages, variances)
at rtol 1e-12, since the reference folds them with a ``+=`` loop and
its own reduce with Python's compensated ``sum()`` (ROADMAP C35). A
lane whose total passes 2^31: the reference keeps the partials (its
host fold), the port merges them, and the two reduced responses are
equal. A terms agg with sub-aggs is left unmerged by both.
"""
import copy

import numpy as np
import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.parallel import mesh_service as ref_ms
from elasticsearch_tpu.search.aggregations import parse_aggs as ref_parse
from elasticsearch_tpu.search.aggregations import reduce_aggs as ref_reduce
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel import mesh_service as port_ms
from elasticsearch_tpu_torch.search.aggregations import parse_aggs, \
    reduce_aggs

N_SHARDS = 8

AGGS = {
    "t": {"terms": {"field": "tag", "size": 4}},
    "c": {"value_count": {"field": "n"}},
    "a": {"avg": {"field": "price"}},
    "s": {"stats": {"field": "price"}},
    "e": {"extended_stats": {"field": "price"}},
    "sub": {"terms": {"field": "tag"},
            "aggs": {"m": {"avg": {"field": "price"}}}},
    "mx": {"max": {"field": "price"}},
}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


@pytest.fixture(scope="module")
def executors():
    """(reference executor on its 8 devices, port executor over 4)."""
    from elasticsearch_tpu.parallel import aot

    body = {"settings": {"index": {"number_of_shards": N_SHARDS}},
            "mappings": {"properties": {"tag": {"type": "keyword"}}}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref-psum")
        port = Node(name="port-psum", device=["cpu"] * 4)
        ref.create_index("p", copy.deepcopy(body))
        port.create_index("p", copy.deepcopy(body))
        rex = ref.indices["p"].mesh_executor()
        pex = port.get_index("p").mesh_executor()
        assert rex.S == N_SHARDS and pex.n_devices == 4
    yield rex, pex
    ref.close()
    port.close()


def _partials(seed: int, big: bool = False):
    """Per-(shard, segment) partials of every agg in ``AGGS``, two
    segments a shard, and the shard of each. ``big``: terms doc counts
    whose totals pass 2^31."""
    rng = np.random.default_rng(seed)
    tags = [f"t{i}" for i in range(9)]
    scale = (1 << 29) if big else 1
    parts, shards = [], []
    for sh in range(N_SHARDS):
        for _seg in range(2):
            keys = rng.choice(tags, size=int(rng.integers(1, 6)),
                              replace=False)
            n = int(rng.integers(0, 40))
            vals = np.round(rng.random(n) * 100, 2)
            stats = {"count": n, "sum": float(vals.sum()),
                     "min": float(vals.min()) if n else None,
                     "max": float(vals.max()) if n else None}
            parts.append({
                "t": {"buckets": {str(k): {"doc_count": int(
                    rng.integers(1, 20)) * scale} for k in keys},
                      "sum_other_doc_count": int(rng.integers(0, 5)) * scale,
                      "order": {"_count": "desc"}},
                "c": int(rng.integers(0, 50)),
                "a": (float(vals.sum()), n),
                "s": dict(stats),
                "e": dict(stats, sum_sq=float((vals * vals).sum())),
                "sub": {"buckets": {str(k): {
                    "doc_count": int(rng.integers(1, 9)),
                    "subs": {"m": (float(rng.random() * 10),
                                   int(rng.integers(1, 4)))}}
                    for k in keys[:2]},
                    "sum_other_doc_count": 0,
                    "order": {"_count": "desc"}},
                "mx": float(vals.max()) if n else None,
            })
            shards.append(sh)
    return parts, shards


def _merge(ms, ex, aggs, parts, shards):
    return ms._psum_merge_partials(ex, aggs, copy.deepcopy(parts),
                                   list(shards))


def _near(v, w):
    """Exact but for floats, at rtol 1e-12, through dicts, lists and
    tuples."""
    if isinstance(v, dict):
        assert v.keys() == w.keys()
        for key in v:
            _near(v[key], w[key])
    elif isinstance(v, (list, tuple)):
        assert type(v) is type(w) and len(v) == len(w)
        for a, b in zip(v, w):
            _near(a, b)
    elif isinstance(v, float):
        assert isinstance(w, float)
        np.testing.assert_allclose(v, w, rtol=1e-12)
    else:
        assert v == w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merged_partials_are_the_references(executors, seed):
    rex, pex = executors
    parts, shards = _partials(seed)
    r_aggs, p_aggs = ref_parse(AGGS), parse_aggs(AGGS)
    kernels.reset()
    got = _merge(port_ms, pex, p_aggs, parts, shards)
    # terms, value_count, avg, stats, extended_stats: one device sum each
    assert kernels.snapshot().get("mesh_psum") == 5
    want = _merge(ref_ms, rex, r_aggs, parts, shards)
    _near(got, want)
    merged = got[-1]
    assert set(merged) == {"t", "c", "a", "s", "e"}
    # the sub-agg terms and max keep their per-segment partials
    assert sum("sub" in p for p in got) == len(parts)
    assert sum("mx" in p for p in got) == len(parts)
    host = reduce_aggs(p_aggs, copy.deepcopy(parts))
    assert reduce_aggs(p_aggs, got) == host
    _near(ref_reduce(r_aggs, want), host)
    assert merged["c"] == sum(p["c"] for p in parts)
    assert merged["t"]["sum_other_doc_count"] == sum(
        p["t"]["sum_other_doc_count"] for p in parts)


def test_a_lane_past_int32_merges_exactly(executors):
    """Terms totals past 2^31: the reference declines its int32 psum and
    folds on the host; the port's int64 sum merges; the responses are
    the same."""
    rex, pex = executors
    parts, shards = _partials(5, big=True)
    parts = [{"t": p["t"]} for p in parts]
    aggs = {"t": AGGS["t"]}
    r_aggs, p_aggs = ref_parse(aggs), parse_aggs(aggs)
    total = {}
    for p in parts:
        for k, b in p["t"]["buckets"].items():
            total[k] = total.get(k, 0) + b["doc_count"]
    assert max(total.values()) > np.iinfo(np.int32).max
    got = _merge(port_ms, pex, p_aggs, parts, shards)
    want = _merge(ref_ms, rex, r_aggs, parts, shards)
    assert want == parts  # the reference's decline: partials untouched
    assert len(got) == 1 and got[0]["t"]["buckets"] == {
        k: {"doc_count": v} for k, v in sorted(total.items(), key=repr)}
    assert reduce_aggs(p_aggs, got) == ref_reduce(r_aggs, want) == \
        reduce_aggs(p_aggs, copy.deepcopy(parts))


def test_one_device_and_one_shard_keep_the_partials(executors):
    """A mesh of one device reduces on the host alone (the partials as
    they are), and so does an agg whose partials sit on one shard."""
    _rex, pex = executors
    parts, shards = _partials(3)
    p_aggs = parse_aggs(AGGS)
    one = Node(name="one-psum", device="cpu")
    try:
        one.create_index("p", {"settings": {"number_of_shards": 2}})
        ex1 = one.get_index("p").mesh_executor()
        assert port_ms._psum_merge_partials(ex1, p_aggs, parts, shards) \
            is parts
    finally:
        one.close()
    solo = [p for p, sh in zip(parts, shards) if sh == 3]
    assert port_ms._psum_merge_partials(pex, p_aggs, solo, [3, 3]) is solo
