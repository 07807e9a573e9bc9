"""Aggregations of the PyTorch port (``search/aggregations/``) against the
reference's, on the CPU.

Inputs: ``tests/_torch_parity.py::agg_corpus`` (a date, an ip, a
multi-valued keyword, numerics missing from some docs), the same seeded
docs indexed by both packages, every 23rd doc deleted after the refresh.

- Host loop (both packages pinned with ``index.search.mesh: false``):
  every aggregator of ``metrics.py`` and ``bucket.py`` on one segment, on
  two segments and on two shards, with sub-aggregations and ``order`` by
  ``_term``, ``_count`` and a sub-agg metric. Keys, order, counts, min,
  max, percentiles, cardinalities and hits are exact; other floats (f32
  sums taken in another order) at rtol 1e-5.
- Mesh: 8 shards of two segments, the port's slots against the
  reference's 8-device CPU mesh (its AOT cache patched off at run time,
  as in ``test_torch_mesh.py``) on the device terms route and the mask
  route; the port's mesh against its own host loop byte for byte.
- ``hash32_device`` and the HLL rank against the reference's ``jnp``
  expressions, ``bucket_count`` against ``np.bincount``, script value
  sources and ``scripted_metric`` on one segment and on the mesh, the
  join and geo aggs on an index without their fields, ``_msearch`` and
  the coalescer
  around agg bodies, and the
  reference's orderings that differ from ES 2.0 (ROADMAP C).
"""
import copy
import json
import math

import numpy as np
import pytest
import torch

from elasticsearch_tpu.monitor import kernels as ref_kernels
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  SearchParseException)

from _torch_parity import AGG_MAPPING, agg_corpus

N_DOCS = 300
DELETE_EVERY = 23
QUERY = {"match": {"body": "fox dog river quick"}}

# name -> (shards, refreshes) of a host-loop index
LAYOUTS = {"one_segment": (1, 1), "two_segments": (1, 2),
           "two_shards": (2, 1)}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _load(ref, port, name, shards, refreshes, mesh):
    idx = {"number_of_shards": shards}
    if not mesh:
        idx["search"] = {"mesh": False}
    body = {"settings": {"index": idx}, "mappings": AGG_MAPPING}
    ref.create_index(name, copy.deepcopy(body))
    port.create_index(name, copy.deepcopy(body))
    svc = ref.indices[name]
    docs = agg_corpus(N_DOCS, seed=5)
    step = -(-len(docs) // refreshes)
    for a in range(0, len(docs), step):
        for doc_id, src in docs[a: a + step]:
            svc.index_doc(doc_id, copy.deepcopy(src))
            port.index(name, doc_id, copy.deepcopy(src))
        svc.refresh()
        port.refresh(name)
    for doc_id, _ in docs[::DELETE_EVERY]:
        svc.delete_doc(doc_id)
        port.delete(name, doc_id)
    svc.refresh()
    port.refresh(name)


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref = RefNode(name="ref")
        port = Node(name="port", device="cpu")
        for name, (shards, refreshes) in LAYOUTS.items():
            _load(ref, port, name, shards, refreshes, mesh=False)
        _load(ref, port, "mesh", 8, 2, mesh=True)
    yield ref, port
    ref.close()
    port.close()


# -- comparison --------------------------------------------------------------

#: response keys whose values must agree exactly even where floats
EXACT_KEYS = {"key", "key_as_string", "doc_count", "count", "min", "max",
              "from", "to", "bg_count", "sum_other_doc_count",
              "doc_count_error_upper_bound", "total", "_id", "_source",
              "_score"}


def _same(p, r, path="", exact=False):
    """``p`` equals ``r``: structure, key order, strings, ints and the
    EXACT_KEYS exactly, other floats at rtol 1e-5 (all exact with
    ``exact``); extended_stats' bounds within 1e-5 of |upper| + |lower|."""
    if path.endswith(".std_deviation_bounds") and not exact:
        # avg -/+ sigma * std: a difference of two terms can cancel, so
        # the bar is 1e-5 of the terms' size, not of the result
        scale = abs(r["upper"]) + abs(r["lower"])
        assert list(p) == list(r)
        for k in r:
            assert math.isclose(p[k], r[k], rel_tol=0,
                                abs_tol=1e-5 * scale), \
                f"{path}.{k}: {p[k]!r} vs {r[k]!r}"
    elif isinstance(r, dict):
        assert isinstance(p, dict) and list(p) == list(r), \
            f"{path}: keys {list(p) if isinstance(p, dict) else p} " \
            f"!= {list(r)}"
        for k in r:
            _same(p[k], r[k], f"{path}.{k}", exact or k in EXACT_KEYS)
    elif isinstance(r, list):
        assert isinstance(p, list) and len(p) == len(r), \
            f"{path}: {len(p)} items != {len(r)}"
        for i, (a, b) in enumerate(zip(p, r)):
            _same(a, b, f"{path}[{i}]", exact)
    elif isinstance(r, float) and not exact:
        assert isinstance(p, float), f"{path}: {p!r} vs {r!r}"
        assert (math.isnan(p) and math.isnan(r)) or math.isclose(
            p, r, rel_tol=1e-5, abs_tol=0), f"{path}: {p!r} vs {r!r}"
    else:
        assert type(p) is type(r) and p == r, f"{path}: {p!r} vs {r!r}"


def _hits(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _search(node, index, body):
    return node.search(index, copy.deepcopy(body))


def _bytes(resp) -> str:
    return json.dumps(dict(resp, took=0), sort_keys=True)


# -- host loop parity ----------------------------------------------------------

# name -> (aggs, every float exact)
CASES = {
    "value_count": ({"v": {"value_count": {"field": "price"}}}, True),
    "sum": ({"v": {"sum": {"field": "price"}}}, False),
    "avg_long": ({"v": {"avg": {"field": "n"}}}, False),
    "min_double": ({"v": {"min": {"field": "price"}}}, True),
    "max_long": ({"v": {"max": {"field": "n"}}}, True),
    "min_date": ({"v": {"min": {"field": "ts"}}}, True),
    "stats_int": ({"v": {"stats": {"field": "qty"}}}, False),
    "extended_stats": ({"v": {"extended_stats": {"field": "price",
                                                 "sigma": 3}}}, False),
    "cardinality_long": ({"v": {"cardinality": {"field": "n"}}}, True),
    "cardinality_double": ({"v": {"cardinality": {"field": "price"}}},
                           True),
    "cardinality_date": ({"v": {"cardinality": {"field": "ts"}}}, True),
    "cardinality_multi": ({"v": {"cardinality": {"field": "labels"}}},
                          True),
    "percentiles": ({"v": {"percentiles": {"field": "price",
                                           "percents": [5, 50, 99.9]}}},
                    True),
    "percentile_ranks": ({"v": {"percentile_ranks": {
        "field": "qty", "values": [3, 10, 19]}}}, True),
    "top_hits": ({"v": {"top_hits": {"size": 4}}}, True),
    "terms_keyword": ({"v": {"terms": {"field": "tag"}}}, True),
    "terms_multi": ({"v": {"terms": {"field": "labels", "size": 3}}}, True),
    "terms_numeric": ({"v": {"terms": {"field": "qty", "size": 5,
                                       "min_doc_count": 2}}}, True),
    "terms_text": ({"v": {"terms": {"field": "body", "size": 8}}}, True),
    "terms_order_term": ({"v": {"terms": {
        "field": "tag", "order": {"_term": "asc"}},
        "aggs": {"s": {"sum": {"field": "price"}}}}}, False),
    "terms_order_count_asc": ({"v": {"terms": {
        "field": "labels", "order": {"_count": "asc"}},
        "aggs": {"m": {"max": {"field": "n"}}}}}, False),
    "terms_order_metric": ({"v": {"terms": {
        "field": "tag", "order": {"p.avg": "desc"}},
        "aggs": {"p": {"stats": {"field": "price"}}}}}, False),
    "terms_numeric_subs": ({"v": {"terms": {
        "field": "qty", "size": 3, "shard_size": 4},
        "aggs": {"a": {"avg": {"field": "price"}}}}}, False),
    "histogram": ({"v": {"histogram": {"field": "price", "interval": 10}}},
                  True),
    "histogram_subs": ({"v": {"histogram": {
        "field": "n", "interval": 100_000_000, "min_doc_count": 1},
        "aggs": {"s": {"stats": {"field": "price"}}}}}, False),
    "histogram_fraction": ({"v": {"histogram": {
        "field": "price", "interval": 12.5, "format": "#.0"}}}, True),
    "histogram_keyword": ({"v": {"histogram": {
        "field": "tag", "interval": 2},
        "aggs": {"c": {"value_count": {"field": "n"}}}}}, True),
    "date_histogram_week": ({"v": {"date_histogram": {
        "field": "ts", "interval": "7d"},
        "aggs": {"c": {"value_count": {"field": "qty"}}}}}, True),
    "date_histogram_month": ({"v": {"date_histogram": {
        "field": "ts", "interval": "month"},
        "aggs": {"a": {"avg": {"field": "price"}}}}}, False),
    "range": ({"v": {"range": {"field": "price", "ranges": [
        {"to": 25}, {"from": 25, "to": 75, "key": "mid"}, {"from": 75}]},
        "aggs": {"t": {"terms": {"field": "tag", "size": 2}}}}}, True),
    "range_long": ({"v": {"range": {"field": "n", "ranges": [
        {"to": 0}, {"from": 0, "to": 500_001_500},
        {"from": 500_001_500}]}}}, True),
    "date_range": ({"v": {"date_range": {"field": "ts", "ranges": [
        {"to": "2015-02-01"}, {"from": "2015-02-01", "to": "2015-03-15"},
        {"from": "2015-03-15"}]}}}, True),
    "ip_range": ({"v": {"ip_range": {"field": "addr", "ranges": [
        {"to": "10.0.1.0"}, {"from": "10.0.1.0", "to": "10.0.3.0"},
        {"from": "10.0.3.0"}]}}}, True),
    "filter": ({"v": {"filter": {"term": {"tag": "t3"}},
                      "aggs": {"a": {"avg": {"field": "n"}},
                               "h": {"terms": {"field": "labels"}}}}},
               False),
    "filters": ({"v": {"filters": {"filters": {
        "cheap": {"range": {"price": {"lt": 20}}},
        "fox": {"match": {"body": "fox"}}}},
        "aggs": {"m": {"min": {"field": "qty"}}}}}, True),
    "filters_list": ({"v": {"filters": {"filters": [
        {"term": {"labels": "gold"}}, {"exists": {"field": "ts"}}]}}},
        True),
    "global": ({"v": {"global": {},
                      "aggs": {"c": {"value_count": {"field": "n"}}}}},
               True),
    "missing": ({"v": {"missing": {"field": "price"},
                       "aggs": {"t": {"terms": {"field": "tag"}}}}}, True),
    "missing_multi": ({"v": {"missing": {"field": "labels"}}}, True),
    "sampler": ({"v": {"sampler": {"shard_size": 40},
                       "aggs": {"t": {"terms": {"field": "labels"}}}}},
                True),
    "significant_terms": ({"v": {"significant_terms": {"field": "tag"}}},
                          False),
    "three_levels": ({"v": {"terms": {"field": "labels"}, "aggs": {
        "h": {"histogram": {"field": "qty", "interval": 5},
              "aggs": {"s": {"extended_stats": {"field": "price"}}}}}}},
        False),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_loop_matches_reference(nodes, case, layout):
    ref, port = nodes
    aggs, exact = CASES[case]
    body = {"query": QUERY, "size": 3, "aggs": aggs}
    kernels.reset()
    p = _search(port, layout, body)
    assert kernels.snapshot().get("agg_mask") is None  # the host loop
    r = _search(ref, layout, body)
    assert p["hits"]["total"] == r["hits"]["total"] > 0
    assert _hits(p) == _hits(r)
    _same(p["aggregations"], r["aggregations"], "aggregations", exact)


@pytest.mark.parametrize("key", ["aggs", "aggregations"])
def test_size_zero_match_all(nodes, key):
    """The usual analytics body: no hits, the aggregations of every live
    doc."""
    ref, port = nodes
    body = {"size": 0, key: {
        "t": {"terms": {"field": "labels"},
              "aggs": {"p": {"percentiles": {"field": "qty"}}}},
        "d": {"date_histogram": {"field": "ts", "interval": "1d",
                                 "min_doc_count": 1}}}}
    p = _search(port, "two_shards", body)
    r = _search(ref, "two_shards", body)
    live = N_DOCS - len(range(0, N_DOCS, DELETE_EVERY))
    assert p["hits"]["total"] == r["hits"]["total"] == live
    assert p["hits"]["hits"] == []
    _same(p["aggregations"], r["aggregations"], "aggregations", True)


# -- the mesh ------------------------------------------------------------------

# name -> (body, the port's agg route counter)
MESH_CASES = {
    "device_terms": ({"size": 0, "aggs": {
        "t": {"terms": {"field": "tag"}},
        "l": {"terms": {"field": "labels", "size": 2,
                        "order": {"_term": "desc"}}}}},
        "agg_terms_device"),
    "device_terms_query": ({"query": QUERY, "size": 5, "aggs": {
        "t": {"terms": {"field": "labels", "min_doc_count": 9}}}},
        "agg_terms_device"),
    "mask_mixed": ({"query": QUERY, "size": 4, "aggs": {
        "s": {"stats": {"field": "price"}},
        "a": {"avg": {"field": "n"}},
        "c": {"value_count": {"field": "qty"}},
        "e": {"extended_stats": {"field": "qty"}},
        "t": {"terms": {"field": "tag"},
              "aggs": {"m": {"max": {"field": "price"}}}},
        "h": {"histogram": {"field": "price", "interval": 20}},
        "k": {"cardinality": {"field": "n"}},
        "p": {"percentiles": {"field": "price"}},
        "top": {"top_hits": {"size": 5}},
        "f": {"filter": {"range": {"qty": {"gte": 10}}}},
        "u": {"sum": {"field": "price"}}}},
        "agg_mask"),
    "mask_numeric_terms": ({"size": 0, "aggs": {
        "q": {"terms": {"field": "qty", "size": 4}},
        "t": {"terms": {"field": "tag"}}}},
        "agg_mask"),
}


def _port_mesh(port, body, route):
    kernels.reset()
    resp = _search(port, "mesh", body)
    snap = kernels.snapshot()
    assert snap.get("mesh_search") == 1 and snap.get(route) == 1, snap
    return resp, snap


def _port_host(port, body, monkeypatch):
    monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    kernels.reset()
    resp = _search(port, "mesh", body)
    monkeypatch.delenv("ESTPU_DISABLE_MESH")
    assert not any(k.startswith(("mesh_", "agg_"))
                   for k in kernels.snapshot())
    return resp


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_matches_reference_mesh(nodes, case):
    ref, port = nodes
    body, route = MESH_CASES[case]
    p, _snap = _port_mesh(port, body, route)
    ref_kernels.reset()
    r = _search(ref, "mesh", body)
    assert ref_kernels.snapshot().get("mesh_search") == 1
    assert p["hits"]["total"] == r["hits"]["total"]
    assert _hits(p) == _hits(r)
    _same(p["aggregations"], r["aggregations"], "aggregations")


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_matches_host_loop_bytes(nodes, case, monkeypatch):
    _ref, port = nodes
    body, route = MESH_CASES[case]
    mesh, _ = _port_mesh(port, body, route)
    assert _bytes(mesh) == _bytes(_port_host(port, body, monkeypatch))


# -- script value sources and scripted_metric ------------------------------

SCRIPT_CASES = {
    "script_avg": {"g": {"avg": {"script": "doc['qty'].value * 2"}}},
    "script_sum_params": {"g": {"sum": {"script": {
        "inline": "doc['price'].value * params.f", "params": {"f": 1.5}}}}},
    "script_stats": {"g": {"stats": {"script": "doc['qty'].value > 10 ? "
                                               "doc['price'].value : 0"}}},
    "script_min_max": {"lo": {"min": {"script": "doc['ts'].value"}},
                       "hi": {"max": {"script": "doc['n'].value / 1000"}}},
    "script_histogram": {"g": {"histogram": {
        "script": {"source": "doc['price'].value * 3"}, "interval": 25}}},
    "script_histogram_subs": {"g": {"histogram": {
        "script": "doc['qty'].value", "interval": 5},
        "aggs": {"s": {"avg": {"script": "doc['price'].value"}}}}},
    "scripted_metric": {"g": {"scripted_metric": {
        "map_script": "doc['price'].value"}}},
    "scripted_metric_params": {"g": {"scripted_metric": {
        "map_script": "doc['qty'].value * params.w + 1",
        "params": {"w": 0.25}}}},
    "scripted_metric_default": {"g": {"scripted_metric": {}}},
    "terms_with_scripted": {"t": {"terms": {"field": "tag"}, "aggs": {
        "m": {"scripted_metric": {"map_script": "doc['qty'].value"}}}}},
}


@pytest.mark.parametrize("index", ["one_segment", "mesh"])
@pytest.mark.parametrize("case", sorted(SCRIPT_CASES))
def test_script_aggs_match_reference(nodes, case, index):
    ref, port = nodes
    body = {"query": QUERY, "size": 3, "aggs": SCRIPT_CASES[case]}
    kernels.reset()
    p = _search(port, index, body)
    if index == "mesh":
        assert kernels.snapshot().get("agg_mask") == 1, kernels.snapshot()
    r = _search(ref, index, body)
    assert p["hits"]["total"] == r["hits"]["total"] > 0
    assert _hits(p) == _hits(r)
    _same(p["aggregations"], r["aggregations"], "aggregations")


@pytest.mark.parametrize("case", sorted(SCRIPT_CASES))
def test_script_aggs_mesh_matches_host_loop_bytes(nodes, case,
                                                  monkeypatch):
    """Mask-route partials fold in (shard, segment) order on the mesh."""
    _ref, port = nodes
    body = {"size": 0, "aggs": SCRIPT_CASES[case]}
    mesh, _ = _port_mesh(port, body, "agg_mask")
    assert _bytes(mesh) == _bytes(_port_host(port, body, monkeypatch))


def test_mesh_agg_round_takes_the_generic_route(nodes):
    """A pure-dense match with aggs: no B1 launch (B1 makes no mask)."""
    _ref, port = nodes
    body = {"query": {"match": {"body": "the"}}, "size": 3,
            "aggs": {"t": {"terms": {"field": "tag"}}}}
    _, snap = _port_mesh(port, body, "agg_terms_device")
    assert not snap.get("bm25_fused_topk"), snap


@pytest.mark.parametrize("where",
                         ["mask_bucket_count", "device_counts", "collector"])
def test_a_device_failure_fails_the_request(nodes, monkeypatch, where):
    """A fault on the mesh's agg path raises: the request is not answered
    by the host loop."""
    from elasticsearch_tpu_torch.parallel import executor as port_executor
    from elasticsearch_tpu_torch.search.aggregations import bucket, metrics

    _ref, port = nodes

    def boom(*a, **kw):
        raise RuntimeError("device fault")

    if where == "mask_bucket_count":
        monkeypatch.setattr(bucket, "bucket_count", boom)
        body = {"size": 0, "aggs": {"t": {
            "terms": {"field": "tag"},
            "aggs": {"m": {"max": {"field": "price"}}}}}}
    elif where == "device_counts":
        monkeypatch.setattr(port_executor, "agg_term_counts", boom)
        body = MESH_CASES["device_terms"][0]
    else:
        monkeypatch.setattr(metrics.StatsAggregator, "collect", boom)
        body = {"size": 0, "aggs": {"s": {"stats": {"field": "price"}}}}
    kernels.reset()
    with pytest.raises(RuntimeError, match="device fault"):
        _search(port, "mesh", body)
    snap = kernels.snapshot()
    assert not snap.get("mesh_fallback_total") and \
        not snap.get("mesh_search"), snap


# -- hashing, HLL rank, bucket_count -------------------------------------------

def test_hash32_device_matches_reference():
    import jax.numpy as jnp

    from elasticsearch_tpu.utils.hashing import hash32_device as ref_hash
    from elasticsearch_tpu_torch.utils.hashing import hash32_device

    fixed = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    seeded = np.random.default_rng(0).integers(0, 2**32, 100_000,
                                               dtype=np.int64)
    for x in (fixed, seeded):
        want = np.asarray(ref_hash(jnp.asarray(x.astype(np.uint32))))
        got = hash32_device(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    # signed inputs take their two's complement bits, as a uint32 cast
    neg = np.array([-1, -(2**31), 7], np.int32)
    np.testing.assert_array_equal(
        hash32_device(torch.from_numpy(neg)).numpy(),
        np.asarray(ref_hash(jnp.asarray(neg))).astype(np.int64))


def _rank_sweep() -> np.ndarray:
    """2^n - 1, 2^n, 2^n + 1 for every n, and the f32 rounding band
    below each 2^n (the 2^(n-17) values under it), inside (0, 2^32)."""
    vals = []
    for n in range(33):
        p = 1 << n
        vals += [p - 1, p, p + 1]
        vals += range(max(1, p - (1 << max(0, n - 17))), p)
    v = np.unique(np.asarray(vals, np.int64))
    return v[(v > 0) & (v < 2**32)]


def test_hll_rank_sweep_against_the_reference_expression():
    """The port's rank (``31 - floor(log2(f32(rest)))`` on torch) against
    the reference's jnp expression. They differ only where f32(rest) lies
    within 2^-20 below or at a power of two (ROADMAP C: XLA's log2 is one
    low at some exact powers, torch's f32 log2 one high in the rounding
    band), by one; everywhere else both equal the exact leading-zero
    rank."""
    import jax.numpy as jnp

    from elasticsearch_tpu_torch.search.aggregations.metrics import hll_rank
    from elasticsearch_tpu_torch.utils.hashing import HLL_BITS

    v = _rank_sweep()
    r = jnp.asarray(v.astype(np.uint32))
    lz = jnp.where(r > 0, 31 - jnp.floor(jnp.log2(r.astype(jnp.float32)))
                   .astype(jnp.int32), jnp.int32(32))
    want = np.asarray(jnp.clip(lz + 1, 1, 32 - HLL_BITS + 1)).astype(np.int64)
    got = hll_rank(torch.from_numpy(v)).numpy()
    exact = np.clip(32 - np.array([int(x).bit_length() for x in v]) + 1, 1,
                    32 - HLL_BITS + 1)
    f = v.astype(np.float32).astype(np.float64)
    up = 2.0 ** np.ceil(np.log2(f))
    band = f >= up * (1 - 2.0 ** -20)
    differ = got != want
    assert np.all(np.abs(got - want)[differ] == 1)
    assert not np.any(differ & ~band), v[differ & ~band][:10]
    np.testing.assert_array_equal(got[~band], exact[~band])
    np.testing.assert_array_equal(want[~band], exact[~band])


@pytest.mark.parametrize("n,buckets", [(1, 1), (1000, 7), (50_000, 300),
                                       (20_000, 70_000)])
def test_bucket_count_matches_bincount(n, buckets):
    from elasticsearch_tpu_torch.ops.scoring import bucket_count

    rng = np.random.default_rng(n)
    ids = rng.integers(0, buckets, n)
    sel = rng.random(n) < 0.6
    got = bucket_count(torch.from_numpy(ids), torch.from_numpy(sel),
                       num_buckets=buckets)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(ids[sel], minlength=buckets))


def test_cardinality_registers_equal_the_reference(nodes):
    """The HLL registers of every segment, bit for bit."""
    from elasticsearch_tpu.search.aggregations import parse_aggs as ref_parse
    from elasticsearch_tpu.search.context import \
        SegmentContext as RefContext
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.context import SegmentContext

    ref, port = nodes
    rsvc, psvc = ref.indices["two_segments"], port.get_index("two_segments")
    import jax.numpy as jnp

    for field in ("n", "price", "ts", "labels", "addr"):
        spec = {"c": {"cardinality": {"field": field}}}
        (ra,), (pa,) = ref_parse(spec), parse_aggs(spec)
        rsegs = rsvc.shards[0].engine.segments
        psegs = psvc.shards[0].engine.segments
        assert len(rsegs) == len(psegs) == 2
        for rs, ps in zip(rsegs, psegs):
            rctx = RefContext(rs, rsvc.mappings, rsvc.analysis)
            pctx = SegmentContext(ps, psvc.mappings, psvc.analysis)
            want = ra.collect(rctx, rs.live & jnp.ones(rs.max_docs, bool))
            got = pa.collect(pctx, ps.live)
            np.testing.assert_array_equal(got, np.asarray(want))


# -- the join and geo aggs; refusals ------------------------------------------------------------------

A9_BODIES = {
    "geo_bounds": {"g": {"geo_bounds": {"field": "addr"}}},
    "nested": {"g": {"nested": {"path": "x"}}},
    "reverse_nested": {"g": {"terms": {"field": "tag"},
                             "aggs": {"r": {"reverse_nested": {}}}}},
    "children": {"g": {"children": {"type": "answer"}}},
    "geohash_grid": {"g": {"geohash_grid": {"field": "addr"}}},
    "geo_distance": {"g": {"geo_distance": {
        "field": "addr", "origin": "1,2", "ranges": [{"to": 10}]}}},
}


@pytest.mark.parametrize("index", ["one_segment", "mesh"])
@pytest.mark.parametrize("name", sorted(A9_BODIES))
def test_deferred_types_raise_the_typed_a9_refusal(nodes, name, index):
    """The join and geo aggs the port once refused (A9c) are served: on
    an index without nested docs, children or points (``addr`` is an ip)
    each answers as the reference does, on the host loop and the mesh's
    mask route. ``test_torch_joins.py`` and ``test_torch_geo.py`` hold
    them on the indices they are for."""
    ref, port = nodes
    body = {"size": 0, "aggs": A9_BODIES[name]}
    _same(_search(port, index, body)["aggregations"],
          _search(ref, index, body)["aggregations"], "aggregations")


def test_unknown_type_is_not_an_a9_refusal(nodes):
    _ref, port = nodes
    with pytest.raises(SearchParseException,
                       match=r"unknown aggregation type \[nope\]"):
        _search(port, "mesh", {"aggs": {"x": {"nope": {}}}})


@pytest.mark.parametrize("key", ["explain", "fielddata_fields",
                                 "partial_fields", "stats", "suggest",
                                 "post_filter", "track_scores"])
@pytest.mark.parametrize("index", ["one_segment", "mesh"])
def test_other_request_keys_are_still_refused(nodes, key, index):
    """Keys the port does not serve raise their typed refusal; ``suggest``
    is served since A9d, so its malformed body here (a suggester that is
    not an object) raises the suggesters' own typed error, the
    reference's message; ``stats`` is served since A10b (its keys name
    the groups), with the hits and aggs the reference answers."""
    ref, port = nodes
    body = {"query": QUERY, key: {"x": 1}, "aggs": {
        "t": {"terms": {"field": "tag"}}}}
    if key == "stats":
        got = _search(port, index, body)
        want = ref.search(index, copy.deepcopy(body))
        assert got["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in got["hits"]["hits"]] == \
            [h["_id"] for h in want["hits"]["hits"]]
        assert got["aggregations"] == want["aggregations"]
        return
    if key == "suggest":
        with pytest.raises(ElasticsearchTpuException,
                           match=r"^suggester \[x\] malformed body$"):
            _search(port, index, body)
        return
    with pytest.raises(SearchParseException, match="not yet in the PyTorch"):
        _search(port, index, body)


# -- msearch and the coalescer -------------------------------------------------

def test_msearch_batches_plain_bodies_around_agg_bodies(nodes, monkeypatch):
    """The plain items still share one batch; each agg item equals its
    sequential search."""
    from elasticsearch_tpu_torch.search import batch

    _ref, port = nodes
    plain = [{"query": {"match": {"body": w}}, "size": 4}
             for w in ("fox", "dog", "river")]
    agg = [{"query": QUERY, "size": 2, "aggs": CASES[c][0]}
           for c in ("terms_order_metric", "histogram_subs")]
    bodies = [plain[0], agg[0], plain[1], agg[1], plain[2]]
    batched = []
    real = batch.execute_batch
    monkeypatch.setattr(batch, "execute_batch", lambda svc, bs, *a, **kw: (
        batched.append([copy.deepcopy(b) for b in bs])
        or real(svc, bs, *a, **kw)))
    out = port.msearch([({"index": "two_shards"}, copy.deepcopy(b))
                        for b in bodies])["responses"]
    monkeypatch.undo()
    assert batched == [plain]
    for b, got in zip(bodies, out):
        want = _search(port, "two_shards", b)
        assert _bytes(got) == _bytes(want)
        assert ("aggregations" in got) == ("aggs" in b)


def test_coalescer_runs_agg_bodies_on_their_own_path(nodes):
    _ref, port = nodes
    body = {"query": QUERY, "size": 5, "aggs": CASES["terms_keyword"][0]}
    want = _search(port, "mesh", body)
    co = port.serving.coalescer
    port.serving.apply_cluster_settings({
        "serving.coalescer.mode": "always",
        "serving.coalescer.max_wait": "200ms"})
    try:
        before = co.stats()
        got = _search(port, "mesh", body)
        after = co.stats()
    finally:
        port.serving.apply_cluster_settings({})
    assert after["batch_size"] == before["batch_size"]
    assert after["bypass"] == before["bypass"]
    assert _bytes(got) == _bytes(want)


# -- the reference's orders that differ from ES 2.0 (ROADMAP C) ----------------

def _tie_node(kind):
    ref = RefNode(name="ref-ties")
    port = Node(name="port-ties", device="cpu")
    body = {"settings": {"index": {"number_of_shards": 1,
                                   "search": {"mesh": False}}},
            "mappings": {"properties": {"k": {"type": "keyword"},
                                        "x": {"type": "double"},
                                        "y": {"type": "double"}}}}
    for n in (ref, port):
        n.create_index("t", copy.deepcopy(body))
    if kind == "ties":
        docs = [{"k": k} for k in ("b", "a", "c", "a", "b", "c", "d")]
    else:
        # 9.9999999 is below 10 but rounds to 10.0f: counted in bucket 0,
        # collected by bucket 10's sub-aggregations
        docs = [{"x": 9.9999999, "y": 1.0}, {"x": 5.0, "y": 2.0},
                {"x": 12.0, "y": 4.0}]
    for i, src in enumerate(docs):
        ref.indices["t"].index_doc(str(i), src)
        port.index("t", str(i), src)
    ref.indices["t"].refresh()
    port.refresh("t")
    return ref, port


def test_terms_count_ties_break_by_key_descending():
    """``_count: desc`` ties break by ``str(key)`` descending (ES 2.0:
    term ascending); the port keeps the reference's order."""
    ref, port = _tie_node("ties")
    try:
        body = {"size": 0, "aggs": {"k": {"terms": {"field": "k"}}}}
        p, r = _search(port, "t", body), _search(ref, "t", body)
        assert [b["key"] for b in p["aggregations"]["k"]["buckets"]] == \
            ["c", "b", "a", "d"]
        assert p["aggregations"] == r["aggregations"]
    finally:
        ref.close()
        port.close()


def test_histogram_edge_double_in_a_neighbours_sub_aggs():
    """A double within f32 rounding below a bucket edge: counted in its
    exact bucket, but the sub-aggregation masks compare the f32 channel,
    so the next bucket's sub-aggs collect it (the reference's rule)."""
    ref, port = _tie_node("edge")
    try:
        body = {"size": 0, "aggs": {"h": {
            "histogram": {"field": "x", "interval": 10},
            "aggs": {"s": {"sum": {"field": "y"}},
                     "c": {"value_count": {"field": "y"}}}}}}
        p, r = _search(port, "t", body), _search(ref, "t", body)
        b0, b10 = p["aggregations"]["h"]["buckets"]
        assert (b0["key"], b0["doc_count"], b0["c"]["value"]) == (0.0, 2, 1)
        assert (b10["key"], b10["doc_count"], b10["c"]["value"]) == \
            (10.0, 1, 2)
        assert b10["s"]["value"] == 5.0
        assert p["aggregations"] == r["aggregations"]
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("mesh", [True, False])
def test_an_index_without_docs(mesh):
    """No segment anywhere: every agg reduces its empty partial list, on
    either route, as the reference does."""
    ref = RefNode(name="ref-empty")
    port = Node(name="port-empty", device="cpu")
    idx = {"number_of_shards": 2}
    if not mesh:
        idx["search"] = {"mesh": False}
    body = {"settings": {"index": idx}, "mappings": AGG_MAPPING}
    try:
        for n in (ref, port):
            n.create_index("e", copy.deepcopy(body))
        req = {"size": 0, "aggs": dict(
            MESH_CASES["device_terms"][0]["aggs"],
            **{k: v for k, v in MESH_CASES["mask_mixed"][0]["aggs"].items()
               if k != "top"})}
        p, r = _search(port, "e", req), _search(ref, "e", req)
        assert p["hits"]["total"] == r["hits"]["total"] == 0
        _same(p["aggregations"], r["aggregations"], "aggregations", True)
    finally:
        ref.close()
        port.close()
