"""function_score and the script query of the port against the
reference's ``Node``, on one and two shards of several segments, on the
port's mesh route and its host loop.

- Every function type (weight, field_value_factor with each modifier,
  script_score, random_score, gauss/exp/linear decays on a double and on
  a date whose f32 channel carries a segment offset) and the
  ``score_mode`` × ``boost_mode`` grid; ``max_boost``, ``min_score``, a
  filtered function (the reference's ``test_function_score_sum_with_
  filtered_function``), ``_name``, ``random_score`` across merged
  segments, the bodies of the reference's ``test_queries.py`` and
  ``test_mesh_product_path.py``.
- The reference's oracle is its host loop: its mesh casts a column's
  exact value to f32 where its host loop adds the offset back to the f32
  channel, and the two disagree on a date decay
  (``test_reference_mesh_and_host_differ_on_a_date_decay``, ROADMAP C).
  The port's two routes follow the host loop and answer byte for byte.
- A decay with no origin takes each segment's greatest value, as the
  reference does (``test_origin_default_is_the_segment_max``, ROADMAP C).
- The mesh serves weight, field_value_factor, decays and random_score
  and declines script_score, a decay from ``now``, a script query and
  field_value_factor without ``missing`` over a column-less segment by a
  typed MeshCompileError. ``ColPrim`` passes the segment's own column at
  S = 1 and charged, cached copies at S > 1; the memo keys the
  function's parameters.

Bars: the same ids in the same order, ``hits.total`` exact, scores
within rtol 1e-5.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

from _torch_parity import MAPPING, corpus

TS_BASE = 1_420_070_400_000  # 2015-01-01T00:00:00Z
FS_MAPPING = {"properties": dict(MAPPING["properties"],
                                 ts={"type": "date"})}
# (shards, first doc, end doc) of each index; a refresh every 60 docs
INDICES = {"one": (1, 0, 240), "two": (2, 240, 480)}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _docs(lo, hi):
    rng = np.random.default_rng(11)
    ts = rng.integers(0, 120 * 86_400_000, 480)
    out = []
    for i, (doc_id, src) in enumerate(corpus(480, seed=3)[lo:hi], lo):
        if i % 13:
            src = dict(src, ts=TS_BASE + int(ts[i]))
        out.append((doc_id, src))
    return out


def _load(node, name, shards, docs, mapping=FS_MAPPING, every=60):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})
    svc = node.indices[name]
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for node in (ref, port):
            for name, (shards, lo, hi) in INDICES.items():
                _load(node, name, shards, _docs(lo, hi))
            # a first segment without the numerics, then one with them
            sparse = [(f"s{i}", {"body": src["body"], "tag": src["tag"]})
                      for i, (_, src) in enumerate(corpus(40, seed=9))]
            _load(node, "sparse", 1, sparse + _docs(0, 40), every=40)
    yield ref, port
    ref.close()
    port.close()


def _search(node, index, body, host):
    if host:
        os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        return node.search(index, copy.deepcopy(body))
    finally:
        if host:
            del os.environ["ESTPU_DISABLE_MESH"]


_REF_CACHE = {}


def _ref(ref, index, body):
    """The reference's host loop (its oracle; module docstring)."""
    key = (index, json.dumps(body, sort_keys=True))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _search(ref, index, body, True)
    return _REF_CACHE[key]


def _hold(got, want, what):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"], what
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh], what
    np.testing.assert_allclose([h["_score"] for h in gh],
                               [h["_score"] for h in wh], rtol=1e-5,
                               err_msg=what)
    for g, w in zip(gh, wh):
        for key in ("_source", "matched_queries"):
            assert g.get(key) == w.get(key), (what, key, g["_id"])


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def _check(nodes, index, body, what="", mesh_serves=None):
    """The port's routes against the reference's host loop and each
    other; ``mesh_serves`` asserts whether the mesh took the body."""
    ref, port = nodes
    want = _ref(ref, index, body)
    kernels.reset()
    mesh = _search(port, index, body, False)
    snap = kernels.snapshot()
    host = _search(port, index, body, True)
    _hold(mesh, want, f"{what} {index} mesh")
    _hold(host, want, f"{what} {index} host")
    assert _strip(mesh) == _strip(host), f"{what} {index}: routes differ"
    if mesh_serves is not None:
        assert bool(snap.get("mesh_search")) == mesh_serves, (what, snap)
        assert bool(snap.get("mesh_fallback_total")) != mesh_serves, \
            (what, snap)
    return want


MATCH = {"match": {"body": "fox river quick"}}
GAUSS_TS = {"gauss": {"ts": {"origin": "2015-02-15", "scale": "5d",
                             "offset": "1d", "decay": 0.5}}}

#: name -> (function_score body, served by the mesh)
FUNCTIONS = {
    "weight": ({"query": MATCH, "weight": 2.5}, True),
    "fvf_none": ({"query": MATCH, "field_value_factor": {
        "field": "price", "missing": 1}}, True),
    "fvf_long_factor": ({"query": MATCH, "field_value_factor": {
        "field": "n", "factor": 1e-9, "missing": 0.5}}, True),
    "script_score": ({"query": MATCH, "script_score": {"script": {
        "inline": "Math.log10(doc['price'].value + 2) * params.k",
        "params": {"k": 1.5}}}}, False),
    "script_score_score": ({"query": MATCH, "script_score": {
        "script": "_score * 2 + doc['tag'].value"},
        "boost_mode": "replace"}, False),
    "random": ({"random_score": {"seed": 7}, "boost_mode": "replace"}, True),
    "random_match": ({"query": MATCH, "random_score": {"seed": 123},
                      "boost_mode": "sum"}, True),
    "gauss_price": ({"query": MATCH, "gauss": {"price": {
        "origin": 50, "scale": 20}}}, True),
    "exp_price": ({"query": MATCH, "exp": {"price": {
        "origin": 30, "scale": 10, "offset": 5, "decay": 0.3}}}, True),
    "linear_price": ({"query": MATCH, "linear": {"price": {
        "origin": 70, "scale": 25}}, "boost_mode": "replace"}, True),
    "gauss_ts": (dict(GAUSS_TS, query=MATCH), True),
    "exp_ts": ({"exp": {"ts": {"origin": 1_424_000_000_000, "scale": "10d"}},
                "boost_mode": "replace"}, True),
    "linear_ts": ({"query": MATCH, "linear": {"ts": {
        "origin": "2015-03-01", "scale": "20d", "decay": 0.2}}}, True),
    "decay_now": ({"query": MATCH, "gauss": {"ts": {
        "origin": "now", "scale": "5d"}}}, False),
    "max_boost": ({"query": MATCH, "field_value_factor": {
        "field": "price", "modifier": "sqrt", "missing": 1},
        "max_boost": 4.0}, True),
    "min_score": ({"query": MATCH, "field_value_factor": {
        "field": "price", "missing": 0}, "min_score": 30.0}, True),
    "boost": ({"query": MATCH, "weight": 3, "boost": 0.5}, True),
    "no_functions": ({"query": MATCH, "boost": 2.0}, True),
    "bare": ({"functions": [{"filter": {"term": {"tag": "t2"}},
                             "weight": 4}]}, True),
}
MODIFIERS = ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
             "square", "sqrt", "reciprocal")


@pytest.mark.parametrize("index", sorted(INDICES))
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_types(nodes, index, name):
    body, serves = FUNCTIONS[name]
    _check(nodes, index, {"query": {"function_score": body}, "size": 12},
           name, mesh_serves=serves)


@pytest.mark.parametrize("index", sorted(INDICES))
@pytest.mark.parametrize("modifier", MODIFIERS)
def test_field_value_factor_modifiers(nodes, index, modifier):
    body = {"query": {"function_score": {
        "query": MATCH, "field_value_factor": {
            "field": "price", "factor": 1.3, "modifier": modifier,
            "missing": 2}}}, "size": 12}
    _check(nodes, index, body, modifier, mesh_serves=True)


SCORE_MODES = ("multiply", "sum", "avg", "first", "max", "min")
BOOST_MODES = ("multiply", "replace", "sum", "avg", "max", "min")


@pytest.mark.parametrize("boost_mode", BOOST_MODES)
@pytest.mark.parametrize("score_mode", SCORE_MODES)
def test_score_mode_boost_mode_grid(nodes, score_mode, boost_mode):
    body = {"query": {"function_score": {
        "query": MATCH,
        "functions": [
            {"filter": {"term": {"tag": "t1"}}, "weight": 3},
            {"field_value_factor": {"field": "price", "modifier": "log1p",
                                    "missing": 1}, "weight": 0.5},
            {"filter": {"range": {"price": {"gte": 40}}},
             "gauss": {"ts": {"origin": "2015-02-01", "scale": "10d"}}},
            {"filter": {"term": {"tag": "t4"}}, "random_score": {"seed": 5}},
        ],
        "score_mode": score_mode, "boost_mode": boost_mode}}, "size": 15}
    for index in sorted(INDICES):
        _check(nodes, index, body, f"{score_mode}/{boost_mode}",
               mesh_serves=True)


def test_filtered_function_sum(nodes):
    """The reference's regression: a doc no function matches keeps the
    neutral factor 1 (here through ``replace``)."""
    body = {"query": {"function_score": {
        "query": MATCH,
        "functions": [{"filter": {"range": {"price": {"gte": 60}}},
                       "weight": 10}],
        "score_mode": "sum", "boost_mode": "replace"}}, "size": 300}
    want = _check(nodes, "two", body, "filtered sum", mesh_serves=True)
    scores = {h["_score"] for h in want["hits"]["hits"]}
    assert scores == {1.0, 10.0}


def test_named_queries(nodes):
    """``_name`` on the function_score, on its inner query and on a
    function's filter. The reference's ``collect_named`` does not look
    into a function's filter (its parse keeps the name, its fetch drops
    it); ES 2.0 reports every named query, and so does the port."""
    body = {"query": {"function_score": {
        "query": {"match": {"body": {"query": "fox river", "_name": "m"}}},
        "functions": [{"filter": {"term": {"tag": {"value": "t1",
                                                   "_name": "f"}}},
                       "weight": 2}],
        "_name": "fs"}}, "size": 20}
    ref, port = nodes
    want = _ref(ref, "two", body)
    for host in (False, True):
        got = _search(port, "two", body, host)
        assert [h["_id"] for h in got["hits"]["hits"]] == \
            [h["_id"] for h in want["hits"]["hits"]]
        for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
            extra = ["f"] if g["_source"]["tag"] == "t1" else []
            assert g["matched_queries"] == w["matched_queries"] + extra
            assert "f" not in w["matched_queries"]
    assert any("f" in h["matched_queries"] for h in got["hits"]["hits"])


def test_random_score_across_merged_segments(nodes):
    """random_score hashes a doc's slot in its segment: a force merge
    moves docs, and both packages move them alike."""
    ref, port = nodes
    for node in (ref, port):
        _load(node, "merged", 2, _docs(0, 240))
        node.indices["merged"].force_merge(1)
    body = {"query": {"function_score": {"query": MATCH,
                                         "random_score": {"seed": 42},
                                         "boost_mode": "replace"}},
            "size": 25}
    _check(nodes, "merged", body, "random merged", mesh_serves=True)


def test_field_value_factor_without_missing(nodes):
    """Over a segment without the column the reference's host loop
    raises; the port's mesh declines such a round and its host loop
    raises the same typed error. With every segment holding the column
    the mesh serves it."""
    ref, port = nodes
    body = {"query": {"function_score": {"query": MATCH,
                                         "field_value_factor": {
                                             "field": "price"}}}}
    with pytest.raises(Exception, match="no doc values and no"):
        _search(ref, "sparse", body, True)
    for host in (False, True):
        kernels.reset()
        with pytest.raises(QueryParsingException,
                           match="no doc values and no"):
            _search(port, "sparse", body, host)
        if not host:
            assert kernels.snapshot().get("mesh_fallback_total") == 1
    _check(nodes, "two", dict(body, size=12), "fvf no missing",
           mesh_serves=True)
    _check(nodes, "sparse", {"query": {"function_score": {
        "query": MATCH, "field_value_factor": {"field": "price",
                                               "missing": 3}}}},
           "fvf sparse missing", mesh_serves=True)
    _check(nodes, "sparse", {"query": {"function_score": dict(
        GAUSS_TS, query=MATCH)}}, "decay sparse", mesh_serves=True)


def test_reference_unit_bodies(nodes):
    """The bodies of the reference's ``test_queries.py`` (function_score
    field_value_factor, script_score, the script query, a gauss decay)
    and ``test_mesh_product_path.py`` (weight, fvf, decay, random)."""
    bodies = {
        "fvf_log1p": ({"function_score": {
            "query": {"match": {"body": "quick"}},
            "field_value_factor": {"field": "price", "modifier": "log1p",
                                   "factor": 1.0},
            "boost_mode": "replace"}}, False),
        "script_score": ({"function_score": {
            "query": {"match_all": {}},
            "script_score": {"script": "doc['price'].value * 2 + 1"},
            "boost_mode": "replace"}}, False),
        "script_query": ({"script": {"script": "doc['price'].value > 60"}},
                         False),
        "decay_gauss": ({"function_score": {
            "functions": [{"gauss": {"price": {"origin": 0,
                                               "scale": 100}}}],
            "boost_mode": "replace"}}, True),
        "fs_weight": ({"function_score": {
            "query": {"match": {"body": "fox"}},
            "functions": [{"weight": 2.5,
                           "filter": {"term": {"tag": "t3"}}}]}}, True),
        "fs_fvf": ({"function_score": {
            "query": {"match": {"body": "dog"}},
            "field_value_factor": {"field": "n", "modifier": "log1p",
                                   "missing": 1.0}}}, True),
        "fs_decay": ({"function_score": {
            "query": {"match": {"body": "fox"}},
            "gauss": {"price": {"origin": 25, "scale": 10}},
            "boost_mode": "multiply"}}, True),
        "fs_random": ({"function_score": {
            "query": {"match": {"body": "river"}},
            "random_score": {"seed": 7}, "boost_mode": "replace"}}, True),
    }
    for name, (q, serves) in bodies.items():
        # fvf_log1p reads a column missing from some docs without
        # ``missing``: every segment holds the column, so the mesh serves
        # it (the reference's mesh too)
        served = True if name == "fvf_log1p" else serves
        for index in sorted(INDICES):
            _check(nodes, index, {"query": q, "size": 10}, name,
                   mesh_serves=served)


SCRIPT_QUERIES = {
    "gt": {"script": {"script": "doc['price'].value > 50"}},
    "params": {"script": {"script": {
        "inline": "doc['n'].value > params.cut && !doc['n'].empty",
        "params": {"cut": 200_000_000}}}},
    "ternary": {"script": {"script": "doc['price'].value > 50 ? 1 : 0"}},
    "date": {"script": {"script": {
        "inline": "doc['ts'].value < params.t",
        "params": {"t": float(TS_BASE + 30 * 86_400_000)}}}},
    "length": {"script": {"script": "doc['body'].value > 8"}},
    "constant": {"script": {"script": "1 > 0"}},
    "in_bool": {"bool": {"must": [MATCH], "filter": [
        {"script": {"script": "doc['price'].value * 2 < 120"}}]}},
}


@pytest.mark.parametrize("index", sorted(INDICES))
@pytest.mark.parametrize("name", sorted(SCRIPT_QUERIES))
def test_script_query(nodes, index, name):
    _check(nodes, index, {"query": SCRIPT_QUERIES[name], "size": 15}, name,
           mesh_serves=False)


def test_int_param_past_int32(nodes):
    """The reference runs with JAX's 64-bit types off, so a Python int
    parameter past int32 cannot enter its arithmetic and the script
    fails; the port compares it as the f32 it meets. A float parameter
    gives both the same answer (``test_script_query[date-*]``)."""
    ref, port = nodes
    body = {"query": {"script": {"script": {
        "inline": "doc['ts'].value < params.t",
        "params": {"t": TS_BASE + 30 * 86_400_000}}}}}
    with pytest.raises(Exception, match="overflow"):
        _search(ref, "one", body, True)
    want = _ref(ref, "one", {"query": {"script": {"script": dict(
        body["query"]["script"]["script"],
        params={"t": float(TS_BASE + 30 * 86_400_000)})}}})
    for host in (False, True):
        _hold(_search(port, "one", body, host), want, "int param")


def test_stored_script_by_id(nodes):
    from elasticsearch_tpu.search import scripting as ref_scripting
    from elasticsearch_tpu_torch.search import scripting

    src = "doc['price'].value * params.f"
    for mod in (ref_scripting, scripting):
        mod.store_script("painless", "torch-fs-stored", src)
    body = {"query": {"function_score": {"query": MATCH, "script_score": {
        "script": {"id": "torch-fs-stored", "params": {"f": 0.1}}}}}}
    _check(nodes, "two", body, "stored", mesh_serves=False)


def test_reference_mesh_and_host_differ_on_a_date_decay(nodes):
    """ROADMAP C: the reference's mesh takes a date's f32 as
    ``exact.astype(f32)``, its host loop as ``f32(exact - offset) +
    f32(offset)`` (a step of 131,072 ms near 1.4e12), so a gauss on a
    date scores some docs differently on its two routes. The port's
    routes both take the host loop's value."""
    ref, port = nodes
    # a 20-day scale keeps every doc's value far above the subnormals
    # (XLA flushes them, torch keeps them)
    body = {"query": {"function_score": {
        "query": MATCH, "boost_mode": "replace",
        "gauss": {"ts": {"origin": "2015-02-15", "scale": "20d",
                         "offset": "1d"}}}}, "size": 200}
    host = _ref(ref, "two", body)
    mesh = _search(ref, "two", body, False)
    hs = {h["_id"]: h["_score"] for h in host["hits"]["hits"]}
    ms = {h["_id"]: h["_score"] for h in mesh["hits"]["hits"]}
    assert hs.keys() == ms.keys()
    worst = max(abs(ms[k] - hs[k]) / max(hs[k], 1e-30) for k in hs)
    assert worst > 1e-5, worst
    _check(nodes, "two", body, "date decay", mesh_serves=True)


def test_origin_default_is_the_segment_max(nodes):
    """ROADMAP C: with no origin (or ``now``) a date decay centres on
    the greatest value of each segment, so the same docs split into other
    segments score otherwise. The port keeps the reference's rule; both
    go to the host loop."""
    ref, port = nodes
    body = {"query": {"function_score": {
        "query": MATCH, "exp": {"ts": {"scale": "4d"}},
        "boost_mode": "replace"}}, "size": 40}
    want = _check(nodes, "one", body, "origin default", mesh_serves=False)
    for node in (ref, port):
        _load(node, "one_merged", 1, _docs(0, 240))
        node.indices["one_merged"].force_merge(1)
    merged = _check(nodes, "one_merged", body, "origin default merged",
                    mesh_serves=False)
    a = {h["_id"]: h["_score"] for h in want["hits"]["hits"]}
    b = {h["_id"]: h["_score"] for h in merged["hits"]["hits"]}
    assert any(abs(a[k] - b[k]) > 1e-3 for k in a.keys() & b.keys())


def test_highlight_under_function_score(nodes):
    body = {"query": {"function_score": {"query": MATCH, "weight": 2}},
            "highlight": {"fields": {"body": {}}}, "size": 5}
    ref, port = nodes
    want = _ref(ref, "one", body)
    for host in (False, True):
        got = _search(port, "one", body, host)
        assert [h.get("highlight") for h in got["hits"]["hits"]] == \
            [h.get("highlight") for h in want["hits"]["hits"]]
    assert want["hits"]["hits"][0]["highlight"]


def test_col_prim_views_at_one_slot_and_cached_copies_above():
    """ColPrim at S = 1 passes the segment's own f32 channel and exists
    (equal data_ptr), charging nothing; at S > 1 its stacked copies share
    RangePrim's keys, are charged to ``fielddata`` and reused by the next
    round; a repeated body hits the prepared-query memo; the function's
    parameters are part of that key (another seed misses it)."""
    from elasticsearch_tpu_torch.parallel import executor as port_executor

    node = Node(name="col", device="cpu")
    try:
        for name, shards in (("s1", 1), ("s3", 3)):
            _load(node, name, shards, _docs(0, 120), every=120)
        body = {"query": {"function_score": {
            "query": MATCH, "functions": [
                {"field_value_factor": {"field": "price", "missing": 1}},
                {"gauss": {"ts": {"origin": "2015-02-01",
                                  "scale": "9d"}}},
                {"random_score": {"seed": 3},
                 "filter": {"range": {"price": {"gte": 20}}}}]}}}
        svc = node.indices["s1"]
        seg = svc.shards[0].segments[0]
        _search(node, "s1", body, False)
        ex = svc.mesh_executor()
        ptrs = set()
        for rd in ex._prep.values():
            env = port_executor._Env(rd.items)
            for i in range(len(rd.items)):
                ptrs |= {t.data_ptr() for t in env[i]
                         if isinstance(t, torch.Tensor)}
        for col in ("price", "ts"):
            for t in (seg.numerics[col].values, seg.numerics[col].exists):
                assert t.data_ptr() in ptrs, col
        assert ex.data_bytes() == 0

        ex3 = node.indices["s3"].mesh_executor()
        fd = node.breakers.breaker("fielddata")
        kernels.reset()
        first = _search(node, "s3", body, False)
        assert kernels.snapshot().get("executor_data_miss")
        assert ex3.data_bytes() > 0
        assert any(key[0] in ("colf32", "colexists") for key in ex3._data)
        kernels.reset()
        again = _search(node, "s3", body, False)
        snap = kernels.snapshot()
        assert snap.get("executor_prep_hit") == 1, snap
        assert not snap.get("executor_data_miss"), snap
        assert _strip(again) == _strip(first)
        kernels.reset()
        other = copy.deepcopy(body)
        other["query"]["function_score"]["functions"][2][
            "random_score"]["seed"] = 4
        _search(node, "s3", other, False)
        assert kernels.snapshot().get("executor_prep_miss"), \
            kernels.snapshot()
        assert fd.used > 0
    finally:
        node.close()
    assert node.breakers.breaker("fielddata").used == 0
